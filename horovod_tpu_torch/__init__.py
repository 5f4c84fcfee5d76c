"""horovod_tpu_torch — the PyTorch and CUDA port of horovod_tpu for NVIDIA
Hopper GPUs.

A package of its own beside ``horovod_tpu`` (the JAX reference): it
imports torch and never jax, and every Pallas kernel on a ported path is a
CUDA kernel written by hand for ``sm_90a`` (``csrc/``), built from source
at its first launch. This slice serves the flagship TransformerLM through
a paged KV cache; see ``horovod_tpu_torch.serving``. Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``, which takes
the kernels' plain PyTorch versions.
"""

from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params,
                                                  params_from_numpy)
from horovod_tpu_torch.serving import (Request, ServeEngine,
                                       ServeScheduler)

__version__ = "0.1.0"

__all__ = ["Request", "ServeEngine", "ServeScheduler", "TransformerConfig",
           "init_params", "params_from_numpy"]
