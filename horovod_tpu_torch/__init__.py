"""horovod_tpu_torch — the PyTorch and CUDA port of horovod_tpu for NVIDIA
Hopper GPUs.

A package of its own beside ``horovod_tpu`` (the JAX reference): it
imports torch and never jax, and every Pallas kernel on a ported path is a
CUDA kernel written by hand for ``sm_90a`` (``csrc/``), built from source
at its first launch. Two paths are ported:

- serving the flagship TransformerLM through a paged KV cache
  (``horovod_tpu_torch.serving``, the paged-decode kernel);
- data-parallel training of the same model: ``init`` (NCCL on the card,
  gloo on the CPU), ``make_transformer_train_step`` and ``train_loop``
  (``horovod_tpu_torch.parallel.trainer``), with the flash-attention
  forward and backward kernels and a fused gradient allreduce.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, which takes the kernels' plain PyTorch versions.
Importing the package builds nothing.
"""

from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM,
                                                  init_params,
                                                  params_from_numpy)
from horovod_tpu_torch.ops.collectives import (allreduce, barrier,
                                               broadcast, grouped_allreduce)
from horovod_tpu_torch.ops.reduce_ops import (Average, Max, Min, Product,
                                              Sum)
from horovod_tpu_torch.parallel.trainer import (TrainState,
                                                make_transformer_train_step,
                                                train_loop)
from horovod_tpu_torch.runtime.context import (init, is_initialized,
                                               local_rank, local_size, rank,
                                               shutdown, size)
from horovod_tpu_torch.serving import (Request, ServeEngine,
                                       ServeScheduler)

__version__ = "0.2.0"

__all__ = ["Average", "Max", "Min", "Product", "Request", "ServeEngine",
           "ServeScheduler", "Sum", "TrainState", "TransformerConfig",
           "TransformerLM", "allreduce", "barrier", "broadcast",
           "grouped_allreduce", "init", "init_params", "is_initialized",
           "local_rank", "local_size", "make_transformer_train_step",
           "params_from_numpy", "rank", "shutdown", "size", "train_loop"]
