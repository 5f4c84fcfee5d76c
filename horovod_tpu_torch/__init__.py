"""horovod_tpu_torch — the PyTorch and CUDA port of horovod_tpu for NVIDIA
Hopper GPUs.

A package of its own beside ``horovod_tpu`` (the JAX reference): it
imports torch and never jax, and every Pallas kernel on a ported path is a
CUDA kernel written by hand for ``sm_90a`` (``csrc/``), built from source
at its first launch. These paths are ported:

- serving the flagship TransformerLM through a paged KV cache
  (``horovod_tpu_torch.serving``, the paged-decode kernel);
- data-parallel training of the same model: ``init`` (NCCL on the card,
  gloo on the CPU), ``make_transformer_train_step`` and ``train_loop``
  (``horovod_tpu_torch.parallel.trainer``), with the flash-attention
  forward and backward kernels and a fused gradient allreduce;
- data-parallel training of ResNet (``ResNet50(fused_conv_bn=True)``)
  through ``DistributedOptimizer`` and ``data_parallel_train_step``, with
  the fused 1x1-conv + batch-norm forward and backward kernels;
- Horovod's bucketed gradient sync: reverse-backward buckets launched
  from the gradient hooks, the wire codec with error feedback
  (``compression``), and the optimizer-in-epilogue fused step
  (``distributed_apply``, ``make_transformer_train_step_fused``);
- ``ops.stream_copy``, the stream-copy kernel of ``bench.py``'s bandwidth
  probe.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, which takes the kernels' plain PyTorch versions.
Importing the package builds nothing.
"""

from horovod_tpu_torch.functions import broadcast_parameters
from horovod_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101, ResNet152,
                                             variables_from_numpy,
                                             variables_to_numpy)
from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM,
                                                  init_params,
                                                  params_from_numpy)
from horovod_tpu_torch.ops.collectives import (allreduce, barrier,
                                               broadcast, grouped_allreduce)
from horovod_tpu_torch.ops.reduce_ops import (Average, Max, Min, Product,
                                              Sum)
from horovod_tpu_torch.parallel.distributed import (Compression,
                                                    DistributedApply,
                                                    DistributedOptimizer,
                                                    EpilogueAdam,
                                                    EpilogueSGD,
                                                    allreduce_gradients,
                                                    distributed_apply)
from horovod_tpu_torch.parallel.trainer import (
    TrainState, data_parallel_train_step, make_transformer_train_step,
    make_transformer_train_step_fused, train_loop)
from horovod_tpu_torch.runtime.context import (init, is_initialized,
                                               local_rank, local_size, rank,
                                               shutdown, size)
from horovod_tpu_torch.serving import (Request, ServeEngine,
                                       ServeScheduler)

__version__ = "0.3.0"

__all__ = ["Average", "Compression", "DistributedApply",
           "DistributedOptimizer", "EpilogueAdam", "EpilogueSGD", "Max",
           "Min", "Product", "Request", "ResNet", "ResNet101", "ResNet152",
           "ResNet18", "ResNet34", "ResNet50", "ServeEngine",
           "ServeScheduler", "Sum", "TrainState", "TransformerConfig",
           "TransformerLM", "allreduce", "allreduce_gradients", "barrier",
           "broadcast", "broadcast_parameters", "data_parallel_train_step",
           "distributed_apply", "grouped_allreduce", "init", "init_params",
           "is_initialized", "local_rank", "local_size",
           "make_transformer_train_step",
           "make_transformer_train_step_fused", "params_from_numpy", "rank",
           "shutdown", "size", "train_loop", "variables_from_numpy",
           "variables_to_numpy"]
