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
  probe;
- Horovod's topology and collectives (``runtime.topology``,
  ``parallel.process_sets``, ``ops.collectives``, ``ops.sparse``): the
  named mesh (``hvd``, ``hvd_cross``, ``hvd_local``, ``hvd_dcn``) and
  process sets on NCCL groups; allgather, alltoall, reducescatter and
  ppermute with their uneven forms; the hierarchical (torus) and
  two-level allreduce, and the two-level tier of the gradient sync;
- Horovod's resilient training loop (``train_loop``): crash-safe async
  checkpoints of the live training state (``resilience``:
  ``AsyncCheckpointer``, ``CheckpointManager``), preemption quiesce with
  the resumable exit code 75, chaos drills and retry policies over the
  c10d store, step stats, goodput phases (``goodput``), spans
  (``tracing``) and straggler detection.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, which takes the kernels' plain PyTorch versions.
Importing the package builds nothing.
"""

from horovod_tpu_torch import goodput, resilience, tracing  # noqa: F401
from horovod_tpu_torch.callbacks import CheckpointCallback, StepStats
from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                          restore_checkpoint,
                                          save_checkpoint)
from horovod_tpu_torch.functions import broadcast_parameters
from horovod_tpu_torch.goodput import goodput_report
from horovod_tpu_torch.metrics import metrics_snapshot
from horovod_tpu_torch.resilience import (RESUMABLE_EXIT_CODE,
                                          AsyncCheckpointer,
                                          PreemptionHandler)
from horovod_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101, ResNet152,
                                             variables_from_numpy,
                                             variables_to_numpy)
from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM,
                                                  init_params,
                                                  params_from_numpy)
from horovod_tpu_torch.ops.collectives import (
    allgather, allreduce, alltoall, barrier, broadcast, grouped_allreduce,
    hierarchical_allreduce, ppermute, reducescatter, torus_allreduce,
    two_level_allreduce)
from horovod_tpu_torch.ops.reduce_ops import (Adasum, Average, Max, Min,
                                              Product, ReduceOp, Sum)
from horovod_tpu_torch.ops.sparse import sparse_allreduce
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
from horovod_tpu_torch.parallel.process_sets import (
    ProcessSet, add_process_set, get_process_set_by_id, global_process_set,
    process_set_ids, remove_process_set)
from horovod_tpu_torch.runtime.context import (cross_rank, cross_size, init,
                                               is_homogeneous,
                                               is_initialized, local_rank,
                                               local_size, mesh, rank,
                                               shutdown, size)
from horovod_tpu_torch.serving import (Request, ServeEngine,
                                       ServeScheduler)

__version__ = "0.3.0"

__all__ = ["Adasum", "AsyncCheckpointer", "Average", "CheckpointCallback",
           "CheckpointManager", "Compression", "DistributedApply",
           "DistributedOptimizer", "EpilogueAdam", "EpilogueSGD", "Max",
           "Min", "PreemptionHandler", "ProcessSet", "Product",
           "RESUMABLE_EXIT_CODE", "ReduceOp", "Request", "ResNet",
           "ResNet101", "ResNet152", "ResNet18", "ResNet34", "ResNet50",
           "ServeEngine", "ServeScheduler", "StepStats", "Sum",
           "TrainState",
           "TransformerConfig", "TransformerLM", "add_process_set",
           "allgather", "allreduce", "allreduce_gradients", "alltoall",
           "barrier", "broadcast", "broadcast_parameters", "cross_rank",
           "cross_size", "data_parallel_train_step", "distributed_apply",
           "get_process_set_by_id", "global_process_set", "goodput",
           "goodput_report",
           "grouped_allreduce", "hierarchical_allreduce", "init",
           "init_params", "is_homogeneous", "is_initialized", "local_rank",
           "local_size", "make_transformer_train_step",
           "make_transformer_train_step_fused", "mesh", "metrics_snapshot",
           "params_from_numpy", "ppermute", "process_set_ids", "rank",
           "reducescatter", "remove_process_set", "resilience",
           "restore_checkpoint", "save_checkpoint", "shutdown", "size",
           "sparse_allreduce", "torus_allreduce", "tracing", "train_loop",
           "two_level_allreduce",
           "variables_from_numpy", "variables_to_numpy"]
