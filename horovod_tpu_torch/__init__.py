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
  (``tracing``) and straggler detection;
- Horovod's PyTorch API (``eager``): ``allreduce`` and the other
  collectives with their ``*_async`` forms, ``synchronize`` and ``poll``,
  ``join`` for uneven epochs, Adasum (``op=Adasum``,
  ``DistributedAdasumOptimizer``), ``SyncBatchNorm``,
  ``broadcast_optimizer_state``, ``broadcast_object``,
  ``allgather_object`` and the callbacks;
- Horovod's launcher and elastic training: ``hvdrun-torch``
  (``runner.launch``: one process per card, ``--auto-resume`` on exit
  code 75, multi-host over SSH, ``--virtual`` gloo worlds), the
  generation-respawn elastic launcher (``runner.elastic_run``),
  ``run(fn, np=N)``, and ``elastic`` (``TorchState``, ``ElasticSampler``,
  ``elastic.run``, the driver and the live ``ResizeCoordinator``).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, which takes the kernels' plain PyTorch versions.
Importing the package builds nothing.
"""

from horovod_tpu_torch import goodput, resilience, tracing  # noqa: F401
from horovod_tpu_torch.callbacks import (
    BestModelCheckpoint, BroadcastGlobalVariablesCallback, Callback,
    CallbackList, CheckpointCallback, LearningRateScheduleCallback,
    LearningRateWarmupCallback, MetricAverageCallback, MetricsCallback,
    StepStats, scaled_lr, warmup_schedule)
from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                          restore_checkpoint,
                                          save_checkpoint)
from horovod_tpu_torch.eager import (
    Handle, allgather, allgather_async, allreduce, allreduce_async,
    alltoall, alltoall_async, barrier, broadcast, broadcast_async,
    grouped_allreduce, grouped_allreduce_async, join, poll, reducescatter,
    reducescatter_async, synchronize)
from horovod_tpu_torch.functions import (allgather_object, broadcast_object,
                                         broadcast_optimizer_state,
                                         broadcast_parameters)
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
from horovod_tpu_torch.ops.collectives import (hierarchical_allreduce,
                                               ppermute, torus_allreduce,
                                               two_level_allreduce)
from horovod_tpu_torch.ops.reduce_ops import (Adasum, Average, Max, Min,
                                              Product, ReduceOp, Sum)
from horovod_tpu_torch.ops.sparse import sparse_allreduce
from horovod_tpu_torch.parallel.distributed import (
    Compression, DistributedAdasumOptimizer, DistributedApply,
    DistributedOptimizer, EpilogueAdam, EpilogueSGD, allreduce_gradients,
    distributed_apply, distributed_value_and_grad)
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
from horovod_tpu_torch.runner.interactive import run
from horovod_tpu_torch.serving import (Request, ServeEngine,
                                       ServeScheduler)
from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm

from horovod_tpu_torch.version import __version__  # noqa: E402

__all__ = ["Adasum", "AsyncCheckpointer", "Average", "BestModelCheckpoint",
           "BroadcastGlobalVariablesCallback", "Callback",
           "CallbackList", "CheckpointCallback",
           "CheckpointManager", "Compression",
           "DistributedAdasumOptimizer", "DistributedApply",
           "DistributedOptimizer", "EpilogueAdam", "EpilogueSGD",
           "Handle", "LearningRateScheduleCallback",
           "LearningRateWarmupCallback", "Max",
           "MetricAverageCallback", "MetricsCallback", "Min",
           "PreemptionHandler", "ProcessSet", "Product",
           "RESUMABLE_EXIT_CODE", "ReduceOp", "Request", "ResNet",
           "ResNet101", "ResNet152", "ResNet18", "ResNet34",
           "ResNet50", "ServeEngine", "ServeScheduler", "StepStats",
           "Sum", "SyncBatchNorm", "TrainState",
           "TransformerConfig", "TransformerLM", "add_process_set",
           "allgather", "allgather_async", "allgather_object",
           "allreduce", "allreduce_async", "allreduce_gradients",
           "alltoall", "alltoall_async", "barrier", "broadcast",
           "broadcast_async", "broadcast_object",
           "broadcast_optimizer_state", "broadcast_parameters",
           "cross_rank", "cross_size", "data_parallel_train_step",
           "distributed_apply", "distributed_value_and_grad",
           "get_process_set_by_id", "global_process_set", "goodput",
           "goodput_report", "grouped_allreduce",
           "grouped_allreduce_async", "hierarchical_allreduce",
           "init", "init_params", "is_homogeneous",
           "is_initialized", "join", "local_rank", "local_size",
           "make_transformer_train_step",
           "make_transformer_train_step_fused", "mesh",
           "metrics_snapshot", "params_from_numpy", "poll",
           "ppermute", "process_set_ids", "rank", "reducescatter",
           "reducescatter_async", "remove_process_set",
           "resilience", "restore_checkpoint", "run", "save_checkpoint",
           "scaled_lr", "shutdown", "size", "sparse_allreduce",
           "synchronize", "torus_allreduce", "tracing",
           "train_loop", "two_level_allreduce",
           "variables_from_numpy", "variables_to_numpy",
           "warmup_schedule"]
