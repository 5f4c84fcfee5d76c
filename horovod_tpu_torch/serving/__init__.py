"""Paged-KV serving of the flagship TransformerLM in PyTorch, the
counterpart of ``horovod_tpu.serving``:

- :mod:`~horovod_tpu_torch.serving.kv_cache`: the page pool, the
  refcounted allocator (publishing ``hvd_serve_pages_*``), block tables,
  the shared-prefix index with copy-on-write, and the paged-attention
  reference and dispatch;
- :mod:`~horovod_tpu_torch.serving.engine`: the prefill/decode engine,
  the speculative verify and truncated-layer draft steps, and
  ``load_for_serving``, the train-to-serve handoff;
- :mod:`~horovod_tpu_torch.serving.scheduler`: continuous batching,
  accept-prefix speculative decode, the host-side n-gram drafter and the
  ``hvd_serve_*`` metrics;
- :mod:`~horovod_tpu_torch.serving.fleet` and
  :mod:`~horovod_tpu_torch.serving.router`: N replicas behind one
  occupancy and prefix-affinity router on the elastic member registry,
  with a queue-depth autoscaler, drain-safe scale-down and deterministic
  re-admission after a replica's death (``hvd_fleet_*``).

:func:`serving_stats` is the ``serving`` block of ``/healthz``
(``metrics.health_snapshot``) and :func:`fleet_stats` its ``fleet``
block."""

from typing import Any, Dict, Optional

from horovod_tpu_torch.serving.engine import (ServeEngine, active_engine,
                                              load_for_serving,
                                              prefill_buckets)
from horovod_tpu_torch.serving.kv_cache import (BlockTables, PageAllocator,
                                                PagePool, PrefixIndex,
                                                copy_page,
                                                paged_attention_reference,
                                                paged_decode_attention)
from horovod_tpu_torch.serving.scheduler import (NGramDrafter, Request,
                                                 ServeScheduler,
                                                 active_scheduler)
from horovod_tpu_torch.serving.fleet import (EngineReplica, ReplicaState,
                                             ServingFleet, active_fleet,
                                             fleet_stats)
from horovod_tpu_torch.serving.router import FleetRouter, FleetUnavailable


def serving_stats() -> Optional[Dict[str, Any]]:
    """Live serving summary: ``{"engine": ..., "scheduler": ...}`` of the
    most recently built engine and scheduler, or None when no engine was
    built in this process."""
    engine = active_engine()
    if engine is None:
        return None
    out: Dict[str, Any] = {"engine": engine.stats()}
    sched = active_scheduler()
    if sched is not None:
        out["scheduler"] = sched.stats()
    return out


def reset_for_tests() -> None:
    from horovod_tpu_torch.serving import engine as _engine
    from horovod_tpu_torch.serving import fleet as _fleet
    from horovod_tpu_torch.serving import scheduler as _scheduler
    _engine.reset_for_tests()
    _scheduler.reset_for_tests()
    _fleet.reset_for_tests()


__all__ = ["BlockTables", "EngineReplica", "FleetRouter", "FleetUnavailable",
           "NGramDrafter", "PageAllocator", "PagePool", "PrefixIndex",
           "ReplicaState", "Request", "ServeEngine", "ServeScheduler",
           "ServingFleet", "active_engine", "active_fleet",
           "active_scheduler", "copy_page", "fleet_stats",
           "load_for_serving", "paged_attention_reference",
           "paged_decode_attention", "prefill_buckets", "reset_for_tests",
           "serving_stats"]
