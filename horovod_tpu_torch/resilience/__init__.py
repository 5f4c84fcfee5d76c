"""Resilience of the port: async off-step-path checkpointing,
preemption-aware auto-resume, and a fault-injection harness that proves
recovery end to end. The counterpart of ``horovod_tpu/resilience/``.

- :mod:`~horovod_tpu_torch.resilience.async_checkpoint`:
  ``AsyncCheckpointer``, background snapshots of the live training state
  with crash-safe manifest commit (tmp dir + atomic rename, a c10d-store
  barrier across ranks), CheckFreq-style cadence
  (``HOROVOD_CKPT_INTERVAL=auto``), newest-k rotation after the commit,
  and ``hvd_checkpoint_*`` metrics;
- :mod:`~horovod_tpu_torch.resilience.preemption`: ``PreemptionHandler``,
  SIGTERM/SIGINT and a sentinel-file watcher, the stop step agreed over
  the c10d store, the resumable exit code 75;
- :mod:`~horovod_tpu_torch.resilience.chaos`: scripted fault injection
  driven from the real code paths (kill, commit delay/deny, fake
  preemption, KV brownouts, transient filesystem errors);
- :mod:`~horovod_tpu_torch.resilience.faults`: per-site retry policies,
  the ``RetryingKV`` wrapper, transient-fs retry of the commit path, and
  the ``healthy -> degraded -> draining`` fault domain.
"""

from horovod_tpu_torch.resilience import chaos  # noqa: F401
from horovod_tpu_torch.resilience import faults  # noqa: F401
from horovod_tpu_torch.resilience.faults import (  # noqa: F401
    FaultDomain,
    RetryBudgetExhausted,
    RetryPolicy,
    RetryingKV,
    fault_domain,
    policy_for,
    register_policy,
    retry_call,
    retry_fs,
    should_shed,
)
from horovod_tpu_torch.resilience.async_checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    CheckpointCadence,
    CheckpointCommitError,
    CheckpointMismatchError,
    CheckpointWriteError,
    host_snapshot,
    latest_committed_step,
    list_committed_steps,
    mesh_fingerprint,
    restore_latest,
    restore_step,
)
from horovod_tpu_torch.resilience.preemption import (  # noqa: F401
    RESUMABLE_EXIT_CODE,
    PreemptionHandler,
    active_handler,
)
