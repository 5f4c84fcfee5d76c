"""Elastic (fault-tolerant, resizable) training on the port.

The counterpart of ``horovod_tpu/elastic/``, with its module and public
names; ``TorchState`` takes the place of ``TpuState`` (reference
Horovod's torch API gives it its name and arguments).

- worker side: ``State``/``ObjectState``/``TorchState`` with
  commit/restore/sync + the ``elastic.run`` wrapper
  (ref horovod/common/elastic.py:26-175, torch/elastic/state.py),
  ``ElasticSampler`` (ref torch/elastic/sampler.py:26);
- driver side: ``ElasticDriver`` + host discovery with blacklist/cooldown
  + worker notification (ref horovod/runner/elastic/{driver,discovery,
  registration,worker}.py); the generation launcher is
  ``runner/elastic_run.py``;
- live resize (``resize``): a lost host's ranks leave and the survivors
  re-form an NCCL world in process.

A reset under the launcher is a respawn: a worker that sees a topology
change or an internal error commits and exits 73, and the launcher
starts the next generation with a fresh ``MASTER_PORT``; each worker
restores the committed ``TorchState`` and the sampler continues the epoch
on the unprocessed indices.
"""

from horovod_tpu_torch.elastic.exceptions import (  # noqa: F401
    HorovodInternalError,
    HostsUpdatedInterrupt,
    PreemptionInterrupt,
    ResizeInterrupt,
    WorkersAvailableException,
)
from horovod_tpu_torch.elastic.state import (  # noqa: F401
    ObjectState,
    State,
    TorchState,
    run,
)
from horovod_tpu_torch.elastic.sampler import ElasticSampler  # noqa: F401
from horovod_tpu_torch.elastic.discovery import (  # noqa: F401
    FixedHosts,
    HostDiscovery,
    HostDiscoveryScript,
    HostManager,
)
from horovod_tpu_torch.elastic.driver import (  # noqa: F401
    ElasticDriver,
    SlotInfo,
)
from horovod_tpu_torch.elastic.registry import MemberRegistry  # noqa: F401
from horovod_tpu_torch.elastic.resize import (  # noqa: F401
    LEFT,
    ResizeAgreement,
    ResizeCoordinator,
    ResizePlan,
    ResizeableState,
    SamplerCarryover,
    adopt_plan_on_restore,
    commit_plan,
    load_plan,
    merge_sampler_states,
    register_resizeable,
    repartition_residual,
    reshard_wire_state,
    restore_resized,
    unregister_resizeable,
)
