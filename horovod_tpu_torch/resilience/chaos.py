"""Fault-injection harness: prove recovery instead of assuming it.

The port's copy of ``horovod_tpu/resilience/chaos.py``: the whole spec
schema and every hook. A host index below is the rank of the default
process group (one process per card).

A ``ChaosSpec`` (env ``HOROVOD_CHAOS_SPEC`` JSON, or installed
programmatically) arms precise failures inside a real run:

- ``kill``: ``{"rank:step": signum_or_exitcode}`` — SIGKILL (9) or a
  hard ``os._exit`` at an exact training step on an exact rank (the
  "chip host dies mid-step" case);
- ``commit_delay``: ``{"step": seconds}`` — stall the checkpoint commit
  right before its atomic rename (slow/contended storage);
- ``commit_deny``: ``[step, ...]`` — abort the commit at the same point
  (torn write / full disk): the tmp dir is left UNCOMMITTED and
  restore-latest must skip it;
- ``preempt_at``: ``step`` — deliver a fake preemption notice through
  the installed PreemptionHandler (maintenance-event drill);
- ``kv_unavailable``: ``{"window": [t0, t1]}`` (seconds since arming —
  the KV *brownout*), ``{"p": 0.3, "seed": 7}`` (deterministic
  per-operation loss), or ``{"count": N}`` (first N operations fail) —
  KV operations raise ``UNAVAILABLE`` at the real
  ``utils.kvstore.DistributedKV`` call sites, underneath the
  ``RetryingKV`` layer, so what chaos exercises is the production retry
  + degraded-mode machinery;
- ``kv_slow``: ``{"delay": s[, "window": [t0, t1]]}`` — added latency
  on every KV operation (degraded-but-alive coordination service);
- ``net_partition``: ``{"hosts": [pidx, ...], "window": [t0, t1]}`` —
  KV blackout scoped to a host set (the "rack lost its DCN uplink"
  case; other hosts keep full service);
- ``fs_transient``: ``{"fail_first": N}`` or ``{"p": 0.2, "seed": 3}``
  — ``EIO`` at the checkpoint tmp-dir/rename filesystem points
  (``resilience.faults.retry_fs`` must absorb them); optional
  ``"scope": "checkpoint" | "store" | "all"`` (default checkpoint)
  selects which path class is drilled — the artifact store's
  read/write/rename points keep separate injection budgets;
- ``store_corrupt``: ``{"fail_first": N}`` or ``{"p": 0.2, "seed": 3}``
  — the artifact store treats the entry it is reading as corrupted
  (bit-rot drill): the load must log, count a miss, and fall back to
  a build — never crash (``horovod_tpu_torch/store/``);
- ``data_worker_kill``: ``{"worker": i, "after_batches": N}`` — the
  data-service worker ``i`` dies abruptly after serving N batch
  requests (sockets reset mid-epoch; consumers must reshard
  deterministically);
- ``replica_kill``: ``{"replica": i, "after_requests": N}`` — serving
  fleet replica ``i`` dies at the router dispatch that would be its
  N+1-th routed request (mid-decode, queued + in-flight work aboard):
  the fleet must re-admit its queued and in-flight-but-unacked
  requests on survivors deterministically, zero drops
  (``serving/fleet.py``);
- ``replica_slow``: ``{"replica": i, "delay": s, "after_requests": N}``
  — every router dispatch to replica ``i`` after its N-th observes an
  extra ``s``-second delay (the degraded-replica drill: placement must
  keep the fleet serving around the straggler);
- ``host_loss``: ``{"host": h, "at_step": s}`` — host ``h``'s chips
  vanish from the world at step ``s``: the ``ResizeCoordinator``
  (``elastic/resize.py``) observes the notice via ``resize_notice`` and
  must quiesce → shrink → continue in-process (the live-resize drill);
- ``slice_loss``: ``{"slice": k, "at_step": s}`` — a whole slice (a DCN group)
  dies: same notice path, but the shrink collapses/regrows the DCN mesh
  axis (``runtime/topology.py``) when the surviving world spans a
  single slice;
- ``host_return``: ``{"host": h, "at_step": s}`` — a previously-lost
  host comes back at step ``s`` (the grow-back drill: the resize back
  to the old world must be compile-free on a warm artifact store);
- ``clock_skew``: ``{"offset": seconds, "hosts": [pidx, ...]}`` —
  shifts this host's wall-clock trace anchors (trace merge / straggler
  timestamps), the NTP-drift drill;
- ``only_generation``: ``N`` (default 1) — injections fire only in the
  N-th incarnation (``HVD_ELASTIC_GENERATION`` / 1+``HVD_RESUME_ATTEMPT``),
  so the resumed run can prove it completes cleanly.

The hooks are called from the product code paths themselves
(``AsyncCheckpointer`` calls ``on_commit``; ``train_loop`` calls
``on_step``; ``DistributedKV`` calls ``on_kv``; the checkpoint
filesystem helpers call ``on_fs``), so what the chaos drills exercise is
the real recovery machinery, not a simulation of it. The serving fleet's
router calls ``on_replica_dispatch`` and ``replica_slow_s`` on its
dispatch path. The artifact store (``store/artifact_store.py``) calls
``on_fs`` at its ``store_read``/``store_write``/``store_rename`` points and
``on_store_load`` after each read. The data service's workers
(``data/compute_service.py``) call ``on_data_request`` per request.
``train_loop`` raises ``NotImplementedError`` when the armed spec holds
a fault of a subsystem the port does not have yet
(:func:`unported_faults`, now empty), so a drill is never skipped
silently. With no spec installed every hook is a no-op costing one
attribute read.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import time
from typing import Any, Dict, List, Optional, Tuple

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.resilience")


class ChaosDenied(RuntimeError):
    """A chaos spec denied this operation (e.g. a checkpoint commit)."""


class ChaosUnavailable(ConnectionError):
    """Injected transport failure; the message carries UNAVAILABLE so
    the production transient-error classification treats it exactly
    like a real coordination-service outage."""


def current_generation() -> int:
    """Which incarnation this process is: elastic generation when
    launched elastically, else 1 + the auto-resume attempt."""
    gen = os.environ.get("HVD_ELASTIC_GENERATION")
    if gen:
        return int(gen)
    return 1 + int(os.environ.get("HVD_RESUME_ATTEMPT", "0") or 0)


def _window(spec: Optional[Dict[str, Any]]) -> Optional[Tuple[float, float]]:
    if not spec or "window" not in spec:
        return None
    w = spec["window"]
    return (float(w[0]), float(w[1]))


def _det_fraction(seed: int, counter: int) -> float:
    """Deterministic [0,1) fraction for probabilistic injection — two
    runs of the same spec inject the same operations."""
    digest = hashlib.sha256(f"{seed}:{counter}".encode()).digest()
    return int.from_bytes(digest[:4], "big") / 0x100000000


def _should_fire(sub: Dict[str, Any], ops: int, failed: int) -> bool:
    """Shared ``fail_first``/``{p, seed}`` firing decision (window
    gating is the caller's, via ``spec._in_window``): one definition of
    the injection semantics for every path-class hook."""
    if "fail_first" in sub:
        return failed < int(sub["fail_first"])
    if "p" in sub:
        return _det_fraction(int(sub.get("seed", 0)), ops) \
            < float(sub["p"])
    return False


class ChaosSpec:
    def __init__(self, spec: Dict[str, Any]):
        self.kill = {str(k): int(v)
                     for k, v in (spec.get("kill") or {}).items()}
        self.commit_delay = {int(k): float(v)
                             for k, v in
                             (spec.get("commit_delay") or {}).items()}
        self.commit_deny = {int(s) for s in spec.get("commit_deny") or ()}
        self.preempt_at = spec.get("preempt_at")
        self.only_generation = int(spec.get("only_generation", 1))
        # -- matrix additions ------------------------------------------------
        self.kv_unavailable = spec.get("kv_unavailable") or None
        self.kv_slow = spec.get("kv_slow") or None
        self.net_partition = spec.get("net_partition") or None
        self.fs_transient = spec.get("fs_transient") or None
        self.data_worker_kill = spec.get("data_worker_kill") or None
        self.replica_kill = spec.get("replica_kill") or None
        self.replica_slow = spec.get("replica_slow") or None
        self.clock_skew = spec.get("clock_skew") or None
        self.store_corrupt = spec.get("store_corrupt") or None
        self.host_loss = spec.get("host_loss") or None
        self.slice_loss = spec.get("slice_loss") or None
        self.host_return = spec.get("host_return") or None
        # mutable injection state (counters are per-process, like the
        # faults they simulate)
        self._armed_at: Optional[float] = None
        self._kv_ops = 0
        self._kv_failed = 0
        self._fs_ops = 0
        self._fs_failed = 0
        self._store_ops = 0
        self._store_failed = 0
        self._store_fs_ops = 0
        self._store_fs_failed = 0
        self._resize_fired: set = set()

    @classmethod
    def from_env(cls) -> Optional["ChaosSpec"]:
        raw = knobs.get("HOROVOD_CHAOS_SPEC")
        if not raw:
            return None
        return cls(json.loads(raw))

    def armed(self) -> bool:
        return current_generation() == self.only_generation

    def _elapsed(self) -> float:
        """Seconds since the spec was first consulted while armed — the
        time base of every ``window`` clause."""
        if self._armed_at is None:
            self._armed_at = time.monotonic()
        return time.monotonic() - self._armed_at

    def _in_window(self, sub: Dict[str, Any]) -> bool:
        w = _window(sub)
        if w is None:
            return True
        t = self._elapsed()
        return w[0] <= t < w[1]


_spec: Optional[ChaosSpec] = None
_spec_loaded = False


def install(spec: Optional[Dict[str, Any]]) -> Optional[ChaosSpec]:
    """Install a spec programmatically (None clears). Tests/drills only."""
    global _spec, _spec_loaded
    _spec = ChaosSpec(spec) if spec is not None else None
    _spec_loaded = True
    return _spec


def active() -> Optional[ChaosSpec]:
    global _spec, _spec_loaded
    if not _spec_loaded:
        _spec = ChaosSpec.from_env()
        _spec_loaded = True
    return _spec if (_spec is not None and _spec.armed()) else None


# Faults whose subsystem the port does not have yet, with its ROADMAP item:
# none. host_loss, slice_loss and host_return reach the live resize through
# ResizeCoordinator.poll (elastic/resize.py); replica_kill and replica_slow
# the serving fleet's router (serving/router.py); store_corrupt and
# fs_transient with scope store the artifact store
# (store/artifact_store.py); data_worker_kill the data service's workers
# (data/compute_service.py, DataWorker._chaos_check).
_UNPORTED_FAULTS: Tuple[Tuple[str, str], ...] = ()


def unported_faults() -> List[Tuple[str, str]]:
    """``(fault, ROADMAP item)`` of every fault of the armed spec that
    targets a subsystem the port does not have yet (its hook has no
    caller, so the fault would never fire)."""
    spec = active()
    if spec is None or not spec.armed():
        return []
    return [(name, item) for name, item in _UNPORTED_FAULTS
            if getattr(spec, name)]


def _inject_metric(action: str) -> None:
    from horovod_tpu_torch import metrics as M
    M.counter("hvd_chaos_injections_total",
              "Faults injected by the chaos harness",
              labelnames=("action",)).labels(action=action).inc()


def _process_index(default: int = 0) -> int:
    try:
        from horovod_tpu_torch.utils import schedhooks
        return schedhooks.process_world()[0]
    except Exception:
        return default


# -- hooks (called by product code) -----------------------------------------

def on_step(step: int, rank: Optional[int] = None) -> None:
    """Training-step hook: kill this process or deliver a fake
    preemption notice when the spec says so."""
    spec = active()
    if spec is None:
        return
    if spec.preempt_at is not None and step >= int(spec.preempt_at):
        from horovod_tpu_torch.resilience import preemption
        h = preemption.active_handler()
        if h is not None and not h.requested:
            _inject_metric("preempt")
            logger.warning("chaos: delivering fake preemption notice at "
                           "step %d", step)
            h.request(f"chaos preempt_at={spec.preempt_at}",
                      source="sentinel")
    if rank is None:
        rank = _process_index()
    code = spec.kill.get(f"{rank}:{step}")
    if code is None:
        return
    _inject_metric("kill")
    logger.warning("chaos: killing rank %d at step %d (code %d)",
                   rank, step, code)
    if code == signal.SIGKILL:
        os.kill(os.getpid(), signal.SIGKILL)
    os._exit(code)


def on_commit(step: int) -> None:
    """Checkpoint-commit hook (AsyncCheckpointer, right before the
    atomic rename): delay or deny the commit."""
    spec = active()
    if spec is None:
        return
    delay = spec.commit_delay.get(step)
    if delay:
        _inject_metric("commit_delay")
        logger.warning("chaos: delaying commit of step %d by %.2fs",
                       step, delay)
        time.sleep(delay)
    if step in spec.commit_deny:
        _inject_metric("commit_deny")
        raise ChaosDenied(f"chaos: commit of step {step} denied")


def on_kv(op: str, key: str) -> None:
    """KV-transport hook (utils.kvstore.DistributedKV, every operation,
    BENEATH the RetryingKV layer): brownouts, injected latency, and
    host-scoped partitions."""
    spec = active()
    if spec is None:
        return
    slow = spec.kv_slow
    if slow and spec._in_window(slow):
        delay = float(slow.get("delay", 0.1))
        if delay > 0:
            _inject_metric("kv_slow")
            time.sleep(delay)
    part = spec.net_partition
    if part and spec._in_window(part):
        hosts = {int(h) for h in part.get("hosts", ())}
        if not hosts or _process_index() in hosts:
            _inject_metric("net_partition")
            raise ChaosUnavailable(
                f"UNAVAILABLE: chaos net_partition "
                f"(host {_process_index()}, {op} {key})")
    unavail = spec.kv_unavailable
    if not unavail:
        return
    spec._kv_ops += 1
    fire = False
    if "count" in unavail:
        fire = spec._kv_failed < int(unavail["count"])
    elif "p" in unavail:
        fire = _det_fraction(int(unavail.get("seed", 0)),
                             spec._kv_ops) < float(unavail["p"])
    else:
        fire = spec._in_window(unavail)
    if fire:
        spec._kv_failed += 1
        _inject_metric("kv_unavailable")
        raise ChaosUnavailable(
            f"UNAVAILABLE: chaos kv_unavailable ({op} {key})")


def on_fs(op: str, path: str) -> None:
    """Filesystem hook (checkpoint tmp-dir writes/atomic renames, and
    the artifact store's read/write/rename points — ops prefixed
    ``store_``): transient EIO that resilience.faults.retry_fs must
    absorb. ``fs_transient`` targets the CHECKPOINT path unless its
    ``scope`` says otherwise (``checkpoint`` (default) | ``store`` |
    ``all``), and each path class keeps its OWN op/failure counters —
    enabling the store must not consume a checkpoint drill's
    ``fail_first`` budget (or vice versa)."""
    spec = active()
    if spec is None or not spec.fs_transient:
        return
    sub = spec.fs_transient
    scope = str(sub.get("scope", "checkpoint"))
    is_store = op.startswith("store_")
    if is_store and scope not in ("store", "all"):
        return
    if not is_store and scope not in ("checkpoint", "all"):
        return
    if is_store:
        spec._store_fs_ops += 1
        ops, failed = spec._store_fs_ops, spec._store_fs_failed
    else:
        spec._fs_ops += 1
        ops, failed = spec._fs_ops, spec._fs_failed
    if _should_fire(sub, ops, failed) and spec._in_window(sub):
        if is_store:
            spec._store_fs_failed += 1
        else:
            spec._fs_failed += 1
        _inject_metric("fs_transient")
        import errno
        raise OSError(errno.EIO,
                      f"chaos fs_transient ({op} {path})")


def on_store_load(path: str) -> bool:
    """Artifact-store read hook (store/artifact_store.py, after the
    bytes are read, before validation): True = treat this entry as
    corrupted — the store must log, count a miss, and recompile."""
    spec = active()
    if spec is None or not spec.store_corrupt:
        return False
    sub = spec.store_corrupt
    spec._store_ops += 1
    if _should_fire(sub, spec._store_ops, spec._store_failed) \
            and spec._in_window(sub):
        spec._store_failed += 1
        _inject_metric("store_corrupt")
        logger.warning("chaos: corrupting artifact-store read of %s",
                       path)
        return True
    return False


def on_data_request(worker_index: int, requests_served: int) -> bool:
    """Data-worker hook (compute_service.DataWorker, per batch/item
    request): True = this worker dies NOW (the caller hard-stops its
    server so consumers see connection resets, the real failure
    shape)."""
    spec = active()
    if spec is None or not spec.data_worker_kill:
        return False
    sub = spec.data_worker_kill
    if int(sub.get("worker", -1)) != int(worker_index):
        return False
    if requests_served < int(sub.get("after_batches", 0)):
        return False
    _inject_metric("data_worker_kill")
    logger.warning("chaos: killing data worker %d after %d requests",
                   worker_index, requests_served)
    return True


def on_replica_dispatch(replica_index: int, dispatched: int) -> bool:
    """Fleet-router dispatch hook (serving.router.FleetRouter, per
    routed request): True = the chosen replica dies NOW, before the
    request lands on it (the router must treat the replica as dead —
    re-admit its queued and in-flight requests on survivors — and
    re-route this request)."""
    spec = active()
    if spec is None or not spec.replica_kill:
        return False
    sub = spec.replica_kill
    if int(sub.get("replica", -1)) != int(replica_index):
        return False
    if dispatched < int(sub.get("after_requests", 0)):
        return False
    _inject_metric("replica_kill")
    logger.warning("chaos: killing serve replica %d after %d dispatches",
                   replica_index, dispatched)
    return True


def replica_slow_s(replica_index: int, dispatched: int) -> float:
    """Degraded-replica hook (same dispatch path): extra seconds of
    routing delay every dispatch to the target replica observes after
    its ``after_requests``-th — 0.0 when the drill is not armed."""
    spec = active()
    if spec is None or not spec.replica_slow:
        return 0.0
    sub = spec.replica_slow
    if int(sub.get("replica", -1)) != int(replica_index):
        return 0.0
    if dispatched < int(sub.get("after_requests", 0)):
        return 0.0
    _inject_metric("replica_slow")
    return float(sub.get("delay", 0.0))


def resize_notice(step: int) -> Optional[Dict[str, Any]]:
    """Resize-drill hook (ResizeCoordinator.poll, once per training
    step): the pending world-change notice for this step, or None.
    Fires AT MOST ONCE per notice kind — the returned dict
    (``{"kind": "host_loss"|"slice_loss"|"host_return", "host"|"slice":
    i}``) is what a real node agent / slice-health watcher would
    deliver; the coordinator turns it into a quiesce agreement."""
    spec = active()
    if spec is None:
        return None
    for kind in ("host_loss", "slice_loss", "host_return"):
        sub = getattr(spec, kind)
        if not sub or kind in spec._resize_fired:
            continue
        if step < int(sub.get("at_step", 0)):
            continue
        spec._resize_fired.add(kind)
        _inject_metric(kind)
        notice = {"kind": kind}
        if "host" in sub:
            notice["host"] = int(sub["host"])
        if "slice" in sub:
            notice["slice"] = int(sub["slice"])
        logger.warning("chaos: delivering %s notice at step %d (%s)",
                       kind, step, notice)
        return notice
    return None


def clock_skew_s() -> float:
    """Seconds to ADD to this host's wall-clock trace anchors
    (tracing/merge epoch anchor, straggler wall_time): the NTP-drift
    drill. 0.0 with no spec."""
    spec = active()
    if spec is None or not spec.clock_skew:
        return 0.0
    sub = spec.clock_skew
    hosts = sub.get("hosts")
    if hosts is not None and _process_index() not in {int(h)
                                                     for h in hosts}:
        return 0.0
    return float(sub.get("offset", 0.0))


def deliver_preemption(path: Optional[str] = None) -> str:
    """Touch the preemption sentinel (operator drill / test helper)."""
    path = path or knobs.get("HOROVOD_PREEMPTION_FILE")
    if not path:
        raise ValueError("no sentinel path: pass one or set "
                         "HOROVOD_PREEMPTION_FILE")
    with open(path, "w") as f:
        f.write(str(time.time()))
    return path
