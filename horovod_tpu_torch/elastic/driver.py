"""ElasticDriver (the port's copy of ``horovod_tpu/elastic/driver.py``) —
discovery loop, rank-preserving assignment, worker
lifecycle (ref horovod/runner/elastic/driver.py:69).

Responsibilities (same contract as the reference):
- poll host discovery every ``DISCOVERY_INTERVAL`` (driver.py:188, 1 s);
- on change, recompute slot assignments PRESERVING existing ranks
  (driver.py:240-282: surviving hosts keep their slots; new hosts append),
  then notify workers (they raise HostsUpdatedInterrupt at next commit);
- track worker readiness for rendezvous barriers (registration.py);
- on worker exit: success -> record; failure -> blacklist the host (with
  discovery-side cooldown) and restart the slot if capacity remains
  (driver.py:304 _handle_worker_exit);
- enforce min_np/max_np and a startup timeout.

The driver is framework-pure Python (no torch): identical control plane for
localhost tests and multi-host launches, exactly like the reference's
driver is shared by gloo_run and spark.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch.elastic.discovery import HostManager, HostUpdateResult
from horovod_tpu_torch.utils import schedhooks
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.elastic.driver")


@dataclasses.dataclass
class SlotInfo:
    """Per-process placement (ref runner/common/util/hosts.py SlotInfo)."""
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int


def assign_slots(host_order: List[str], hosts: Dict[str, int],
                 max_np: Optional[int] = None) -> List[SlotInfo]:
    """Deterministic slot layout: hosts in stable order, ranks dense.
    cross_rank = index of host, local_rank = slot on host."""
    slots: List[SlotInfo] = []
    for ci, h in enumerate(host_order):
        for li in range(hosts.get(h, 0)):
            slots.append(SlotInfo(h, len(slots), li, ci, 0, hosts[h],
                                  len(host_order)))
            if max_np is not None and len(slots) >= max_np:
                break
        if max_np is not None and len(slots) >= max_np:
            break
    for s in slots:
        s.size = len(slots)
    return slots


class _Worker:
    def __init__(self, slot: SlotInfo):
        self.slot = slot
        self.ready = False
        self.exit_code: Optional[int] = None


class ElasticDriver:
    DISCOVERY_INTERVAL = 1.0

    def __init__(self, discovery, min_np: int, max_np: Optional[int] = None,
                 timeout: float = 600.0, reset_limit: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.host_manager = HostManager(discovery, clock=clock)
        self.min_np = min_np
        self.max_np = max_np
        self.timeout = timeout
        self.reset_limit = reset_limit
        self._clock = clock
        self._create_worker_fn: Optional[Callable] = None
        # keyed by (hostname, local_rank) — stable across rank renumbering
        self._workers: Dict[tuple, _Worker] = {}
        self._assignments: List[SlotInfo] = []
        self._listeners: List[Callable[[float, int], None]] = []
        self._lock = schedhooks.RLock()
        self._shutdown = schedhooks.Event()
        self._wakeup = schedhooks.Event()
        self._discovery_thread: Optional[threading.Thread] = None
        self._reset_count = 0
        self.world_size_history: List[int] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self, np_start: int,
              create_worker_fn: Callable[[SlotInfo], None]) -> None:
        """Begin discovery + launch initial workers (ref driver.py:102)."""
        self._create_worker_fn = create_worker_fn
        self.host_manager.update_available_hosts()
        self.wait_for_available_slots(min(np_start, self.min_np))
        self._update_assignments(initial=True)
        self._discovery_thread = schedhooks.Thread(
            target=self._discovery_loop, name="hvd-elastic-discovery",
            daemon=True)
        self._discovery_thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        self._wakeup.set()
        if self._discovery_thread:
            self._discovery_thread.join(timeout=5)

    def register_worker_notification_listener(
            self, fn: Callable[[float, int], None]) -> None:
        """fn(timestamp, update_result) — e.g. State.on_hosts_updated or a
        WorkerNotificationClient.send."""
        self._listeners.append(fn)

    # -- discovery ---------------------------------------------------------
    def _discovery_loop(self) -> None:
        while not self._shutdown.is_set():
            res = self.host_manager.update_available_hosts()
            if res != HostUpdateResult.NO_UPDATE:
                self._on_hosts_updated(res)
            self._wakeup.wait(self.DISCOVERY_INTERVAL)
            self._wakeup.clear()

    def _on_hosts_updated(self, res: int) -> None:
        from horovod_tpu_torch import metrics as M
        M.counter("hvd_elastic_host_updates_total",
                  "Discovery-observed cluster membership changes").inc()
        with self._lock:
            self._update_assignments()
            ts = self._clock()
            dropped = 0
            for fn in self._listeners:
                try:
                    fn(ts, res)
                except Exception:
                    # One broken listener must not starve the rest —
                    # but a worker that never hears about this update
                    # commits against a stale world, so the drop is
                    # logged and counted rather than swallowed.
                    dropped += 1
                    M.counter(
                        "hvd_elastic_notification_failures_total",
                        "Worker notification deliveries that errored"
                    ).inc()
                    logger.warning(
                        "hosts-updated listener %r failed; that worker "
                        "missed a membership change", fn, exc_info=True)
        if dropped:
            # OUTSIDE self._lock: the mirror runs exactly when the
            # network is misbehaving, and a retrying KV set (backoff
            # sleeps included) under the driver lock would stall
            # discovery/failure handling for the whole degradation
            # window.
            self._mirror_hosts_updated_kv(ts, res)

    def _mirror_hosts_updated_kv(self, ts: float, res: int) -> None:
        """Socket delivery failed for someone: mirror the event into the
        c10d store (``utils/kvstore.distributed_kv``; site
        'elastic_notification', an optional/sheddable fault-domain site)
        so a worker that missed
        the push can still observe the membership change from
        State.check_host_updates at its next commit. Best-effort — the
        launcher may run without a KV store at all: ``distributed_kv``
        returns None in a process that has no store, and nothing is
        mirrored. Under ``hvdrun-torch`` the launcher hosts each
        generation's store, so the mirror reaches the workers."""
        try:
            from horovod_tpu_torch.resilience import faults
            from horovod_tpu_torch.utils.kvstore import distributed_kv
            if faults.should_shed("elastic_notification"):
                return
            kv = distributed_kv(site="elastic_notification", root=True)
            if kv is None:
                return
            import json as _json
            import time as _time
            # wall_time guards staleness: the mirror PERSISTS in the KV,
            # and a worker respawned BY this very update must not
            # re-consume it and restart forever (State._poll_kv_fallback
            # ignores events stamped before its process start — the
            # preemption sentinel's stale-mtime pattern). `timestamp`
            # stays in the driver's notification clock domain for dedup
            # against socket-delivered events.
            kv.set("hvd/elastic/hosts_updated",
                   _json.dumps({"timestamp": ts, "res": int(res),
                                "wall_time": _time.time()}),
                   overwrite=True)
        except Exception:
            logger.warning("hosts-updated KV mirror failed", exc_info=True)

    # -- assignment --------------------------------------------------------
    def _update_assignments(self, initial: bool = False) -> None:
        """Recompute SlotInfos, preserving ranks of surviving hosts (the
        HostManager's stable host order provides this), then reconcile the
        worker set: spawn workers for newly assigned slots (new hosts or
        restarted capacity), drop records for slots no longer assigned
        (ref driver.py:240-282 + _handle_worker_exit restart path)."""
        del initial
        with self._lock:
            hosts = self.host_manager.current_hosts
            order = self.host_manager.host_assignment_order
            new = assign_slots(order, hosts, self.max_np)
            self._assignments = new
            self.world_size_history.append(len(new))
            if self._create_worker_fn is None:
                return
            assigned = {(s.hostname, s.local_rank): s for s in new}
            for key in list(self._workers):
                if key not in assigned and \
                        self._workers[key].exit_code is None:
                    del self._workers[key]  # slot gone; process reaped by
                    # the launcher when its host left the cluster
            for key, slot in assigned.items():
                w = self._workers.get(key)
                if w is None or w.exit_code is not None:
                    # no worker, or the previous one exited (e.g. the host
                    # came back after cooldown) -> spawn a fresh process
                    self._workers[key] = _Worker(slot)
                    self._create_worker_fn(slot)
                else:
                    w.slot = slot  # rank may have been renumbered

    def get_slot_info(self, rank: int) -> Optional[SlotInfo]:
        with self._lock:
            for s in self._assignments:
                if s.rank == rank:
                    return s
            return None

    @property
    def current_assignments(self) -> List[SlotInfo]:
        with self._lock:
            return list(self._assignments)

    def world_size(self) -> int:
        with self._lock:
            return len(self._assignments)

    # -- readiness / rendezvous (ref registration.py) ------------------------
    def record_ready(self, hostname: str, local_rank: int) -> None:
        with self._lock:
            for w in self._workers.values():
                if (w.slot.hostname == hostname
                        and w.slot.local_rank == local_rank):
                    w.ready = True

    def all_ranks_ready(self) -> bool:
        with self._lock:
            active = [w for w in self._workers.values()
                      if w.exit_code is None]
            return bool(active) and all(w.ready for w in active)

    def wait_for_available_slots(self, min_np: int,
                                 timeout: Optional[float] = None) -> int:
        """Block until discovery offers >= min_np slots (ref driver.py:153;
        min-np timeout test SURVEY §4 tier 3)."""
        deadline = self._clock() + (timeout if timeout is not None
                                    else self.timeout)
        while True:
            slots = self.host_manager.available_slots
            if slots >= min_np:
                return slots
            if self._clock() >= deadline:
                raise TimeoutError(
                    f"timed out waiting for {min_np} slots "
                    f"(have {slots}); check host discovery")
            self.host_manager.update_available_hosts()
            time.sleep(0.05)  # poll cadence; avoids hammering the script

    # -- worker exits (ref driver.py:304) ------------------------------------
    def record_worker_exit(self, rank: int, exit_code: int,
                           restart: bool = True) -> None:
        """Worker process ended. Success records completion. A resumable
        exit (resilience RESUMABLE_EXIT_CODE: preemption snapshot
        committed on purpose) respawns the slot WITHOUT blacklisting its
        host — the respawned worker restores the latest committed
        snapshot. Any other failure blacklists the host and recomputes
        assignments; with ``restart`` (default), the reconcile pass
        respawns workers for any slots that remain or return after
        cooldown — without it the slot stays down (graceful shutdown)."""
        from horovod_tpu_torch.resilience.preemption import RESUMABLE_EXIT_CODE
        with self._lock:
            w = None
            for cand in self._workers.values():
                if cand.slot.rank == rank and cand.exit_code is None:
                    w = cand
                    break
            if w is None:
                return
            w.exit_code = exit_code
            if exit_code == RESUMABLE_EXIT_CODE:
                from horovod_tpu_torch import metrics as M
                M.counter("hvd_elastic_resets_total",
                          "Runtime resets (shutdown + re-init on a new "
                          "topology) performed by hvd.elastic.run").inc()
                self._reset_count += 1
                if restart:
                    # reconcile respawns the slot (exit_code is set, host
                    # is NOT blacklisted)
                    self._update_assignments()
            elif exit_code != 0:
                from horovod_tpu_torch import metrics as M
                M.counter("hvd_elastic_worker_failures_total",
                          "Worker processes that exited non-zero "
                          "(host blacklisted)").inc()
                self._reset_count += 1
                host = w.slot.hostname
                if not restart:
                    self._create_worker_fn_backup = self._create_worker_fn
                    self._create_worker_fn = None
                self.host_manager.blacklist(host)
                self._on_hosts_updated(HostUpdateResult.REMOVED)
                if not restart:
                    self._create_worker_fn = self._create_worker_fn_backup

    @property
    def reset_count(self) -> int:
        return self._reset_count

    def has_available_capacity(self) -> bool:
        return self.host_manager.available_slots >= self.min_np

    def finished(self) -> bool:
        with self._lock:
            return all(w.exit_code == 0 for w in self._workers.values()) \
                and bool(self._workers)
