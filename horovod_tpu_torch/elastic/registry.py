"""Member registry (the port's copy of ``horovod_tpu/elastic/registry.py``):
the elastic discovery/blacklist machinery recast
from training-world host membership to generic member lifecycle (the
hvdfleet replica registry, docs/serving.md "Fleet").

``ElasticDriver`` couples three ideas: a polled discovery source, the
:class:`~horovod_tpu_torch.elastic.discovery.HostManager` diff/blacklist
core, and a listener fan-out that pushes membership changes to
interested parties (``_on_hosts_updated``). :class:`MemberRegistry`
packages exactly those three for callers whose members are not
training hosts — the serving fleet registers engine replicas here, so
replica join/leave/death flows through the SAME ordering (stable:
existing members keep their position), the same blacklist-with-cooldown
(a dead replica cannot rejoin while cooling down), and the same
fan-out-with-failure-isolation semantics the elastic driver gives
training hosts.

The registry is deliberately protocol-only (no sockets, no threads of
its own). The port has no serving fleet yet (ROADMAP A.11); the class is
here so that fleet finds it, and its tests hold it to the JAX package's.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch.elastic.discovery import (
    FixedHosts,
    HostManager,
    HostUpdateResult,
)
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.elastic")


class MemberRegistry:
    """Stable-ordered membership with blacklist and listener fan-out.

    Members are named strings with a slot count (for replicas: decode
    slots — the capacity the router load-balances over). Listeners are
    called as ``fn(timestamp, update_result)`` after every membership
    change, mirroring the driver's hosts-updated fan-out: a raising
    listener is counted and skipped, never allowed to wedge the
    registry (the driver's failure-isolation discipline).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._fixed = FixedHosts({})
        self.manager = HostManager(self._fixed, clock=clock)
        self._clock = clock
        self._lock = threading.Lock()
        self._listeners: List[Callable[[float, int], None]] = []
        self.listener_failures = 0

    # -- listener fan-out (driver._on_hosts_updated idiom) -------------------
    def register_listener(self, fn: Callable[[float, int], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[float, int], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify(self, res: int) -> None:
        if res == HostUpdateResult.NO_UPDATE:
            return
        with self._lock:
            listeners = list(self._listeners)
        ts = self._clock()
        for fn in listeners:
            try:
                fn(ts, res)
            except Exception:
                self.listener_failures += 1
                logger.exception("member-registry listener failed")

    # -- membership edges ----------------------------------------------------
    def join(self, member: str, slots: int = 1) -> int:
        """Admit ``member`` (no-op while it is cooling down on the
        blacklist — the rejected-join is what keeps a freshly-dead
        replica from flapping straight back in)."""
        hosts = dict(self._fixed.find_available_hosts_and_slots())
        hosts[member] = int(slots)
        self._fixed.set(hosts)
        res = self.manager.update_available_hosts()
        self._notify(res)
        return res

    def leave(self, member: str) -> int:
        """Graceful departure (a drained replica): removed from the
        source set, NOT blacklisted — it may rejoin immediately."""
        hosts = dict(self._fixed.find_available_hosts_and_slots())
        hosts.pop(member, None)
        self._fixed.set(hosts)
        res = self.manager.update_available_hosts()
        self._notify(res)
        return res

    def dead(self, member: str) -> int:
        """Failure departure: blacklisted with the exponential cooldown
        (discovery._Cooldown), then removed — the REMOVED notification
        is what triggers the caller's reconcile (re-admission of the
        member's in-flight work)."""
        self.manager.blacklist(member)
        hosts = dict(self._fixed.find_available_hosts_and_slots())
        hosts.pop(member, None)
        self._fixed.set(hosts)
        self.manager.update_available_hosts()
        self._notify(HostUpdateResult.REMOVED)
        return HostUpdateResult.REMOVED

    def is_blacklisted(self, member: str) -> bool:
        return self.manager.is_blacklisted(member)

    # -- views ---------------------------------------------------------------
    def members(self) -> List[str]:
        """Current members in stable assignment order (existing first —
        the rank-preservation ordering, reused as deterministic
        placement tie-break order)."""
        with self.manager._lock:
            return list(self.manager.host_assignment_order)

    def slots(self, member: str) -> int:
        with self.manager._lock:
            return int(self.manager.current_hosts.get(member, 0))

    def size(self) -> int:
        return len(self.members())
