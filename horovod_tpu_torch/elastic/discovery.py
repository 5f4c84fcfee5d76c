"""Host discovery + blacklist: the port's copy of
``horovod_tpu/elastic/discovery.py`` (ref
horovod/runner/elastic/discovery.py).

- ``HostDiscovery`` / ``HostDiscoveryScript`` (:226-263): a user script is
  polled; each stdout line is ``hostname`` or ``hostname:slots``.
- ``HostManager`` (:112-180): tracks current hosts, computes diffs on each
  poll, orders hosts stably (existing first — rank preservation), and
  blacklists failing hosts with an exponential-backoff cooldown
  (:33-110 CooldownPeriodState) so transiently bad hosts can return.
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Callable, Dict, List, Set


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """Returns {hostname: slot_count}."""
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Poll an executable script (ref discovery.py:226): one host per line,
    ``hostname:slots`` or bare ``hostname`` (then ``default_slots``)."""

    def __init__(self, discovery_script: str, default_slots: int = 1):
        self.script = discovery_script
        self.default_slots = default_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.check_output(
            self.script, shell=True, timeout=60).decode()
        hosts: Dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                name, slots = line.rsplit(":", 1)
                hosts[name] = int(slots)
            else:
                hosts[line] = self.default_slots
        return hosts


class FixedHosts(HostDiscovery):
    """Static (or test-mutable) host set."""

    def __init__(self, hosts: Dict[str, int]):
        self._hosts = dict(hosts)

    def set(self, hosts: Dict[str, int]) -> None:
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class _Cooldown:
    """Exponential-backoff blacklist entry (ref discovery.py:33
    CooldownPeriodState: base 10s doubling to a 5-min cap, with jitter in
    the reference; deterministic here for testability)."""

    BASE_SECONDS = 10.0
    MAX_SECONDS = 300.0

    def __init__(self):
        self.failures = 0
        self.until = 0.0

    def trip(self, now: float) -> None:
        self.failures += 1
        period = min(self.BASE_SECONDS * (2 ** (self.failures - 1)),
                     self.MAX_SECONDS)
        self.until = now + period

    def active(self, now: float) -> bool:
        return now < self.until


class HostUpdateResult:
    NO_UPDATE = 0
    ADDED = 1
    REMOVED = 2
    MIXED = 3


class HostManager:
    """Tracks available hosts across polls (ref discovery.py:112)."""

    def __init__(self, discovery: HostDiscovery,
                 clock: Callable[[], float] = time.monotonic):
        self.discovery = discovery
        self._clock = clock
        self._lock = threading.Lock()
        self.current_hosts: Dict[str, int] = {}
        # stable ordering: hosts keep their position across updates so
        # existing ranks are preserved (ref driver.py:240-282)
        self.host_assignment_order: List[str] = []
        self._cooldowns: Dict[str, _Cooldown] = {}

    def blacklist(self, host: str) -> None:
        """Start/extend a cooldown for a failing host (ref
        discovery.py:169)."""
        with self._lock:
            cd = self._cooldowns.setdefault(host, _Cooldown())
            cd.trip(self._clock())
            if host in self.current_hosts:
                del self.current_hosts[host]
                self.host_assignment_order.remove(host)

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            cd = self._cooldowns.get(host)
            return bool(cd and cd.active(self._clock()))

    def update_available_hosts(self) -> int:
        """Poll discovery, apply blacklist filtering, diff against current.
        Returns a HostUpdateResult bitmaskish code (ref discovery.py:152)."""
        found = self.discovery.find_available_hosts_and_slots()
        now = self._clock()
        with self._lock:
            usable = {h: s for h, s in found.items()
                      if not (self._cooldowns.get(h)
                              and self._cooldowns[h].active(now))}
            prev: Set[str] = set(self.current_hosts)
            cur: Set[str] = set(usable)
            added = cur - prev
            removed = prev - cur
            grew = {h for h in (cur & prev)
                    if usable[h] > self.current_hosts[h]}
            shrank = {h for h in (cur & prev)
                      if usable[h] < self.current_hosts[h]}
            self.current_hosts = usable
            self.host_assignment_order = (
                [h for h in self.host_assignment_order
                 if h in cur] + sorted(added))
            gained = bool(added or grew)
            lost = bool(removed or shrank)  # slot decrease = capacity loss
            if not gained and not lost:
                return HostUpdateResult.NO_UPDATE
            if gained and not lost:
                return HostUpdateResult.ADDED
            if lost and not gained:
                return HostUpdateResult.REMOVED
            return HostUpdateResult.MIXED

    @property
    def available_slots(self) -> int:
        with self._lock:
            return sum(self.current_hosts.values())
