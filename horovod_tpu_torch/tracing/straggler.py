"""Straggler detection: per-rank step-time skew over the KV store.

The port's copy of ``horovod_tpu/tracing/straggler.py``. Every collective
runs at the pace of the slowest rank, so a 20 % skew on one card is a
20 % tax on all of them, invisible in any single rank's metrics.

Each rank keeps a sliding window of its own step times
(``observe_step``, fed by the train loop's StepStats measurement) and
publishes the window mean under ``hvd/straggler/p<i>`` (overwrite — a
republished key, like the metrics snapshots). ``publish_and_check``
reads every peer's mean, computes ``skew = max - min``, exports the
``hvd_straggler_skew_seconds`` gauge, and remembers the slowest rank and
its host (``snapshot()``, the ``straggler`` block of ``/healthz``,
``metrics.health_snapshot``). Detection is symmetric: every rank computes the same view,
nobody blocks on a peer (missing keys contribute nothing).
"""

from __future__ import annotations

import json
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.tracing")

_KV_PREFIX = "hvd/straggler"

_active: Optional["StragglerDetector"] = None
_active_lock = threading.Lock()


def active_detector() -> Optional["StragglerDetector"]:
    """The installed detector (``/healthz`` consults it), or None."""
    return _active


def install(det: Optional["StragglerDetector"]) -> None:
    global _active
    with _active_lock:
        _active = det


class StragglerDetector:
    def __init__(self, kv, process_index: int, process_count: int,
                 window: int = 20, publish_every: int = 10,
                 hostname: Optional[str] = None):
        from horovod_tpu_torch import metrics as M
        self._kv = kv
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.publish_every = max(int(publish_every), 1)
        self.hostname = hostname or socket.gethostname()
        self._window: "deque" = deque(maxlen=max(int(window), 2))
        self._steps = 0
        self._last: Dict[str, Any] = {
            "skew_seconds": 0.0, "slowest": None, "means": {}}
        self._lock = threading.Lock()
        self._m_skew = M.gauge(
            "hvd_straggler_skew_seconds",
            "Max - min of per-host mean step time across the world "
            "(sliding window; 0 until every host published)",
            aggregation="leader")

    def _key(self, idx: int) -> str:
        return f"{_KV_PREFIX}/p{idx}"

    def local_mean(self) -> Optional[float]:
        with self._lock:
            if not self._window:
                return None
            return sum(self._window) / len(self._window)

    def observe_step(self, seconds: float) -> None:
        """Feed one step's wall time; every ``publish_every`` steps the
        local mean is published and the world view recomputed."""
        with self._lock:
            self._window.append(float(seconds))
            self._steps += 1
            due = self._steps % self.publish_every == 0
        if due:
            try:
                self.publish_and_check()
            except Exception:
                logger.warning("straggler skew exchange failed",
                               exc_info=True)

    def publish_and_check(self) -> Dict[str, Any]:
        from horovod_tpu_torch.resilience import faults
        if faults.should_shed("straggler"):
            # degraded mode: the skew exchange is optional traffic —
            # serve the last computed world view until the site heals
            with self._lock:
                return dict(self._last)
        mean = self.local_mean()
        if mean is not None and self._kv is not None:
            from horovod_tpu_torch.resilience import chaos
            self._kv.set(self._key(self.process_index), json.dumps({
                "mean_step_seconds": mean,
                "hostname": self.hostname,
                "steps": self._steps,
                "wall_time": time.time() + chaos.clock_skew_s(),
            }), overwrite=True)
        means: Dict[str, Dict[str, Any]] = {}
        if mean is not None:
            means[str(self.process_index)] = {
                "mean_step_seconds": mean, "hostname": self.hostname}
        if self._kv is not None:
            for i in range(self.process_count):
                if i == self.process_index:
                    continue
                try:
                    raw = self._kv.try_get(self._key(i))
                except Exception:
                    continue               # dead peer: judge who answered
                if not raw:
                    continue
                try:
                    row = json.loads(raw)
                    means[str(i)] = {
                        "mean_step_seconds":
                            float(row["mean_step_seconds"]),
                        "hostname": row.get("hostname", f"p{i}")}
                except Exception:
                    logger.warning("unparseable straggler row from "
                                   "process %d", i)
        if means:
            slowest = max(means,
                          key=lambda k: means[k]["mean_step_seconds"])
            fastest = min(means,
                          key=lambda k: means[k]["mean_step_seconds"])
            skew = (means[slowest]["mean_step_seconds"]
                    - means[fastest]["mean_step_seconds"])
        else:
            slowest, skew = None, 0.0
        snap = {
            "skew_seconds": round(skew, 6),
            "slowest": (f"p{slowest} "
                        f"({means[slowest]['hostname']})"
                        if slowest is not None else None),
            "means": {k: round(v["mean_step_seconds"], 6)
                      for k, v in means.items()},
        }
        with self._lock:
            self._last = snap
        self._m_skew.set(skew)
        return snap

    def snapshot(self) -> Dict[str, Any]:
        """Last computed world view (what /healthz serves)."""
        with self._lock:
            return dict(self._last)


def from_env(window: int = 20) -> Optional[StragglerDetector]:
    """A detector over the default process group's c10d store, or None in
    a world of one (there is no peer to lag behind). Installs itself as
    the process-global detector."""
    try:
        from horovod_tpu_torch.utils import schedhooks
        rank, world = schedhooks.process_world()
        if world <= 1:
            return None
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        kv = distributed_kv(site="straggler")
        if kv is None:
            return None
        det = StragglerDetector(kv, rank, world, window=window)
        install(det)
        return det
    except Exception:                     # pragma: no cover - defensive
        logger.warning("straggler detector unavailable", exc_info=True)
        return None
