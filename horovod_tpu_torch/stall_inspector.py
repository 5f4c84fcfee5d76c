"""Stall inspector: warns about async collective handles that stay
outstanding, and can abort the job.

The counterpart of ``horovod_tpu/stall_inspector.py`` (the reference's
common/stall_inspector.{h,cc}). Every rank issues its collectives in
program order, so the stall a rank can see is a handle (``eager.Handle``)
that is never waited on, or one whose collective never completes because
another rank is missing. Handles are recorded at their start and dropped
when done; a checker thread warns once per handle past
HOROVOD_STALL_CHECK_TIME_SECONDS and, past
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS (0 = never), drops it, counts an
abort and calls the registered abort callback.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger


class StallInspector:
    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._pending: Dict[str, float] = {}
        self._warned: set = set()
        self._thread: Optional[threading.Thread] = None
        self._abort_cb: Optional[Callable[[str], None]] = None
        self.stalled_shutdown = False
        from horovod_tpu_torch import metrics as M
        self._m_warn = M.counter(
            "hvd_stall_warnings_total",
            "Operations outstanding past HOROVOD_STALL_CHECK_TIME_SECONDS")
        self._m_abort = M.counter(
            "hvd_stall_aborts_total",
            "Stalls that crossed HOROVOD_STALL_SHUTDOWN_TIME_SECONDS and "
            "triggered job abort")

    # -- registration (called by the eager handles) ------------------------
    def record_start(self, name: str) -> None:
        if knobs.get("HOROVOD_STALL_CHECK_DISABLE"):
            return
        with self._lock:
            self._pending.setdefault(name, self._clock())
            self._ensure_thread()

    def record_done(self, name: str) -> None:
        with self._lock:
            self._pending.pop(name, None)
            self._warned.discard(name)

    def set_abort_callback(self, cb: Callable[[str], None]) -> None:
        self._abort_cb = cb

    # -- checking ----------------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while True:
            time.sleep(1.0)
            self.check_for_stalls()

    def check_for_stalls(self) -> None:
        """One inspection pass (the checker thread's; tests call it)."""
        warn_after = knobs.get("HOROVOD_STALL_CHECK_TIME_SECONDS")
        kill_after = knobs.get("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS")
        now = self._clock()
        log = get_logger("horovod_tpu_torch.stall")
        aborts = []
        with self._lock:
            for name, t0 in list(self._pending.items()):
                age = now - t0
                if age > warn_after and name not in self._warned:
                    self._warned.add(name)
                    self._m_warn.inc()
                    log.warning(
                        "operation %s outstanding for %.0f s: one or more "
                        "ranks may be stalled", name, age)
                if kill_after and age > kill_after:
                    self.stalled_shutdown = True
                    self._m_abort.inc()
                    msg = (f"operation {name} stalled for {age:.0f}s > "
                           f"HOROVOD_STALL_SHUTDOWN_TIME_SECONDS; aborting")
                    log.error(msg)
                    self._pending.pop(name, None)
                    aborts.append(msg)
        # the callback runs outside the lock: one that calls record_done
        # must not deadlock, and one that raises must not end the loop
        if aborts:
            from horovod_tpu_torch.tracing import spans
            spans.dump_flight_recording("stall-abort")
        cb = self._abort_cb
        if cb:
            for msg in aborts:
                try:
                    cb(msg)
                except Exception:
                    log.exception("stall abort callback raised")

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def warned_count(self) -> int:
        """Outstanding operations past the warning threshold."""
        with self._lock:
            return len(self._warned)

    def reset(self) -> None:
        """Drop all tracked state."""
        with self._lock:
            self._pending.clear()
            self._warned.clear()
            self.stalled_shutdown = False


_inspector: Optional[StallInspector] = None


def get_stall_inspector() -> StallInspector:
    global _inspector
    if _inspector is None:
        _inspector = StallInspector()
    return _inspector
