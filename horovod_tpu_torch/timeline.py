"""Chrome-trace timeline of the control plane (ref common/timeline.{h,cc}).

The counterpart of ``horovod_tpu/timeline.py``. The reference's
coordinator writes a chrome://tracing JSON of every tensor's lifecycle
(NEGOTIATE phases, QUEUE, the fusion-buffer copies, the backend op, the
wait) from a dedicated writer thread fed by queues (timeline.h:28,
timeline.cc:150,298), switched on by ``HOROVOD_TIMELINE[=DYNAMIC]`` and
``horovod_start/stop_timeline`` (operations.cc:1073-1105).

Here the host-side phases (queue, fusion planning, dispatch, handle wait)
are recorded in that format by the native core's C++ writer thread
(``native.NativeTimelineWriter``), or by a Python queue and thread under
HOROVOD_TPU_NATIVE=0. Every ``span`` also opens a
``torch.profiler.record_function`` range named ``hvd:<phase>:<name>``, so
a ``torch.profiler`` trace of the same run lines up by name. Timeline
events mirror into the span recorder (``tracing/spans.py``) by default;
call sites that record their own span for the same interval (the
coordinator's QUEUE pair and dispatch, the handle's wait) pass
``mirror=False``. The two writer guarantees of the JAX package:

- the Python writer emits complete events (``ph:"X"`` with ``dur``) for
  ``span()`` intervals (the native writer keeps B/E pairs, its emitter
  has no dur slot);
- the Python writer's file is a valid JSON array after every flush (each
  event write re-seals the array), so a process that dies mid-run leaves
  a timeline that loads. The native writer's file is valid once
  :func:`stop_timeline` (or ``shutdown``, for a timeline ``init``
  started) has closed it.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from horovod_tpu_torch.config import knobs


def _spans():
    from horovod_tpu_torch.tracing import spans
    return spans


# Per-thread count of open mirror=False timeline spans: their intervals
# are natively covered, so nested timeline spans must not mirror either
# (see Timeline.span).
_mirror_tls = threading.local()

# Phase names of the reference's activity strings (common.h:79-113)
NEGOTIATE = "NEGOTIATE"
QUEUE = "QUEUE"
FUSION = "MEMCPY_IN_FUSION_BUFFER"
DISPATCH = "DISPATCH"
WAIT = "WAIT_FOR_DATA"
CYCLE = "CYCLE"


class Timeline:
    """Per-process timeline writer. Thread-safe; events flow to a
    dedicated writer thread (the native one when the core is on)."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._file = None
        self._tail = 0            # file offset of the array close bracket
        self._wrote_any = False
        self._native = None
        self._active = False
        self.from_env = False     # started by init (shutdown stops it)
        # RLock: start() emits its own first event while holding the lock,
        # and _emit must hold it too (stop() frees the native handle).
        self._lock = threading.RLock()
        self._t0 = time.perf_counter()

    # -- lifecycle (ref horovod_start/stop_timeline operations.cc:1073) ------
    def start(self, path: str) -> None:
        from horovod_tpu_torch import native
        with self._lock:
            if self._active:
                return
            if native.available():
                self._native = native.NativeTimelineWriter(
                    path, pid=os.getpid())
            else:
                # Valid from birth: "[\n]" parses as an empty array; every
                # event write seeks back over the close bracket, appends,
                # and re-seals.
                self._file = open(path, "w")
                self._file.write("[\n")
                self._tail = self._file.tell()
                self._file.write("]")
                self._file.flush()
                self._wrote_any = False
                self._thread = threading.Thread(target=self._writer_loop,
                                                name="hvd-timeline",
                                                daemon=True)
                self._thread.start()
            self._active = True
            self.instant("timeline_start")

    def stop(self) -> None:
        with self._lock:
            if not self._active:
                return
            self._active = False
            self.from_env = False
            if self._native is not None:
                dropped = self._native.dropped
                if dropped:
                    from horovod_tpu_torch.utils.logging import get_logger
                    get_logger("horovod_tpu_torch.timeline").warning(
                        "timeline dropped %d events (writer fell behind); "
                        "trace may have unmatched begin/end pairs", dropped)
                    self._native.event(
                        "timeline_dropped_events", "", "i", self._now_us(),
                        args_json=json.dumps({"dropped": dropped}))
                self._native.close(self._now_us())
                self._native = None
                return
            self._queue.put(None)
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            if self._file:
                ev = {"name": "timeline_end", "ph": "i",
                      "ts": self._now_us(), "pid": os.getpid()}
                self._file.seek(self._tail)
                if self._wrote_any:
                    self._file.write(",\n")
                self._file.write(json.dumps(ev) + "\n]")
                self._file.truncate()
                self._file.close()
                self._file = None

    @property
    def active(self) -> bool:
        return self._active

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _writer_loop(self) -> None:
        while True:
            ev = self._queue.get()
            if ev is None:
                return
            try:
                with self._lock:
                    if self._file:
                        self._file.seek(self._tail)
                        if self._wrote_any:
                            self._file.write(",\n")
                        self._file.write(json.dumps(ev))
                        self._tail = self._file.tell()
                        self._file.write("\n]")
                        self._file.truncate()
                        self._file.flush()
                        self._wrote_any = True
            except Exception:
                # A failing write must not be silent: count it, say so,
                # and keep draining so stop() can join this thread.
                from horovod_tpu_torch import metrics as M
                from horovod_tpu_torch.utils.logging import get_logger
                M.counter("hvd_timeline_write_failures_total",
                          "Timeline events lost to writer errors").inc()
                get_logger("horovod_tpu_torch.timeline").warning(
                    "timeline writer failed to record %r; trace will "
                    "have a gap", ev.get("name"), exc_info=True)

    def _emit(self, ev: Dict[str, Any]) -> None:
        if not self._active:
            return
        with self._lock:
            if not self._active:
                return
            if self._native is not None:
                args = ev.get("args")
                self._native.event(
                    ev["name"], ev.get("cat", ""), ev["ph"], ev["ts"],
                    tid=ev.get("tid", 0),
                    args_json=json.dumps(args) if args else None)
                return
        ev.setdefault("pid", os.getpid())
        self._queue.put(ev)

    # -- event API -----------------------------------------------------------
    # ``mirror`` (default True) also records the event in the span recorder
    # (tracing/spans.py); call sites that record their own span for the
    # same interval pass False.

    def begin(self, name: str, phase: str, tid: int = 0,
              mirror: bool = True) -> None:
        self._emit({"name": name, "cat": phase, "ph": "B",
                    "ts": self._now_us(), "tid": tid})
        if mirror:
            _spans().begin_async(name, phase)

    def end(self, name: str, phase: str, tid: int = 0,
            args: Optional[Dict] = None, mirror: bool = True) -> None:
        ev = {"name": name, "cat": phase, "ph": "E",
              "ts": self._now_us(), "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)
        if mirror:
            _spans().end_async(name, phase, attrs=args)

    def instant(self, name: str, args: Optional[Dict] = None,
                mirror: bool = True) -> None:
        ev = {"name": name, "ph": "i", "ts": self._now_us(), "s": "p"}
        if args:
            ev["args"] = args
        self._emit(ev)
        if mirror:
            _spans().instant(name, cat="timeline", attrs=args)

    def mark_cycle(self, cycle_idx: int) -> None:
        if knobs.get("HOROVOD_TIMELINE_MARK_CYCLES"):
            # the goodput phase the cycle landed in ('untracked' when
            # accounting is off), so the trace and the accountant agree
            from horovod_tpu_torch.goodput import accountant as _goodput
            self.instant(CYCLE, {"cycle": cycle_idx,
                                 "phase": _goodput.current_phase()})

    @contextmanager
    def span(self, name: str, phase: str = DISPATCH, tid: int = 0,
             mirror: bool = True):
        """A host span with a matching ``torch.profiler.record_function``
        range (the reference's NVTX-range analogue, nvtx_op_range.h). The
        Python writer records ONE complete event (``ph:"X"`` with
        ``dur``); the native writer keeps B/E pairs.

        A ``mirror=False`` span marks its interval as natively covered, so
        timeline spans nested inside it do not mirror either."""
        from torch.autograd.profiler import record_function
        t0 = self._now_us()
        if self._native is not None:
            self.begin(name, phase, tid, mirror=False)
        mirror_here = mirror and not getattr(_mirror_tls, "suppress", 0)
        sp = _spans().span(name, cat=phase) if mirror_here else None
        if sp is not None:
            sp.__enter__()
        if not mirror:
            _mirror_tls.suppress = getattr(_mirror_tls, "suppress", 0) + 1
        try:
            with record_function(f"hvd:{phase}:{name}"):
                yield
        finally:
            if not mirror:
                _mirror_tls.suppress -= 1
            if sp is not None:
                sp.__exit__(None, None, None)
            if self._native is not None:
                self.end(name, phase, tid, mirror=False)
            else:
                self._emit({"name": name, "cat": phase, "ph": "X",
                            "ts": t0, "dur": self._now_us() - t0,
                            "tid": tid})


_timeline = Timeline()


def get_timeline() -> Timeline:
    return _timeline


def start_timeline(path: str) -> None:
    """Runtime toggle (ref operations.cc:1073 horovod_start_timeline)."""
    _timeline.start(path)


def stop_timeline() -> None:
    _timeline.stop()


def init_from_env() -> None:
    """HOROVOD_TIMELINE=path starts the timeline at ``init`` (and
    ``shutdown`` stops it); =DYNAMIC waits for :func:`start_timeline`
    (ref operations.cc:546-560)."""
    cfg = knobs.get("HOROVOD_TIMELINE")
    if cfg and cfg != "DYNAMIC" and not _timeline.active:
        _timeline.start(cfg)
        _timeline.from_env = True


def stop_if_from_env() -> None:
    """``shutdown``'s end of a timeline that ``init`` started."""
    if _timeline.from_env:
        _timeline.stop()
