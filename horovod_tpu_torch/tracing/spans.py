"""Span recording: the distributed-tracing core.

One process-global ring buffer of completed spans (a bounded
``collections.deque`` — appends are GIL-atomic, the oldest spans fall off
at capacity, so a long run's recorder is O(HOROVOD_TRACE_BUFFER_SPANS)
memory forever). Every span carries the run's trace id, its own span id,
and the id of the span that was open on the same thread when it started
(parent links — the causal chain negotiate → fuse → dispatch → wait is a
tree, not a flat list).

The OFF path is the contract: ``span()`` with ``HOROVOD_TRACE=0`` returns
a module-level no-op context-manager singleton — no object, dict, or
tuple is allocated, and the only cost is one attribute read and one
``is-falsy`` branch (benchmarked in tests/test_tracing.py). Call sites on
per-entry hot paths should guard attribute-dict construction with
``enabled()``.

Timestamps are ``time.perf_counter()`` microseconds relative to a
process epoch captured at ``enable()``; the epoch's wall-clock value
(``epoch_unix``) travels with every export so a cross-rank merge
(``tracing/merge.py``) can shift processes onto one timeline.

The port's copy of ``horovod_tpu/tracing/spans.py``: the same span names,
categories, ring buffer, Chrome-trace export and flight recording.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import time
from collections import Counter, deque
from typing import Any, Dict, List, Optional

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.tracing")

# Span categories used by the built-in instrumentation (free-form strings;
# these constants exist so the classifier/tests and docs agree on names).
CAT_COORDINATOR = "coordinator"
CAT_WAIT = "wait"
CAT_CHECKPOINT = "checkpoint"
CAT_PREEMPTION = "preemption"
CAT_ELASTIC = "elastic"
CAT_DATA = "data"
CAT_TRAIN = "train"
CAT_TIMELINE = "timeline"


class _State:
    """Mutable recorder state. ``enabled`` is read unlocked on the hot
    path (a GIL-atomic bool); everything else is touched under ``lock``
    or is itself atomic (deque.append, itertools.count)."""

    __slots__ = ("enabled", "buffer", "capacity", "trace_id", "epoch_perf",
                 "epoch_unix", "lock", "open_async", "open_spans",
                 "dropped")

    def __init__(self):
        self.enabled = False
        self.capacity = 0
        self.buffer: "deque" = deque(maxlen=1)
        self.trace_id = ""
        self.epoch_perf = time.perf_counter()
        self.epoch_unix = time.time()
        self.lock = threading.Lock()
        # (name, cat) -> (start_us, span_id, parent_id): cross-thread
        # begin/end pairs (the timeline's QUEUE phase starts on the
        # enqueuing thread and ends on the cycle thread).
        self.open_async: Dict[Any, Any] = {}
        # span_id -> (name, cat, start_us, tid, parent_id, attrs) for
        # spans currently inside their `with` body — the flight
        # recording must ship the STUCK operation, which by definition
        # has not exited yet (GIL-atomic dict set/pop, no lock).
        self.open_spans: Dict[int, Any] = {}
        self.dropped = 0


_state = _State()
_span_ids = itertools.count(1)
_tls = threading.local()


def _now_us() -> float:
    return (time.perf_counter() - _state.epoch_perf) * 1e6


def enabled() -> bool:
    """Whether spans are currently being recorded (hot-path guard for
    attribute-dict construction at call sites)."""
    return _state.enabled


def enable(buffer_spans: Optional[int] = None,
           trace_id: Optional[str] = None) -> None:
    """Turn the recorder on (idempotent). A fresh trace id is minted
    unless one is passed (the launcher can export a shared id so every
    host's spans join one logical trace)."""
    with _state.lock:
        if _state.enabled:
            return
        cap = int(buffer_spans
                  if buffer_spans is not None
                  else knobs.get("HOROVOD_TRACE_BUFFER_SPANS"))
        cap = max(cap, 16)
        _state.capacity = cap
        _state.buffer = deque(maxlen=cap)
        _state.trace_id = trace_id or os.urandom(8).hex()
        _state.epoch_perf = time.perf_counter()
        _state.epoch_unix = time.time()
        _state.open_async.clear()
        _state.open_spans.clear()
        _state.dropped = 0
        _state.enabled = True
    logger.info("tracing enabled (trace_id=%s, ring buffer=%d spans)",
                _state.trace_id, cap)


def disable() -> None:
    with _state.lock:
        _state.enabled = False


def reset() -> None:
    """Drop recorded spans and disable (test isolation)."""
    with _state.lock:
        _state.enabled = False
        _state.buffer = deque(maxlen=max(_state.capacity, 1) or 1)
        _state.open_async.clear()
        _state.open_spans.clear()


def init_from_env() -> None:
    """HOROVOD_TRACE=1 enables the recorder at ``init()``. HVD_TRACE_ID
    (set by the launcher) joins every rank's spans into one logical
    trace."""
    if knobs.get("HOROVOD_TRACE"):
        enable(trace_id=os.environ.get("HVD_TRACE_ID"))


def trace_id() -> str:
    return _state.trace_id


def epoch_unix() -> float:
    """Wall-clock value of the perf epoch spans are relative to."""
    return _state.epoch_unix


class _NoopSpan:
    """The OFF path: one shared instance, allocation-free enter/exit."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """A live span: records (start, duration, parent) into the ring
    buffer at exit. Allocated only when tracing is enabled."""

    __slots__ = ("name", "cat", "attrs", "_t0", "_id", "_parent")

    def __init__(self, name: str, cat: str, attrs: Optional[Dict]):
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def __enter__(self):
        self._t0 = _now_us()
        self._id = next(_span_ids)
        self._parent = getattr(_tls, "span_id", 0)
        _tls.span_id = self._id
        _state.open_spans[self._id] = (
            self.name, self.cat, self._t0, threading.get_ident(),
            self._parent, self.attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        _tls.span_id = self._parent
        _state.open_spans.pop(self._id, None)
        record(self.name, self.cat, self._t0, _now_us() - self._t0,
               attrs=self.attrs, span_id=self._id, parent_id=self._parent)
        return False


def span(name: str, cat: str = "runtime",
         attrs: Optional[Dict] = None):
    """``with trace.span("coordinator.cycle", cat=..., attrs={...}):`` —
    the instrumentation primitive. Returns the shared no-op when tracing
    is off (zero allocation; see module docstring). A span measures host
    wall time: on the card it covers what the host waited for, not the
    kernels still queued behind it."""
    if not _state.enabled:
        return _NOOP
    return _Span(name, cat, attrs)


def record(name: str, cat: str, start_us: float, dur_us: float,
           attrs: Optional[Dict] = None, span_id: Optional[int] = None,
           parent_id: int = 0, tid: Optional[int] = None) -> None:
    """Append one completed span (used by _Span and by adapters that
    already measured elsewhere — e.g. the timeline mirror)."""
    if not _state.enabled:
        return
    buf = _state.buffer
    if len(buf) >= _state.capacity:
        # maxlen discards the oldest silently; count it so summary()'s
        # `dropped` is honest (racy += may undercount — diagnostic only).
        _state.dropped += 1
    buf.append((
        name, cat, float(start_us), float(dur_us),
        tid if tid is not None else threading.get_ident(),
        span_id if span_id is not None else next(_span_ids),
        parent_id, attrs or None))


def instant(name: str, cat: str = "runtime",
            attrs: Optional[Dict] = None) -> None:
    """Zero-duration marker."""
    if not _state.enabled:
        return
    record(name, cat, _now_us(), 0.0, attrs=attrs)


# -- cross-thread begin/end pairs (timeline QUEUE/NEGOTIATE mirroring) ------

def begin_async(name: str, cat: str) -> None:
    if not _state.enabled:
        return
    with _state.lock:
        _state.open_async[(name, cat)] = (
            _now_us(), next(_span_ids), getattr(_tls, "span_id", 0))


def end_async(name: str, cat: str, attrs: Optional[Dict] = None) -> None:
    if not _state.enabled:
        return
    with _state.lock:
        opened = _state.open_async.pop((name, cat), None)
    if opened is None:
        return
    t0, sid, parent = opened
    record(name, cat, t0, _now_us() - t0, attrs=attrs, span_id=sid,
           parent_id=parent)


# -- reads / export ---------------------------------------------------------

def _buffer_copy() -> List[Any]:
    """Copy the ring buffer while other threads may be appending.
    ``list(deque)`` is a single C call (GIL held throughout in CPython),
    but that is an implementation detail — retry on the RuntimeError a
    mutated-during-iteration deque would raise elsewhere."""
    for _ in range(8):
        try:
            return list(_state.buffer)
        except RuntimeError:
            continue
    return []


def snapshot() -> List[Dict[str, Any]]:
    """The ring buffer as plain dicts (oldest first)."""
    rows = []
    for name, cat, ts, dur, tid, sid, parent, attrs in _buffer_copy():
        row = {"name": name, "cat": cat, "ts_us": ts, "dur_us": dur,
               "tid": tid, "span_id": sid, "parent_id": parent}
        if attrs:
            row["attrs"] = attrs
        rows.append(row)
    return rows


def open_span_rows() -> List[Dict[str, Any]]:
    """Spans currently in flight (``with`` bodies not yet exited and
    unmatched ``begin_async`` pairs) as snapshot-shaped rows, duration
    measured up to now and tagged ``in_flight`` — the part of a flight
    recording that explains a stall."""
    now = _now_us()
    rows: List[Dict[str, Any]] = []
    for sid, (name, cat, t0, tid, parent, attrs) in list(
            _state.open_spans.items()):
        a = dict(attrs or {})
        a["in_flight"] = True
        rows.append({"name": name, "cat": cat, "ts_us": t0,
                     "dur_us": now - t0, "tid": tid, "span_id": sid,
                     "parent_id": parent, "attrs": a})
    with _state.lock:
        open_async = list(_state.open_async.items())
    for (name, cat), (t0, sid, parent) in open_async:
        rows.append({"name": name, "cat": cat, "ts_us": t0,
                     "dur_us": now - t0, "tid": 0, "span_id": sid,
                     "parent_id": parent, "attrs": {"in_flight": True}})
    return rows


def span_counts() -> Dict[str, int]:
    """Span count per category (the TRACE.json / CI-smoke summary)."""
    return dict(Counter(s[1] for s in _buffer_copy()))


def summary(process_index: int = 0) -> Dict[str, Any]:
    """Everything a peer needs to merge this process's spans onto its
    own timeline: spans + the perf-epoch's wall-clock anchor."""
    return {
        "process_index": int(process_index),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "trace_id": _state.trace_id,
        "epoch_unix": _state.epoch_unix,
        "dropped": int(_state.dropped),
        "spans": snapshot(),
    }


def chrome_events(spans: List[Dict[str, Any]], pid: int = 0,
                  shift_us: float = 0.0,
                  trace_id_: str = "") -> List[Dict[str, Any]]:
    """Chrome trace-events (complete ``ph:"X"`` form) for a span list."""
    evs: List[Dict[str, Any]] = []
    for s in spans:
        args = dict(s.get("attrs") or {})
        args["span_id"] = s["span_id"]
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        if trace_id_:
            args["trace_id"] = trace_id_
        evs.append({"ph": "X", "name": s["name"], "cat": s["cat"],
                    "pid": pid, "tid": s["tid"],
                    "ts": s["ts_us"] + shift_us, "dur": s["dur_us"],
                    "args": args})
    return evs


def write_chrome_trace(path: str,
                       events: List[Dict[str, Any]],
                       metadata: Optional[Dict[str, Any]] = None) -> str:
    """Atomic Chrome-trace/Perfetto JSON write (tmp + rename — a scraper
    or a crashed exporter can never leave a torn file)."""
    payload = {"displayTimeUnit": "ms",
               "metadata": metadata or {},
               "traceEvents": events}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def export_chrome_trace(path: str, process_index: int = 0) -> str:
    """Export the local ring buffer as one Perfetto-loadable trace file
    (process/track metadata included)."""
    evs: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": process_index,
         "args": {"name": f"host{process_index} "
                          f"({socket.gethostname()})"}}]
    evs += chrome_events(snapshot(), pid=process_index,
                         trace_id_=_state.trace_id)
    return write_chrome_trace(
        path, evs, metadata={"trace_id": _state.trace_id,
                             "epoch_unix": _state.epoch_unix})


def trace_dir() -> str:
    """Directory for trace artifacts (flight recordings, exports):
    HOROVOD_TRACE_DIR, defaulting to ``.hvdtrace`` under CWD."""
    return knobs.get("HOROVOD_TRACE_DIR") or ".hvdtrace"


def dump_flight_recording(reason: str,
                          directory: Optional[str] = None) -> Optional[str]:
    """Write the last-N spans ring buffer to the trace dir — called from
    the stall-inspector abort and preemption paths so every stall/abort
    ships its own flight recording. Returns the path, or None when
    tracing never recorded anything (nothing to ship). Never raises:
    this runs on failure paths that must stay failable-safe."""
    try:
        spans_ = snapshot() + open_span_rows()
        if not spans_:
            return None
        d = directory or trace_dir()
        os.makedirs(d, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:64]
        path = os.path.join(
            d, f"flight-{safe}-pid{os.getpid()}.trace.json")
        evs: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": 0,
             "args": {"name": socket.gethostname()}}]
        evs += chrome_events(spans_, trace_id_=_state.trace_id)
        write_chrome_trace(path, evs, metadata={
            "reason": reason, "trace_id": _state.trace_id,
            "epoch_unix": _state.epoch_unix, "wall_time": time.time()})
        from horovod_tpu_torch import metrics as M
        M.counter("hvd_trace_flight_dumps_total",
                  "Flight recordings written on stall/abort paths").inc()
        logger.warning("flight recording (%s): %d spans -> %s",
                       reason, len(spans_), path)
        return path
    except Exception:
        logger.warning("flight recording for %r failed", reason,
                       exc_info=True)
        return None
