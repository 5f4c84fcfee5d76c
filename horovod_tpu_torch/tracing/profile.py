"""Device-profile attribution: observed overlap, exposed collectives,
per-bucket device time.

The counterpart of ``horovod_tpu/tracing/profile.py``. A
``torch.profiler`` capture window is recorded programmatically
(``HOROVOD_TRACE_PROFILE=steps:N[@S]`` in ``train_loop``, or a
:class:`StepProfiler` driven by hand), the Chrome trace it exports is
parsed with a stdlib-only reader (gzip + json), device ops are classified
collective vs compute, and the interval algebra below turns them into:

- ``observed_overlap_ratio``: the share of collective device time with
  compute running at the same time (union-interval intersection);
- ``exposed_collective_seconds``: collective time with no compute beside
  it (what the communication costs the step);
- per-bucket device seconds: ``parallel/distributed.py`` launches each
  gradient bucket inside ``record_function("hvd_bucket<i>")`` (the
  two-level tier's stages inside ``hvd_bucket<i>_rs`` / ``_xdcn`` /
  ``_ag``), and each device op takes the innermost such label around the
  host call that launched it.

Which events are device ops:

- on the card, the ``kernel`` events (and memcpy / memset); collectives
  are the NCCL kernels (``ncclDevKernel_*``, ``ncclKernel_*``). A kernel
  finds its launching host call through the runtime event with its
  ``correlation`` id; the bucket label is the innermost
  ``user_annotation`` around that call on the same thread (the buckets
  launch from autograd hooks and NCCL runs on its own stream, so nesting
  in device time alone would not do). Only a kernel whose launch is not
  in the trace takes the ``gpu_user_annotation`` ranges of its own
  stream; the attribution counts those (``unlaunched_device_events``).
- in the CPU's reading (the tests): the aten ``cpu_op`` events, with the
  c10d ops and gloo's work as collectives, as the JAX reader counts
  XLA:CPU thunks as device events on the CPU. Their labels come from
  the enclosing annotations the same way.

A :class:`StepProfiler` that traced CUDA activity reads the device
events only, and its attribution says which reading it took
(``device``): a card window that came back without kernel events gives
no overlap or exposed-collective numbers rather than the host's.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.tracing")

# Collective device ops: NCCL's kernels on the card; c10d's ops and
# gloo's work (a user_annotation on gloo's thread) on the CPU.
COLLECTIVE_RE = re.compile(r"nccl|^c10d::|^gloo:|record_param_comms",
                           re.IGNORECASE)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# Per-bucket labels, including the two-level tier's per-stage suffixes
# (hvd_bucket0_rs / _xdcn / _ag) and the epilogue-apply scope: each
# suffixed scope attributes separately.
_BUCKET_RE = re.compile(r"\bhvd_bucket\d+(?:_(?:rs|xdcn|ag|apply))?\b")


# ---------------------------------------------------------------------------
# stdlib-only trace-events reader
# ---------------------------------------------------------------------------

def find_trace_files(log_dir: str) -> List[str]:
    """The ``*.trace.json(.gz)`` files a :class:`StepProfiler` exported
    under ``log_dir``, newest last."""
    found = (glob.glob(os.path.join(log_dir, "*.trace.json.gz"))
             + glob.glob(os.path.join(log_dir, "*.trace.json")))
    return sorted(found, key=os.path.getmtime)


def read_trace_events(path: str) -> List[Dict[str, Any]]:
    """Parse one Chrome trace-events file (plain or gzipped) into its
    event list."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = json.loads(f.read().decode("utf-8", errors="replace"))
    if isinstance(data, dict):
        return list(data.get("traceEvents", []))
    return list(data)


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def _complete(e: Dict[str, Any]) -> bool:
    return e.get("ph") == "X" and "dur" in e and "ts" in e


def on_device(events: Iterable[Dict[str, Any]]) -> bool:
    """Whether the trace carries device (kernel) events."""
    return any(_complete(e) and e.get("cat") in _DEVICE_CATS
               for e in events)


def device_op_events(events: Iterable[Dict[str, Any]],
                     device: Optional[bool] = None
                     ) -> List[Dict[str, Any]]:
    """The complete events that are device-op executions: the kernel,
    memcpy and memset events of a card trace, or, in a trace with none
    (``device`` False), the aten ops and collectives of the CPU."""
    events = list(events)
    if device is None:
        device = on_device(events)
    out = []
    for e in events:
        if not _complete(e):
            continue
        cat, name = e.get("cat"), str(e.get("name", ""))
        if device:
            if cat in _DEVICE_CATS:
                out.append(e)
        elif (cat == "cpu_op" and (name.startswith("aten::")
                                   or COLLECTIVE_RE.search(name))) or \
                (cat == "user_annotation" and name.startswith("gloo:")):
            out.append(e)
    return out


def classify(events: Iterable[Dict[str, Any]],
             device: Optional[bool] = None
             ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """(collective_events, compute_events) among device-op events;
    memcpy and memset count as neither."""
    coll, comp = [], []
    for e in device_op_events(events, device):
        if COLLECTIVE_RE.search(str(e["name"])):
            coll.append(e)
        elif e.get("cat") not in ("gpu_memcpy", "gpu_memset"):
            comp.append(e)
    return coll, comp


# ---------------------------------------------------------------------------
# interval algebra
# ---------------------------------------------------------------------------

def _union(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _total(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(hi - lo for lo, hi in intervals)


def _intersection(a: Sequence[Tuple[float, float]],
                  b: Sequence[Tuple[float, float]]) -> float:
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _spans_of(events: Iterable[Dict[str, Any]]
              ) -> List[Tuple[float, float]]:
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events]


# ---------------------------------------------------------------------------
# labels: the annotation around the host call that launched a device op
# ---------------------------------------------------------------------------

class _Labeler:
    """Finds, for a device op, the innermost annotation matching
    ``pattern`` around the host call that launched it."""

    def __init__(self, events: List[Dict[str, Any]], pattern):
        self.pattern = pattern
        self.launch: Dict[Any, Tuple[Any, Any, float]] = {}
        self.unlaunched = 0
        ranges: Dict[Tuple[Any, Any], List[Tuple[float, float, str]]] = {}
        gpu: Dict[Tuple[Any, Any], List[Tuple[float, float, str]]] = {}
        for e in events:
            if not _complete(e):
                continue
            cat, args = e.get("cat"), e.get("args") or {}
            where = (e.get("pid"), e.get("tid"))
            ts = float(e["ts"])
            if cat in _LAUNCH_CATS and "correlation" in args:
                self.launch[args["correlation"]] = where + (ts,)
            if cat in ("user_annotation", "gpu_user_annotation"):
                m = pattern.search(str(e.get("name", "")))
                if m:
                    span = (ts, ts + float(e["dur"]), m.group(0))
                    (gpu if cat == "gpu_user_annotation"
                     else ranges).setdefault(where, []).append(span)
        self.ranges = {k: self._index(v) for k, v in ranges.items()}
        self.gpu = {k: self._index(v) for k, v in gpu.items()}

    @staticmethod
    def _index(spans):
        # by start, the outer of two ranges that start together first
        spans.sort(key=lambda s: (s[0], -s[1]))
        reach, far = [], float("-inf")
        for _, hi, _ in spans:
            far = max(far, hi)
            reach.append(far)
        return [s[0] for s in spans], spans, reach

    @staticmethod
    def _innermost(index, ts: float) -> Optional[str]:
        """The range with the latest start that holds ``ts`` (the
        innermost, ranges on one thread being nested)."""
        starts, spans, reach = index
        for k in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
            if reach[k] < ts:
                break                # no earlier range reaches ts
            lo, hi, name = spans[k]
            if lo <= ts <= hi:
                return name
        return None

    def label(self, e: Dict[str, Any]) -> Optional[str]:
        if e.get("cat") in _DEVICE_CATS:
            host = self.launch.get((e.get("args") or {}).get("correlation"))
            if host is None:
                # no launch in the trace: the ranges of its own stream
                self.unlaunched += 1
                index = self.gpu.get((e.get("pid"), e.get("tid")))
                return (None if index is None
                        else self._innermost(index, float(e["ts"])))
        else:
            host = (e.get("pid"), e.get("tid"), float(e["ts"]))
        index = self.ranges.get(host[:2])
        return None if index is None else self._innermost(index, host[2])


def _by_label(events: List[Dict[str, Any]], pattern,
              device: Optional[bool]
              ) -> Tuple[Dict[str, List[Dict[str, Any]]], int]:
    if isinstance(pattern, str):
        pattern = re.compile(pattern)
    labeler = _Labeler(events, pattern)
    out: Dict[str, List[Dict[str, Any]]] = {}
    for e in device_op_events(events, device):
        name = labeler.label(e)
        if name is not None:
            out.setdefault(name, []).append(e)
    return out, labeler.unlaunched


def device_events_by_label(events: Iterable[Dict[str, Any]], pattern,
                           device: Optional[bool] = None
                           ) -> Dict[str, List[Dict[str, Any]]]:
    """{label: device-op events} of the device ops launched inside an
    annotation whose name matches ``pattern`` (a regex or a string),
    labelled by the innermost one."""
    return _by_label(list(events), pattern, device)[0]


def device_seconds_by_label(events: Iterable[Dict[str, Any]], pattern,
                            device: Optional[bool] = None
                            ) -> Dict[str, float]:
    """{label: device seconds} of :func:`device_events_by_label`."""
    return {k: sum(float(e["dur"]) for e in v) / 1e6
            for k, v in device_events_by_label(events, pattern,
                                               device).items()}


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def attribute(events: Iterable[Dict[str, Any]], steps: int = 1,
              device: Optional[bool] = None) -> Dict[str, Any]:
    """The observed tier: overlap ratio, exposed-collective time, and
    per-bucket device durations (memcpy and memset included, which count
    as neither collective nor compute) from a raw trace-event list. The
    JAX package maps HLO instructions to buckets; here each op takes the
    annotation around its launch. ``device`` True reads the kernel
    events only (a trace without them gives no overlap or exposed
    numbers), False the CPU's, None whichever the trace carries; the
    result says which (``device``)."""
    events = list(events)
    if device is None:
        device = on_device(events)
    device = bool(device)
    coll, comp = classify(events, device)
    coll_u = _union(_spans_of(coll))
    comp_u = _union(_spans_of(comp))
    coll_s = _total(coll_u) / 1e6
    comp_s = _total(comp_u) / 1e6
    overlap_s = _intersection(coll_u, comp_u) / 1e6
    steps = max(int(steps), 1)
    # a bucket's copies are its device time too (a one-leaf bucket packs
    # with a memcpy)
    by_bucket, unlaunched = _by_label(events, _BUCKET_RE, device)
    per_bucket = [
        {"bucket": k,
         "device_seconds": round(
             sum(float(e["dur"]) for e in by_bucket[k]) / 1e6, 9),
         "events": len(by_bucket[k])}
        for k in sorted(by_bucket,
                        key=lambda s: int(re.sub(r"\D", "", s) or 0))]
    # a card trace without kernel events measured nothing
    seen = not device or on_device(events)
    exposed = coll_s - overlap_s
    return {
        "device": device,
        "device_op_events": len(coll) + len(comp),
        "collective_events": len(coll),
        "collective_seconds": round(coll_s, 9),
        "compute_seconds": round(comp_s, 9),
        "observed_overlap_ratio": (round(overlap_s / coll_s, 4)
                                   if coll_s > 0 else None),
        "exposed_collective_seconds": (round(exposed, 9) if seen
                                       else None),
        "exposed_collective_seconds_per_step": (
            round(exposed / steps, 9) if seen else None),
        "unlaunched_device_events": unlaunched,
        "profiled_steps": steps,
        "per_bucket": per_bucket,
    }


def bucket_collective_seconds(events: Iterable[Dict[str, Any]],
                              device: Optional[bool] = None
                              ) -> Dict[str, Tuple[float, float]]:
    """{bucket label: (collective device seconds, the part of them with
    compute running)}: the collectives launched inside each
    ``hvd_bucket<k>`` annotation, against every compute op of the trace
    (what ``autotune.sweep_bucket_bytes`` scores a bucket size by)."""
    events = list(events)
    if device is None:
        device = on_device(events)
    comp_u = _union(_spans_of(classify(events, device)[1]))
    out = {}
    for label, evs in _by_label(events, _BUCKET_RE, device)[0].items():
        coll_u = _union(_spans_of(
            e for e in evs if COLLECTIVE_RE.search(str(e["name"]))))
        out[label] = (_total(coll_u) / 1e6,
                      _intersection(coll_u, comp_u) / 1e6)
    return out


def publish_gauges(attribution: Dict[str, Any]) -> None:
    """Surface the observed tier on the metrics plane."""
    from horovod_tpu_torch import metrics as M
    ratio = attribution.get("observed_overlap_ratio")
    exposed = attribution.get("exposed_collective_seconds_per_step")
    if exposed is None:
        return                      # the window measured nothing
    if ratio is not None:
        M.gauge("hvd_overlap_observed_ratio",
                "Profile-measured fraction of collective device time "
                "with compute executing concurrently (tracing/profile "
                "attribution; -1 until a capture ran)",
                aggregation="leader").set(float(ratio))
    M.gauge("hvd_step_exposed_collective_seconds",
            "Profile-measured collective device time per step with NO "
            "concurrent compute (exposed communication)",
            aggregation="leader").set(float(exposed))


# ---------------------------------------------------------------------------
# programmatic capture (HOROVOD_TRACE_PROFILE=steps:N[@S])
# ---------------------------------------------------------------------------

def parse_profile_spec(spec: str) -> Optional[Tuple[int, int]]:
    """'steps:N' or 'steps:N@S' -> (n_steps, start_step); None when
    empty/disabled. Raises ValueError on a malformed spec (a silently
    ignored knob is worse than a crash at startup)."""
    s = (spec or "").strip()
    if not s or s == "0":
        return None
    m = re.fullmatch(r"steps:(\d+)(?:@(\d+))?", s)
    if not m:
        raise ValueError(
            f"HOROVOD_TRACE_PROFILE={spec!r}: expected 'steps:N' or "
            f"'steps:N@S' (capture N steps starting at step S)")
    n = int(m.group(1))
    start = int(m.group(2)) if m.group(2) else 2
    if n <= 0:
        return None
    return n, start


def _default_log_dir() -> str:
    from horovod_tpu_torch.runtime import context
    from horovod_tpu_torch.tracing import spans as _spans
    d = os.path.join(_spans.trace_dir(), "profile")
    if context.is_initialized() and context.size() > 1:
        d = os.path.join(d, f"rank{context.rank()}")
    return d


class StepProfiler:
    """Drives one ``torch.profiler`` capture window across training steps
    and turns it into the observed-attribution artifact and gauges.

    ``on_step_end(step)`` is the only hook the loop calls; the window
    opens when step ``start - 1`` ends and closes ``n`` steps later,
    writing the trace and ``profile_attribution.json`` into ``log_dir``
    (the trace dir's ``profile`` folder, a ``rank<r>`` folder of it in a
    world of several). CUDA activity is traced when the process uses
    the card. The profiler slows the steps it traces:
    ``window_step_seconds`` in the attribution are those steps' wall
    times, not the run's. One window per profiler."""

    def __init__(self, n_steps: int, start_step: int,
                 log_dir: Optional[str] = None):
        self.n_steps = int(n_steps)
        self.start_step = int(start_step)
        self.log_dir = log_dir or _default_log_dir()
        self.attribution: Optional[Dict[str, Any]] = None
        self.trace_path: Optional[str] = None
        self._prof = None
        self._active = False
        self._done = False
        self._first_profiled: Optional[int] = None
        self._device = False
        self._stamps: List[float] = []

    @classmethod
    def from_env(cls) -> Optional["StepProfiler"]:
        parsed = parse_profile_spec(knobs.get("HOROVOD_TRACE_PROFILE"))
        if parsed is None:
            return None
        n, start = parsed
        return cls(n, start)

    @staticmethod
    def _cuda() -> bool:
        import torch
        return torch.cuda.is_available() and torch.cuda.is_initialized()

    def on_step_end(self, step: int) -> None:
        if self._done:
            return
        # Open at the END of step S-1 so the window covers steps
        # S..S+N-1 as documented ('steps:N@S'). The hook only runs at
        # step ends, so capture can start no earlier than step 2.
        if not self._active and step >= self.start_step - 1:
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(self.log_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            self._device = self._cuda()
            if self._device:
                import torch
                torch.cuda.synchronize()
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._active = True
            self._first_profiled = step + 1
            self._stamps = [time.perf_counter()]
            logger.info("profile capture opened at step %d for %d "
                        "steps -> %s", step, self.n_steps, self.log_dir)
            return
        if self._active:
            self._stamps.append(time.perf_counter())
            if step >= self._first_profiled + self.n_steps - 1:
                self.stop()

    def stop(self) -> None:
        """Close the window and write the attribution (idempotent)."""
        if not self._active or self._done:
            self._done = True
            return
        self._active = False
        self._done = True
        try:
            if self._device:
                import torch
                torch.cuda.synchronize()
            self._prof.stop()
            path = os.path.join(
                self.log_dir, f"pid{os.getpid()}-{int(time.time())}"
                              f".trace.json")
            self._prof.export_chrome_trace(path)
            self.trace_path = path
            self._prof = None
            events = read_trace_events(path)
            steps = max(len(self._stamps) - 1, 1)
            # CUDA activity was asked for: the kernel events only
            self.attribution = attribute(events, steps=steps,
                                         device=self._device)
            if self._device and not on_device(events):
                logger.warning(
                    "profile window: the CUDA trace came back without "
                    "kernel events; no overlap or exposed-collective "
                    "numbers are written")
            self.attribution["window_step_seconds"] = [
                round(b - a, 9)
                for a, b in zip(self._stamps, self._stamps[1:])]
            self.attribution["trace_file"] = os.path.basename(path)
            publish_gauges(self.attribution)
            out = os.path.join(self.log_dir, "profile_attribution.json")
            with open(out + ".tmp", "w") as f:
                json.dump(self.attribution, f, indent=1)
            os.replace(out + ".tmp", out)
            logger.info(
                "profile attribution: overlap=%s exposed=%ss/step -> %s",
                self.attribution["observed_overlap_ratio"],
                self.attribution["exposed_collective_seconds_per_step"],
                out)
        except Exception:
            logger.warning("profile attribution failed", exc_info=True)
