"""Metrics registry and Prometheus text export.

The port's copy of the registry part of ``horovod_tpu/metrics.py``
(l.59-530): one thread-safe registry of labelled counters, gauges and
fixed-bucket histograms (stdlib only), the snapshot the public
``metrics_snapshot()`` returns, the Prometheus text exposition
(``render_snapshot``) and the cross-process merge (``merge_snapshots``).
The names and semantics are the JAX package's, so one dashboard reads
both.

Not ported yet (ROADMAP A.13b): the HTTP server with ``/metrics`` and
``/healthz``, the periodic JSON dumper and the cross-rank aggregator.
"""

from __future__ import annotations

import json
import math
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.metrics")

# Default histogram buckets (seconds) — spans sub-ms fused dispatches to
# multi-second stalls, the range the cycle/wait paths actually produce.
DURATION_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Count buckets (bins per cycle and the like).
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
# Serving-latency buckets (seconds) for TTFT and TPOT: DURATION_BUCKETS
# has one edge below 1 ms, which would put a decode step's tens of
# microseconds to milliseconds in one bar; five sub-ms edges keep a p99
# readable down to 50 us.
LATENCY_BUCKETS = (0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                   0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render as integers so
    counters read naturally; everything else keeps full float repr."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f.is_integer() and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(labels[k])}"'
                     for k in sorted(labels))
    return "{" + inner + "}"


class _Child:
    """One labelled series of a metric (or the metric itself when it has
    no labels). Holds the actual values under the parent's lock."""

    __slots__ = ("labels", "value", "bucket_counts", "sum", "count")

    def __init__(self, labels: Dict[str, str], n_buckets: int):
        self.labels = labels
        self.value = 0.0
        # histogram state (unused for counter/gauge)
        self.bucket_counts = [0] * (n_buckets + 1)   # + the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Metric:
    """A named metric family: kind ∈ {counter, gauge, histogram}, fixed
    label names, one `_Child` per distinct label-value tuple. All methods
    are thread-safe (one lock per family — contention is negligible at the
    rates the runtime produces)."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Tuple[str, ...] = (),
                 buckets: Optional[Sequence[float]] = None,
                 aggregation: str = "sum"):
        self.name = name
        self.help = help
        self.kind = kind
        # Cross-process merge rule for gauges: 'sum' for additive state
        # (queued bytes, outstanding handles), 'leader' for per-process
        # state that must not be added up (knob values, converged flags) —
        # the leader's own value wins in the aggregated view.
        self.aggregation = aggregation
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets)) if kind == "histogram" else ()
        self._lock = threading.Lock()
        self._children: "OrderedDict[Tuple[str, ...], _Child]" = OrderedDict()
        self._fn: Optional[Callable[[], float]] = None   # gauge callback
        if not self.labelnames:
            self._default = self._child(())
        else:
            self._default = None

    def _child(self, key: Tuple[str, ...]) -> _Child:
        with self._lock:
            c = self._children.get(key)
            if c is None:
                c = _Child(dict(zip(self.labelnames, key)),
                           len(self.buckets))
                self._children[key] = c
            return c

    def labels(self, **kw) -> "_BoundMetric":
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kw)} do not match declared "
                f"labelnames {sorted(self.labelnames)}")
        key = tuple(str(kw[n]) for n in self.labelnames)
        return _BoundMetric(self, self._child(key))

    # -- unlabelled fast path ------------------------------------------------
    def _require_default(self) -> _Child:
        if self._default is None:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()")
        return self._default

    def inc(self, n: float = 1.0) -> None:
        _BoundMetric(self, self._require_default()).inc(n)

    def dec(self, n: float = 1.0) -> None:
        _BoundMetric(self, self._require_default()).dec(n)

    def set(self, v: float) -> None:
        _BoundMetric(self, self._require_default()).set(v)

    def observe(self, v: float) -> None:
        _BoundMetric(self, self._require_default()).observe(v)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Gauge evaluated lazily at snapshot time (collector gauges)."""
        if self.kind != "gauge":
            raise ValueError(f"{self.name}: set_function is gauge-only")
        self._fn = fn

    # -- reads ---------------------------------------------------------------
    @property
    def value(self) -> float:
        """Unlabelled counter/gauge value (labelled families: sum)."""
        with self._lock:
            return sum(c.value for c in self._children.values())

    @property
    def total_sum(self) -> float:
        """Histogram: total of observed values across all series."""
        with self._lock:
            return sum(c.sum for c in self._children.values())

    @property
    def total_count(self) -> int:
        with self._lock:
            return sum(c.count for c in self._children.values())

    def quantile(self, q: float) -> Optional[float]:
        """Approximate quantile from bucket counts (linear interpolation
        within the containing bucket; None when empty). Aggregates every
        labelled series — good enough for the bench summary, not a
        replacement for server-side histogram_quantile."""
        with self._lock:
            counts = [0] * (len(self.buckets) + 1)
            for c in self._children.values():
                for i, n in enumerate(c.bucket_counts):
                    counts[i] += n
        total = sum(counts)
        if not total:
            return None
        target = q * total
        acc = 0.0
        lo = 0.0
        for i, n in enumerate(counts):
            hi = self.buckets[i] if i < len(self.buckets) else lo
            if acc + n >= target and n:
                if i >= len(self.buckets):    # +Inf bucket: clamp to edge
                    return lo
                return lo + (hi - lo) * (target - acc) / n
            acc += n
            lo = hi
        return lo


class _BoundMetric:
    """A (metric, child) pair — what `.labels(...)` returns."""

    __slots__ = ("_m", "_c")

    def __init__(self, metric: Metric, child: _Child):
        self._m = metric
        self._c = child

    def inc(self, n: float = 1.0) -> None:
        if self._m.kind not in ("counter", "gauge"):
            raise ValueError(f"{self._m.name}: inc on {self._m.kind}")
        if self._m.kind == "counter" and n < 0:
            raise ValueError(f"{self._m.name}: counters only go up")
        with self._m._lock:
            self._c.value += n

    def dec(self, n: float = 1.0) -> None:
        if self._m.kind != "gauge":
            raise ValueError(f"{self._m.name}: dec on {self._m.kind}")
        with self._m._lock:
            self._c.value -= n

    def set(self, v: float) -> None:
        if self._m.kind != "gauge":
            raise ValueError(f"{self._m.name}: set on {self._m.kind}")
        with self._m._lock:
            self._c.value = float(v)

    def observe(self, v: float) -> None:
        if self._m.kind != "histogram":
            raise ValueError(f"{self._m.name}: observe on {self._m.kind}")
        v = float(v)
        with self._m._lock:
            for i, ub in enumerate(self._m.buckets):
                if v <= ub:
                    self._c.bucket_counts[i] += 1
                    break
            else:
                self._c.bucket_counts[-1] += 1
            self._c.sum += v
            self._c.count += 1

    @property
    def value(self) -> float:
        with self._m._lock:
            return self._c.value


class MetricsRegistry:
    """Process-wide metric store: get-or-create families by name, run
    registered collectors, snapshot to plain dicts, render Prometheus
    exposition text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "OrderedDict[str, Metric]" = OrderedDict()
        self._collectors: List[Callable[[], None]] = []

    # -- creation (idempotent by name) ---------------------------------------
    def _get_or_create(self, name: str, help: str, kind: str,
                       labelnames: Tuple[str, ...],
                       buckets: Optional[Sequence[float]] = None,
                       aggregation: str = "sum") -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} re-registered as {kind}"
                        f"{labelnames} but exists as {m.kind}"
                        f"{m.labelnames}")
                if kind == "histogram" and buckets is not None \
                        and tuple(sorted(buckets)) != m.buckets:
                    raise ValueError(
                        f"histogram {name} re-registered with buckets "
                        f"{tuple(sorted(buckets))} but exists with "
                        f"{m.buckets}")
                if kind == "gauge" and aggregation != m.aggregation:
                    raise ValueError(
                        f"gauge {name} re-registered with aggregation "
                        f"{aggregation!r} but exists with "
                        f"{m.aggregation!r}")
                return m
            m = Metric(name, help, kind, labelnames, buckets, aggregation)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Metric:
        return self._get_or_create(name, help, "counter", tuple(labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (),
              aggregation: str = "sum") -> Metric:
        return self._get_or_create(name, help, "gauge", tuple(labelnames),
                                   aggregation=aggregation)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DURATION_BUCKETS) -> Metric:
        return self._get_or_create(name, help, "histogram",
                                   tuple(labelnames), buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """Run before each snapshot/render — for state read lazily at
        scrape time (queue depth, cache counters, outstanding handles)."""
        with self._lock:
            self._collectors.append(fn)

    # -- snapshot / render ---------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict snapshot (JSON-able): the ``metrics_snapshot()``
        payload and the unit the cluster aggregator merges."""
        for fn in list(self._collectors):
            try:
                fn()
            except Exception:       # a broken collector must not kill scrapes
                logger.exception("metrics collector failed")
        out: Dict[str, Any] = OrderedDict()
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            series = []
            # Copy child values UNDER the family lock: a lock-free read
            # racing a concurrent observe() could serialize a histogram
            # whose count includes an observation its buckets/sum miss —
            # the same torn-triple problem ExecutableCache.snapshot()
            # exists to prevent.
            with m._lock:
                fn = m._fn
                children = [
                    (dict(c.labels), list(c.bucket_counts), c.sum, c.count,
                     c.value)
                    for c in m._children.values()]
            if fn is not None and not children:
                children = [({}, [], 0.0, 0, 0.0)]
            for labels, bucket_counts, hsum, hcount, value in children:
                row: Dict[str, Any] = {"labels": labels}
                if m.kind == "histogram":
                    bounds = [_fmt(b) for b in m.buckets] + ["+Inf"]
                    row["buckets"] = OrderedDict(zip(bounds, bucket_counts))
                    row["sum"] = hsum
                    row["count"] = hcount
                else:
                    v = value
                    if fn is not None:
                        try:
                            v = float(fn())
                        except Exception:
                            logger.exception("gauge %s callback failed",
                                             m.name)
                    row["value"] = v
                series.append(row)
            fam = {"kind": m.kind, "help": m.help, "series": series}
            if m.kind == "gauge" and m.aggregation != "sum":
                fam["agg"] = m.aggregation
            out[m.name] = fam
        return out

    def render(self) -> str:
        return render_snapshot(self.snapshot())


def render_snapshot(snapshot: Dict[str, Any]) -> str:
    """Prometheus text exposition (format version 0.0.4) from a snapshot
    dict — shared by the local scrape and the leader's merged scrape."""
    lines: List[str] = []
    for name, fam in snapshot.items():
        if not isinstance(fam, dict) or "kind" not in fam:
            continue      # non-family block (e.g. 'goodput'): JSON-only
        lines.append(f"# HELP {name} {_escape_help(fam.get('help', ''))}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for row in fam["series"]:
            labels = row.get("labels", {})
            if fam["kind"] == "histogram":
                cum = 0
                for ub, n in row["buckets"].items():
                    cum += n
                    ls = dict(labels)
                    ls["le"] = ub
                    lines.append(f"{name}_bucket{_label_str(ls)} {cum}")
                lines.append(
                    f"{name}_sum{_label_str(labels)} {_fmt(row['sum'])}")
                lines.append(
                    f"{name}_count{_label_str(labels)} {row['count']}")
            else:
                lines.append(
                    f"{name}{_label_str(labels)} {_fmt(row['value'])}")
    return "\n".join(lines) + "\n"


def merge_snapshots(snaps: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Cluster-wide sums: counters/gauges add values, histograms add
    per-bucket counts + sum/count, series matched by (name, labels)."""
    out: Dict[str, Any] = OrderedDict()
    for snap in snaps:
        for name, fam in snap.items():
            if not isinstance(fam, dict) or "kind" not in fam:
                continue  # non-family block (e.g. 'goodput'): per-process
            tgt = out.setdefault(name, {"kind": fam["kind"],
                                        "help": fam.get("help", ""),
                                        "series": []})
            if tgt["kind"] != fam["kind"]:     # mismatched peer: skip
                continue
            if fam.get("agg") == "leader":
                # Per-process state (knob values, converged flags): the
                # first snapshot — the leader's own — wins; adding them
                # up would report N-times-inflated settings.
                tgt.setdefault("agg", "leader")
                if tgt["series"]:
                    continue
                tgt["series"] = [dict(r, labels=dict(r.get("labels", {})))
                                 for r in fam["series"]]
                continue
            index = {json.dumps(r.get("labels", {}), sort_keys=True): r
                     for r in tgt["series"]}
            for row in fam["series"]:
                key = json.dumps(row.get("labels", {}), sort_keys=True)
                cur = index.get(key)
                if cur is None:
                    copy = {"labels": dict(row.get("labels", {}))}
                    if fam["kind"] == "histogram":
                        copy["buckets"] = OrderedDict(row["buckets"])
                        copy["sum"] = row["sum"]
                        copy["count"] = row["count"]
                    else:
                        copy["value"] = row["value"]
                    tgt["series"].append(copy)
                    index[key] = copy
                elif fam["kind"] == "histogram":
                    for ub, n in row["buckets"].items():
                        cur["buckets"][ub] = cur["buckets"].get(ub, 0) + n
                    cur["sum"] += row["sum"]
                    cur["count"] += row["count"]
                else:
                    cur["value"] += row["value"]
    return out


# ---------------------------------------------------------------------------
# the process-global registry + shortcut constructors
# ---------------------------------------------------------------------------

_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Metric:
    return _registry.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = (),
          aggregation: str = "sum") -> Metric:
    return _registry.gauge(name, help, labelnames, aggregation=aggregation)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DURATION_BUCKETS) -> Metric:
    return _registry.histogram(name, help, labelnames, buckets)


def metrics_snapshot(aggregate: bool = False) -> Dict[str, Any]:
    """Public snapshot API: every registered metric's current value as
    plain dicts, plus the ``goodput`` block while the accountant runs.
    ``aggregate`` is accepted for the JAX package's signature; the
    cross-rank aggregator waits for ROADMAP A.13b, so the snapshot is this
    process's alone."""
    snap = _registry.snapshot()
    from horovod_tpu_torch.goodput import accountant as _goodput
    if _goodput.enabled():
        snap["goodput"] = _goodput.goodput_report()
    return snap


def _counter_value(name: str) -> float:
    m = _registry.get(name)
    return m.value if m is not None else 0.0


def _hist_sum(name: str) -> float:
    m = _registry.get(name)
    return m.total_sum if m is not None else 0.0


def runtime_totals() -> Dict[str, float]:
    """Running totals the StepStats accumulator (callbacks.py) diffs per
    step: bytes through the eager coordinator's fused dispatch
    (``hvd_bytes_reduced_total``) and seconds the caller spent blocked on
    collectives (the ``hvd_handle_wait_seconds`` that the eager API's
    handles observe in ``wait``)."""
    return {
        "bytes_reduced": _counter_value("hvd_bytes_reduced_total"),
        "collective_seconds": _hist_sum("hvd_handle_wait_seconds"),
    }


# ---------------------------------------------------------------------------
# default collectors: state read at scrape time
# ---------------------------------------------------------------------------

_default_collectors_installed = False
_install_lock = threading.Lock()


def _install_default_collectors() -> None:
    """The gauges read when the metrics are scraped (``init`` installs
    them once): the coordinator's queued bytes."""
    global _default_collectors_installed
    with _install_lock:
        if _default_collectors_installed:
            return
        _default_collectors_installed = True

    g_queued = gauge(
        "hvd_queued_bytes",
        "Bytes waiting in the coordinator's tensor queue for the next "
        "cycle (world x one rank's; allgathers and alltoalls left out)")

    def _collect_queued():
        from horovod_tpu_torch.runtime import context as _ctx_mod
        ctx = _ctx_mod._context
        coord = getattr(ctx, "coordinator", None) if ctx is not None \
            else None
        g_queued.set(coord.queue.queued_bytes() if coord is not None else 0)

    _registry.register_collector(_collect_queued)
