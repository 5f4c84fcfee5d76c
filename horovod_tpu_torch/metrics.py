"""Metrics registry and its exports: Prometheus text, ``/healthz`` and
JSON.

The port's copy of ``horovod_tpu/metrics.py``: one thread-safe registry
of labelled counters, gauges and fixed-bucket histograms (stdlib only),
the snapshot the public ``metrics_snapshot()`` returns, the Prometheus
text exposition (``render_snapshot``) and the cross-process merge
(``merge_snapshots``), exported three ways:

- a background HTTP server (``HOROVOD_METRICS_PORT``, :class:`MetricsServer`)
  serving ``/metrics`` and a ``/healthz`` (:func:`health_snapshot`) with
  the stall, preemption, fault-domain, straggler, goodput, world, serving
  and fleet blocks;
- a periodic JSON dump (``HOROVOD_METRICS_DUMP``, :class:`SnapshotDumper`,
  atomic, every ``HOROVOD_METRICS_DUMP_INTERVAL`` seconds and at
  shutdown);
- the public ``metrics_snapshot()``.

In a world of several processes the ranks but 0 publish their snapshot
to the c10d store every ``HOROVOD_METRICS_AGG_INTERVAL`` seconds
(:class:`ClusterAggregator`, :class:`_Publisher`) and rank 0's
``/metrics`` serves the merged sums. ``init`` starts the exports the
knobs ask for (:func:`init_from_env`) and ``shutdown`` stops them
(:func:`stop_exports`). The names and semantics are the JAX package's,
so one dashboard reads both, the artifact store's ``/healthz`` block
included.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.config import knobs
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
    With ``aggregate=True`` on rank 0 of a world of several processes,
    the other ranks' published snapshots are merged in (what rank 0's
    ``/metrics`` serves)."""
    if aggregate and _aggregator is not None and _aggregator.is_leader:
        snap = _aggregator.merged_snapshot()
    else:
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
    them once): the stall inspector's outstanding handles and the
    coordinator's queued bytes."""
    global _default_collectors_installed
    with _install_lock:
        if _default_collectors_installed:
            return
        _default_collectors_installed = True

    g_outstanding = gauge(
        "hvd_outstanding_handles",
        "Async collective handles issued but not yet completed "
        "(stall-inspector tracked set)")

    def _collect_outstanding():
        from horovod_tpu_torch.stall_inspector import get_stall_inspector
        g_outstanding.set(get_stall_inspector().pending_count())

    _registry.register_collector(_collect_outstanding)

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


# ---------------------------------------------------------------------------
# topology-derived gauges: published at init and again at a resize commit,
# so "the world changed at step N" is an edge in the time series
# ---------------------------------------------------------------------------

def publish_topology_gauges() -> None:
    """(Re)publish the world-shape gauges from the live runtime. Called
    from ``init`` and by the resize commit (``elastic/resize.py``). Every
    rank is a process of its own, so ``hvd_process_count`` is the world
    size. No-op when the runtime is not initialized."""
    from horovod_tpu_torch.runtime import context as _ctx_mod
    ctx = _ctx_mod._context
    if ctx is None:
        return
    gauge("hvd_world_size",
          "Ranks in the global process set (live topology; republished "
          "at every resize commit)", aggregation="leader").set(ctx.size)
    gauge("hvd_local_size",
          "Ranks on this process's host").set(ctx.local_size)
    gauge("hvd_process_count", "Processes in the world",
          aggregation="leader").set(ctx.size)
    gauge("hvd_dcn_slices",
          "Slices along the DCN mesh tier (1 = single slice / collapsed "
          "axis)", aggregation="leader").set(ctx.topology.dcn_size)


def _world_block() -> Optional[Dict[str, Any]]:
    """The /healthz ``world`` payload: the live topology plus the last
    resize, if any; None outside an initialized runtime."""
    from horovod_tpu_torch.runtime import context as _ctx_mod
    ctx = _ctx_mod._context
    if ctx is None:
        return None
    out: Dict[str, Any] = {
        "size": int(ctx.size),
        "processes": int(ctx.size),
        "dcn_slices": int(ctx.topology.dcn_size),
        "mesh_axes": [str(a) for a in ctx.topology.flat_axes],
        "resizes": int(_counter_value("hvd_elastic_resizes_total")),
    }
    from horovod_tpu_torch.elastic import resize as _resize
    last = _resize.last_resize_info()
    if last is not None:
        out["last_resize"] = last
    return out


# ---------------------------------------------------------------------------
# health: the /healthz payload
# ---------------------------------------------------------------------------

def health_snapshot() -> Dict[str, Any]:
    """Operator liveness view: 'ok' (all clear), 'degraded' (ops
    outstanding past the stall-warn threshold, or an optional site shed by
    the fault domain), 'draining' (a preemption is armed) or 'unhealthy'
    (the stall inspector crossed its shutdown threshold). Elastic and
    checkpoint totals ride along as history and never flip the status.
    The straggler, goodput, world, artifact-store, serving and fleet
    blocks appear when their subsystem is live in this process."""
    from horovod_tpu_torch.stall_inspector import get_stall_inspector
    insp = get_stall_inspector()
    warned = insp.warned_count()
    if insp.stalled_shutdown:
        status = "unhealthy"
    elif warned:
        status = "degraded"
    else:
        status = "ok"
    from horovod_tpu_torch.resilience import preemption as _preemption
    handler = _preemption.active_handler()
    preempting = bool(handler is not None and handler.requested)
    if preempting and status == "ok":
        status = "draining"
    from horovod_tpu_torch.resilience import faults as _faults
    domain = _faults.fault_domain()
    fd = domain.snapshot()
    fd["retries"] = domain.retry_summary()
    if fd["state"] == _faults.DEGRADED and status == "ok":
        status = "degraded"
    from horovod_tpu_torch.tracing import straggler as _straggler
    det = _straggler.active_detector()
    from horovod_tpu_torch.goodput import accountant as _goodput
    gp = _goodput.health_block()
    out: Dict[str, Any] = {
        "status": status,
        "stall": {"outstanding": insp.pending_count(),
                  "warned": warned,
                  "stalled_shutdown": insp.stalled_shutdown},
        "elastic": {
            "resets": int(_counter_value("hvd_elastic_resets_total")),
            "worker_failures": int(
                _counter_value("hvd_elastic_worker_failures_total"))},
        "checkpoint": {
            # _counter_value reads gauges as well (Metric.value)
            "inflight": int(_counter_value("hvd_checkpoint_inflight")),
            "last_step": int(_counter_value("hvd_checkpoint_last_step")),
            "commits": int(_counter_value("hvd_checkpoint_commits_total")),
            "failures": int(
                _counter_value("hvd_checkpoint_failures_total")),
        },
        "preemption": {
            "requested": preempting,
            "stop_step": (handler.stop_step or 0) if handler else 0,
        },
        "fault_domain": fd,
    }
    if det is not None:
        out["straggler"] = det.snapshot()
    if gp is not None:
        out["goodput"] = gp
    world = _world_block()
    if world is not None:
        out["world"] = world
    # The artifact store's tallies and the compile seconds it saved this
    # process: absent when HOROVOD_ARTIFACT_STORE is unset.
    from horovod_tpu_torch.store import artifact_store as _artifact_store
    st = _artifact_store.store_stats()
    if st is not None:
        out["artifact_store"] = {
            k: st[k] for k in ("hits", "misses", "evictions", "publishes",
                               "compile_seconds_saved", "size_bytes",
                               "entries")}
    from horovod_tpu_torch import serving as _serving
    sv = _serving.serving_stats()
    if sv is not None:
        out["serving"] = sv
    fl = _serving.fleet_stats()
    if fl is not None:
        out["fleet"] = fl
    return out


# ---------------------------------------------------------------------------
# HTTP export: /metrics (Prometheus text) + /healthz
# ---------------------------------------------------------------------------

class MetricsServer:
    """Background HTTP server. Port 0 binds an ephemeral port; the bound
    port is ``.port``. One daemon thread per connection
    (``ThreadingHTTPServer``), so a slow scraper cannot block the next
    one; the server starts in ``__init__``."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):     # no per-request stderr lines
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                try:
                    path = self.path.split("?")[0]
                    if path == "/metrics":
                        if (_aggregator is not None
                                and _aggregator.is_leader):
                            snap = _aggregator.merged_snapshot()
                        else:
                            snap = _registry.snapshot()
                        self._send(
                            200, render_snapshot(snap).encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/healthz":
                        h = health_snapshot()
                        code = 503 if h["status"] == "unhealthy" else 200
                        self._send(code, json.dumps(h).encode(),
                                   "application/json")
                    elif path == "/":
                        self._send(
                            200, b"horovod_tpu_torch metrics: /metrics "
                            b"/healthz", "text/plain")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception:
                    logger.exception("metrics request failed")
                    counter("hvd_metrics_request_failures_total",
                            "Metrics HTTP requests that errored").inc()
                    try:
                        self._send(500, b"internal error", "text/plain")
                    except Exception:
                        # the peer hung up before the error reply; the
                        # failure is already logged and counted
                        logger.debug("metrics 500 reply not delivered",
                                     exc_info=True)

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-metrics-http",
            daemon=True)
        self._thread.start()
        logger.info("metrics server listening on :%d", self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# periodic JSON snapshot dump (HOROVOD_METRICS_DUMP)
# ---------------------------------------------------------------------------

class SnapshotDumper:
    """Writes the snapshot as JSON every ``interval`` seconds and once at
    stop. Atomic (tmp + rename): a sidecar never reads a torn file, and a
    crashed run keeps its last complete dump."""

    def __init__(self, path: str, interval: float):
        self.path = path
        self.interval = max(float(interval), 0.05)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="hvd-metrics-dump", daemon=True)
        self._thread.start()

    def _write(self) -> None:
        payload = {"time": time.time(), "pid": os.getpid(),
                   "health": health_snapshot(),
                   "metrics": metrics_snapshot()}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, self.path)

    def _write_counted(self, what: str) -> None:
        try:
            self._write()
        except Exception:
            logger.exception("%s failed", what)
            counter("hvd_metrics_dump_failures_total",
                    "Snapshot dump attempts that errored").inc()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._write_counted("metrics dump")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self._write_counted("final metrics dump")   # never lose the tail


# ---------------------------------------------------------------------------
# cross-rank aggregation over the c10d store (rank 0 merges)
# ---------------------------------------------------------------------------

class ClusterAggregator:
    """The ranks but 0 publish their local snapshot under a key of their
    own; rank 0 merges whatever snapshots are present when it is scraped
    (a rank that has not published yet contributes nothing: a scrape
    never blocks on a peer). ``kv`` is a ``DistributedKV`` (or anything
    with its ``set(key, value, overwrite)`` and ``try_get(key)``)."""

    def __init__(self, kv, process_index: int, process_count: int,
                 prefix: str = "hvd/metrics"):
        self._kv = kv
        self.process_index = process_index
        self.process_count = process_count
        self.is_leader = process_index == 0
        self._prefix = prefix

    def _key(self, idx: int) -> str:
        return f"{self._prefix}/p{idx}"

    def publish(self) -> None:
        # overwrite=True: the store's set is write-once by default, and
        # this key is republished every interval
        self._kv.set(self._key(self.process_index),
                     json.dumps(_registry.snapshot()), overwrite=True)

    def merged_snapshot(self) -> Dict[str, Any]:
        snaps = [_registry.snapshot()]
        for i in range(self.process_count):
            if i == self.process_index:
                continue
            try:
                raw = self._kv.try_get(self._key(i))
            except Exception:
                continue                 # a dead peer: serve what we have
            if raw:
                try:
                    snaps.append(json.loads(raw))
                except Exception:
                    logger.warning("unparseable metrics snapshot from "
                                   "process %d", i)
        return merge_snapshots(snaps)


class _Publisher:
    """The periodic publishing thread of a rank other than 0."""

    def __init__(self, aggregator: ClusterAggregator, interval: float):
        self._agg = aggregator
        self.interval = max(float(interval), 0.05)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="hvd-metrics-pub", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        from horovod_tpu_torch.resilience import faults
        while not self._stop.wait(self.interval):
            try:
                if faults.should_shed("metrics"):
                    # degraded: publication is optional traffic, skipped
                    # (rank 0 serves this rank's last snapshot) until the
                    # fault domain's probe heals the site
                    continue
                self._agg.publish()
            except Exception:
                logger.exception("metrics publish failed")
                counter("hvd_metrics_publish_failures_total",
                        "KV-store snapshot publications that errored").inc()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        try:
            self._agg.publish()         # the final publication
        except Exception:
            # a lost final publication leaves rank 0 merging a stale
            # snapshot of this rank: visible, not silent
            logger.warning("final metrics publication failed; rank 0 "
                           "serves this rank's last interval",
                           exc_info=True)
            counter("hvd_metrics_publish_failures_total",
                    "KV-store snapshot publications that errored").inc()


# ---------------------------------------------------------------------------
# lifecycle: wired from init()/shutdown()
# ---------------------------------------------------------------------------

_server: Optional[MetricsServer] = None
_dumper: Optional[SnapshotDumper] = None
_publisher: Optional[_Publisher] = None
_aggregator: Optional[ClusterAggregator] = None
_lifecycle_lock = threading.Lock()


def start_metrics_server(port: int, host: str = "0.0.0.0") -> MetricsServer:
    """Start (or return) the process's metrics HTTP server."""
    global _server
    with _lifecycle_lock:
        if _server is None:
            _install_default_collectors()
            _server = MetricsServer(port, host=host)
        return _server


def get_metrics_server() -> Optional[MetricsServer]:
    return _server


def init_from_env() -> None:
    """Called from ``init``: start whichever exports the
    ``HOROVOD_METRICS_*`` knobs enable. Idempotent across init/shutdown
    cycles in one process."""
    global _dumper, _publisher, _aggregator
    from horovod_tpu_torch.utils import schedhooks
    _install_default_collectors()
    rank, world = schedhooks.process_world()
    with _lifecycle_lock:
        # aggregation first, so a server started below serves the merged
        # view from its first scrape
        if _aggregator is None and world > 1:
            try:
                from horovod_tpu_torch.utils.kvstore import distributed_kv
                # a connection of its own: a c10d client runs one call at
                # a time, and the step path's store calls must not queue
                # behind a publication (or it behind their waits)
                kv = distributed_kv(site="metrics", own_connection=True)
                if kv is not None:
                    _aggregator = ClusterAggregator(kv, rank, world)
                    if not _aggregator.is_leader:
                        _publisher = _Publisher(
                            _aggregator,
                            knobs.get("HOROVOD_METRICS_AGG_INTERVAL"))
            except Exception:
                logger.exception("metrics aggregation unavailable")
        dump = knobs.get("HOROVOD_METRICS_DUMP")
        if dump and _dumper is None:
            # launchers export ONE dump path to every rank; the ranks but
            # 0 suffix theirs so they do not clobber rank 0's
            if world > 1 and rank > 0:
                dump = f"{dump}.p{rank}"
            _dumper = SnapshotDumper(
                dump, knobs.get("HOROVOD_METRICS_DUMP_INTERVAL"))
    port = int(knobs.get("HOROVOD_METRICS_PORT"))
    if port > 0:
        try:
            start_metrics_server(port)
        except OSError as e:
            # ranks on one host share the launcher's port: the first binds
            # it, the others take an ephemeral port (logged) rather than
            # failing init with EADDRINUSE
            logger.warning("metrics port %d unavailable (%s); binding an "
                           "ephemeral port instead", port, e)
            try:
                srv = start_metrics_server(0)
                logger.warning("metrics server listening on ephemeral "
                               "port %d", srv.port)
            except Exception:
                logger.exception("metrics server failed to start; "
                                 "continuing without HTTP export")


def stop_exports() -> None:
    """Stop the server, dumper and publisher (the final dump and
    publication included). The registry keeps its values: counters keep
    their totals across init/shutdown cycles, as in any Prometheus
    client."""
    global _server, _dumper, _publisher, _aggregator
    with _lifecycle_lock:
        server, _server = _server, None
        dumper, _dumper = _dumper, None
        publisher, _publisher = _publisher, None
        _aggregator = None
    if publisher is not None:
        publisher.stop()
    if dumper is not None:
        dumper.stop()
    if server is not None:
        server.stop()
