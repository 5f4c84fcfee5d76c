"""Numerics-health telemetry: device aggregates, streaming detectors.

The counterpart of ``horovod_tpu/goodput/numerics.py``. The aggregates
are cheap by construction: per-tensor nonfinite counts and squared norms
of the eager coordinator's reduced allreduce bins
(:func:`bin_aggregates`, a two-level segmented reduction over the bin's
fusion buffer: a fixed number of launches a bin, whatever its tensor
count; on
the post-allreduce values a local reduction already equals the global
one, so no collective is added). Each observation starts a non-blocking
copy of its device tensors into pinned host memory and records a CUDA
event after it; the drain that falls due every
``HOROVOD_NUMERICS_CHECK_EVERY`` observations reads only the rows whose
copy has landed (``Event.query``), so the thread that observes (the
coordinator's cycle thread, the training loop) never waits on the
device; an explicit :meth:`NumericsMonitor.drain`, as at the training
loop's end, waits for every row. The host side is a set of streaming
detectors over those scalars:

- **loss spike**: EWMA mean and variance of the loss; an anomaly when a
  value lands ``HOROVOD_NUMERICS_SPIKE_SIGMA`` trailing standard
  deviations above the mean (or goes nonfinite) after warmup.
- **grad-norm explosion**: an anomaly when the global gradient norm
  exceeds ``HOROVOD_NUMERICS_GRADNORM_FACTOR`` times its trailing EWMA
  (or goes nonfinite) after warmup.
- **nonfinite localization**: a nonfinite count is mapped back to the
  bucket (or bin entry) that carried it and, through the same
  reverse-order contiguous bucket plan the gradient sync uses
  (``ops.fusion._plan_buckets_by_bytes``), to the parameter names in that
  bucket, so the flight recording names WHICH tensor went bad.

On an anomaly the monitor writes a flight recording
(``tracing.spans.dump_flight_recording``), counts it
(``hvd_numerics_anomalies_total{kind=}``) and applies
``HOROVOD_NUMERICS_ACTION``: ``warn`` (log only), ``degrade`` (shed the
optional ``numerics`` fault-domain site, so /healthz reads degraded until
a clean drain heals it) or ``abort`` (raise :class:`NumericsAnomalyError`
into the training loop).

Everything is off unless ``HOROVOD_NUMERICS=1``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.profiler import record_function

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.goodput.numerics")

ANOMALY_KINDS = ("loss_spike", "grad_norm_explosion", "nonfinite")


class NumericsAnomalyError(RuntimeError):
    """Raised into the training loop when HOROVOD_NUMERICS_ACTION=abort
    and a detector fires. Carries the anomaly dict."""

    def __init__(self, anomaly: Dict[str, Any]):
        super().__init__(f"numerics anomaly: {anomaly}")
        self.anomaly = anomaly


def ingraph_enabled() -> bool:
    """Whether the coordinator's bins grow numerics aggregates (read when
    a bin's plan is made: it keys the plan)."""
    return bool(knobs.get("HOROVOD_NUMERICS"))


# ---------------------------------------------------------------------------
# device aggregates
# ---------------------------------------------------------------------------

_SEGMENTS_CAP = 32
_segments: "OrderedDict[Tuple, Tuple]" = OrderedDict()
_segments_lock = threading.Lock()

# Elements a first-level partial sums (0: one level, straight to the
# tensors' sums). Scatter-adds of a whole tensor into one slot serialize
# on that slot's atomics; blocks that never straddle two tensors spread
# them over many slots, and a second, small scatter-add folds the blocks.
SEGMENT_BLOCK = 4096


def _ids(lengths: Sequence[int], dev: torch.device) -> torch.Tensor:
    """``i`` repeated ``lengths[i]`` times, int32 on ``dev``: a pinned,
    non-blocking copy and a given output size, so no host
    synchronization."""
    counts = torch.tensor(list(lengths), dtype=torch.int64)
    if dev.type == "cuda":
        counts = counts.pin_memory().to(dev, non_blocking=True)
    return torch.repeat_interleave(
        torch.arange(len(lengths), dtype=torch.int32, device=dev), counts,
        output_size=sum(lengths))


def segment_layout(numels: Sequence[int], device,
                   block: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """``(element ids, block -> tensor ids, slots)`` of a flat buffer
    packing tensors of ``numels`` elements in order: each element's
    block (each tensor cut into blocks of ``block`` elements, the last
    one shorter) and each block's tensor; with ``block`` 0 the element
    ids are the tensors' and there is no second level. Cached per layout
    and device: a bin plan reuses its layout every step."""
    block = SEGMENT_BLOCK if block is None else int(block)
    dev = torch.device(device)
    key = (tuple(int(n) for n in numels), str(dev), block)
    with _segments_lock:
        hit = _segments.get(key)
        if hit is not None:
            _segments.move_to_end(key)
            return hit
    if block <= 0:
        out = (_ids(key[0], dev), None, len(key[0]))
    else:
        lengths, per = [], []
        for m in key[0]:
            q, r = divmod(m, block)
            lengths += [block] * q + ([r] if r else [])
            per.append(q + (1 if r else 0))
        out = (_ids(lengths, dev), _ids(per, dev), len(lengths))
    with _segments_lock:
        _segments[key] = out
        while len(_segments) > _SEGMENTS_CAP:
            _segments.popitem(last=False)
    return out


def bin_aggregates(flat: torch.Tensor, numels: Sequence[int],
                   block: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor ``(nonfinite_counts[int32], sq_norms[f32])`` of the
    tensors packed in order in the flat buffer ``flat``, as device
    tensors: a segmented reduction of each over the buffer (scatter-adds
    by block id, then by tensor id; ``block`` as in
    :func:`segment_layout`), so the launches do not grow with the tensor
    count. No host synchronization."""
    n = len(numels)
    flat = flat.reshape(-1)
    x = flat if flat.dtype == torch.float32 else flat.float()
    ids, top, slots = segment_layout(numels, flat.device, block)
    bad = torch.isfinite(x).logical_not_().to(torch.int32)
    nf = torch.zeros(slots, dtype=torch.int32, device=flat.device)
    nf.index_add_(0, ids, bad)
    sq = torch.zeros(slots, dtype=torch.float32, device=flat.device)
    sq.index_add_(0, ids, x * x)
    if top is not None:
        nf = torch.zeros(n, dtype=torch.int32,
                         device=flat.device).index_add_(0, top, nf)
        sq = torch.zeros(n, dtype=torch.float32,
                         device=flat.device).index_add_(0, top, sq)
    return nf, sq


def update_ratio(params: Sequence[torch.Tensor],
                 updates: Sequence[torch.Tensor]) -> torch.Tensor:
    """||update|| / ||param||: the classic silent-divergence telemetry
    (a healthy run sits around 1e-3; a collapsing one walks toward 1)."""
    p_sq = sum(torch.sum(p.detach().float() ** 2) for p in params)
    u_sq = sum(torch.sum(u.detach().float() ** 2) for u in updates)
    return torch.sqrt(u_sq) / torch.clamp(torch.sqrt(p_sq), min=1e-30)


# ---------------------------------------------------------------------------
# bucket -> parameter localization (the fusion-bin layout)
# ---------------------------------------------------------------------------

def _default_bucket_bytes() -> int:
    raw = knobs.get("HOROVOD_GRADIENT_BUCKET_BYTES")
    if raw == "auto":
        from horovod_tpu_torch.autotune import DEFAULT_BUCKET_BYTES
        return int(DEFAULT_BUCKET_BYTES)
    return int(raw)


def _keystr(path: Sequence[str]) -> str:
    """``jax.tree_util.keystr``'s form of a dict path: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def _named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` in the order the gradient sync plans over: a
    nested dict's leaves in sorted-key order named as
    ``jax.tree_util.keystr`` names them; an ``nn.Module``'s parameters
    in ``parameters()`` order under their ``named_parameters`` names; a
    list of pairs as given."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []

        def walk(node, path):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k], path + (k,))
            else:
                out.append((_keystr(path), node))
        walk(tree, ())
        return out
    return [(str(n), v) for n, v in tree]


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    a = np.asarray(v)
    return a.size * a.dtype.itemsize


def _plan(sizes: List[int], bb: int) -> List[List[int]]:
    from horovod_tpu_torch.ops.fusion import _plan_buckets_by_bytes
    if bb <= 0 or len(sizes) <= 1:
        return [list(range(len(sizes)))]
    return _plan_buckets_by_bytes(sizes, bb)


def bucket_param_map(tree: Any, bucket_bytes: Optional[int] = None
                     ) -> Dict[int, List[str]]:
    """bucket index -> parameter names, from the SAME reverse-order
    contiguous plan the gradient sync uses (``_plan_buckets_by_bytes``):
    the layout that lets a per-bucket nonfinite count name its
    tensors."""
    bb = bucket_bytes if bucket_bytes is not None else \
        _default_bucket_bytes()
    named = _named_leaves(tree)
    names = [n for n, _ in named]
    plan = _plan([_nbytes(v) for _, v in named], bb)
    return {k: [names[i] for i in idxs] for k, idxs in enumerate(plan)}


def _nonfinite_count(v) -> int:
    if isinstance(v, torch.Tensor):
        return int((~torch.isfinite(v.detach().float())).sum())
    return int(np.sum(~np.isfinite(np.asarray(v).astype(np.float32))))


def localize_nonfinite(tree: Any, bucket_bytes: Optional[int] = None
                       ) -> List[Dict[str, Any]]:
    """Host-side localization: per bucket of the fusion layout, the
    nonfinite element count and the offending parameter names. Empty
    list == all finite."""
    bb = bucket_bytes if bucket_bytes is not None else \
        _default_bucket_bytes()
    named = _named_leaves(tree)
    names = [n for n, _ in named]
    counts = [_nonfinite_count(v) for _, v in named]
    out: List[Dict[str, Any]] = []
    for k, idxs in enumerate(_plan([_nbytes(v) for _, v in named], bb)):
        total = sum(counts[i] for i in idxs)
        if total:
            out.append({"bucket": k, "nonfinite": total,
                        "params": [names[i] for i in idxs if counts[i]]})
    return out


# ---------------------------------------------------------------------------
# streaming detectors
# ---------------------------------------------------------------------------

class LossSpikeDetector:
    """EWMA mean/variance spike detector. ``observe`` returns an anomaly
    dict (or None); nonfinite losses fire immediately, spikes only after
    ``warmup`` finite observations."""

    def __init__(self, sigma: Optional[float] = None, warmup: int = 10,
                 alpha: float = 0.1):
        self.sigma = float(sigma if sigma is not None
                           else knobs.get("HOROVOD_NUMERICS_SPIKE_SIGMA"))
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self._mean: Optional[float] = None
        self._var = 0.0
        self._n = 0

    def observe(self, loss: float) -> Optional[Dict[str, Any]]:
        loss = float(loss)
        if not np.isfinite(loss):
            return {"kind": "nonfinite", "signal": "loss", "value": loss}
        anomaly = None
        if self._mean is not None and self._n >= self.warmup:
            std = max(self._var, 1e-24) ** 0.5
            if loss > self._mean + self.sigma * std \
                    and loss > self._mean * 1.0001:
                anomaly = {"kind": "loss_spike", "signal": "loss",
                           "value": loss,
                           "mean": round(self._mean, 6),
                           "std": round(std, 6),
                           "sigma": self.sigma}
        if self._mean is None:
            self._mean = loss
        else:
            d = loss - self._mean
            self._mean += self.alpha * d
            self._var = (1 - self.alpha) * (self._var
                                            + self.alpha * d * d)
        self._n += 1
        return anomaly


class GradNormDetector:
    """Trailing-EWMA explosion detector for the global gradient norm."""

    def __init__(self, factor: Optional[float] = None, warmup: int = 10,
                 alpha: float = 0.1):
        self.factor = float(
            factor if factor is not None
            else knobs.get("HOROVOD_NUMERICS_GRADNORM_FACTOR"))
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self._ewma: Optional[float] = None
        self._n = 0

    def observe(self, norm: float) -> Optional[Dict[str, Any]]:
        norm = float(norm)
        if not np.isfinite(norm):
            return {"kind": "nonfinite", "signal": "grad_norm",
                    "value": norm}
        anomaly = None
        if self._ewma is not None and self._n >= self.warmup \
                and norm > self.factor * max(self._ewma, 1e-24):
            anomaly = {"kind": "grad_norm_explosion",
                       "signal": "grad_norm", "value": norm,
                       "ewma": round(self._ewma, 6),
                       "factor": self.factor}
        self._ewma = norm if self._ewma is None \
            else (1 - self.alpha) * self._ewma + self.alpha * norm
        self._n += 1
        return anomaly


class NonfiniteDetector:
    """Maps per-bucket nonfinite counts to an anomaly naming the bucket
    (and, when a layout is attached, its parameters)."""

    def __init__(self, bucket_params: Optional[Dict[int, List[str]]] = None):
        self.bucket_params = bucket_params or {}

    def observe(self, counts: Sequence[int],
                labels: Optional[Sequence[str]] = None
                ) -> Optional[Dict[str, Any]]:
        bad = [(i, int(c)) for i, c in enumerate(counts) if int(c) > 0]
        if not bad:
            return None
        buckets = []
        for i, c in bad:
            entry: Dict[str, Any] = {"bucket": i, "nonfinite": c}
            if labels is not None and i < len(labels):
                entry["label"] = labels[i]
            if i in self.bucket_params:
                entry["params"] = list(self.bucket_params[i])
            buckets.append(entry)
        return {"kind": "nonfinite", "signal": "buckets",
                "buckets": buckets}


# ---------------------------------------------------------------------------
# the monitor: detectors + cadence + anomaly actions
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    """A row's value (a host tensor, or anything array-like) as a host
    array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _start_copies(row: Dict[str, Any]):
    """``(row, event)``: the row with each CUDA tensor replaced by a
    pinned host tensor its copy lands in (non-blocking, on the current
    stream), and a CUDA event recorded after the copies (None for a row
    with no CUDA tensor)."""
    dev = None
    out = dict(row)
    for k, v in row.items():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            dev = v.device
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v.detach(), non_blocking=True)
            out[k] = h
    if dev is None:
        return out, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return out, event


class NumericsMonitor:
    """Folds the streams into the detectors and owns the anomaly
    response. Rows are buffered, their device tensors copying to host
    memory without a wait, and drained every
    ``HOROVOD_NUMERICS_CHECK_EVERY`` observations: such a drain reads the
    rows whose copies have landed and leaves the rest for the next, so
    observing never synchronizes with the device."""

    def __init__(self, bucket_params: Optional[Dict[int, List[str]]] = None,
                 check_every: Optional[int] = None,
                 action: Optional[str] = None):
        self.check_every = max(int(
            check_every if check_every is not None
            else knobs.get("HOROVOD_NUMERICS_CHECK_EVERY")), 1)
        self.action = str(action if action is not None
                          else knobs.get("HOROVOD_NUMERICS_ACTION"))
        self.loss_detector = LossSpikeDetector()
        self.gradnorm_detector = GradNormDetector()
        self.nonfinite_detector = NonfiniteDetector(bucket_params)
        self.anomalies: List[Dict[str, Any]] = []
        self.drains = 0
        self._lock = threading.Lock()
        self._pending: List[Tuple[int, Dict[str, Any], Any]] = []
        self._observed = 0
        from horovod_tpu_torch import metrics as M
        self._m_anomalies = M.counter(
            "hvd_numerics_anomalies_total",
            "Numerics anomalies fired by the streaming detectors",
            labelnames=("kind",))
        self._m_loss = M.gauge(
            "hvd_numerics_loss", "Last loss observed by the numerics "
            "monitor", aggregation="leader")
        self._m_norm = M.gauge(
            "hvd_numerics_grad_norm", "Last global gradient norm "
            "observed by the numerics monitor", aggregation="leader")
        self._m_ratio = M.gauge(
            "hvd_numerics_update_ratio", "Last ||update||/||param|| "
            "observed by the numerics monitor", aggregation="leader")

    # -- observation side ----------------------------------------------------
    def observe_step(self, step: int, loss: Any = None,
                     grad_sq_norms: Any = None,
                     nonfinite_counts: Any = None,
                     update_ratio_value: Any = None) -> None:
        """Buffer one step's signals (device tensors are fine: the
        conversion waits for the cadence drain)."""
        row = {"loss": loss, "sq_norms": grad_sq_norms,
               "nonfinite": nonfinite_counts,
               "update_ratio": update_ratio_value}
        self._buffer(int(step), row)

    def observe_bin(self, labels: Sequence[str], nonfinite_counts: Any,
                    sq_norms: Any) -> None:
        """Eager-coordinator feed: one bin's aggregates, per entry in the
        bin's order (``labels`` are the entries' names)."""
        row = {"loss": None, "sq_norms": sq_norms,
               "nonfinite": nonfinite_counts, "update_ratio": None,
               "labels": list(labels)}
        self._buffer(-1, row)

    def _buffer(self, step: int, row: Dict[str, Any]) -> None:
        row, event = _start_copies(row)
        with self._lock:
            self._pending.append((step, row, event))
            self._observed += 1
            due = self._observed % self.check_every == 0
        if due:
            self.drain(wait=False)

    # -- detection side ------------------------------------------------------
    def drain(self, wait: bool = True) -> List[Dict[str, Any]]:
        """Run every detector over the buffered rows, in order; returns
        (and records) the anomalies this drain fired. ``wait`` False
        (the cadence's drain) takes only the leading rows whose host
        copies have landed and never blocks; True waits for them all."""
        with record_function("hvd_numerics.drain"):
            return self._drain(wait)

    def _drain(self, wait: bool) -> List[Dict[str, Any]]:
        with self._lock:
            k = len(self._pending)
            if not wait:
                k = 0
                for _, _, event in self._pending:
                    if event is not None and not event.query():
                        break
                    k += 1
            rows, self._pending = self._pending[:k], self._pending[k:]
            self.drains += 1
        fired: List[Dict[str, Any]] = []
        clean = True
        for step, row, event in rows:
            if wait and event is not None:
                event.synchronize()
            for anomaly in self._detect(step, row):
                clean = False
                fired.append(anomaly)
                self._fire(anomaly)
        if clean and rows and self.action == "degrade":
            # a clean drain heals a previously shed numerics site
            from horovod_tpu_torch.resilience import faults
            faults.fault_domain().record_success("numerics")
        return fired

    def _detect(self, step: int, row: Dict[str, Any]):
        out = []
        loss = row.get("loss")
        if loss is not None:
            loss = float(_host(loss))
            # Gauges carry finite values only (a NaN sample would be a
            # second, confusing signal on /metrics: the anomaly counter
            # is the nonfinite signal).
            if np.isfinite(loss):
                self._m_loss.set(loss)
            a = self.loss_detector.observe(loss)
            if a:
                out.append(dict(a, step=step))
        sq = row.get("sq_norms")
        # Bin rows (labels present) carry arbitrary eager traffic, not
        # the full gradient tree: feeding their per-bin norms into the
        # single global-norm EWMA would false-fire on any mix of buckets
        # (and double-report a NaN the nonfinite counts already catch),
        # so only step rows drive this detector.
        if sq is not None and "labels" not in row:
            sq_host = _host(sq).astype(np.float64)
            norm = float(np.sqrt(np.sum(sq_host))) \
                if np.all(np.isfinite(sq_host)) else float("nan")
            if np.isfinite(norm):
                self._m_norm.set(norm)
            a = self.gradnorm_detector.observe(norm)
            if a:
                out.append(dict(a, step=step))
        nf = row.get("nonfinite")
        if nf is not None:
            counts = _host(nf).reshape(-1)
            a = self.nonfinite_detector.observe(
                counts, labels=row.get("labels"))
            if a:
                out.append(dict(a, step=step))
        ratio = row.get("update_ratio")
        if ratio is not None:
            ratio = float(_host(ratio))
            if np.isfinite(ratio):
                self._m_ratio.set(ratio)
        return out

    # -- response side -------------------------------------------------------
    def _fire(self, anomaly: Dict[str, Any]) -> None:
        self.anomalies.append(anomaly)
        kind = anomaly.get("kind", "unknown")
        try:
            self._m_anomalies.labels(kind=kind).inc()
        except Exception:
            logger.debug("anomaly counter unavailable", exc_info=True)
        logger.warning("numerics anomaly: %s", anomaly)
        from horovod_tpu_torch.tracing import spans as trace
        trace.instant("numerics.anomaly", cat="numerics", attrs=anomaly)
        trace.dump_flight_recording(f"numerics-{kind}")
        if self.action == "degrade":
            from horovod_tpu_torch.resilience import faults
            faults.fault_domain().record_exhausted("numerics",
                                                   critical=False)
        elif self.action == "abort":
            raise NumericsAnomalyError(anomaly)

    def summary(self) -> Dict[str, Any]:
        """The run ledger's ``numerics`` block."""
        by_kind: Dict[str, int] = {}
        for a in self.anomalies:
            k = a.get("kind", "unknown")
            by_kind[k] = by_kind.get(k, 0) + 1
        return {"anomalies": len(self.anomalies),
                "by_kind": by_kind,
                "last": self.anomalies[-1] if self.anomalies else None}


# ---------------------------------------------------------------------------
# process-global monitor (train loop + coordinator share one)
# ---------------------------------------------------------------------------

_monitor: Optional[NumericsMonitor] = None
_monitor_lock = threading.Lock()


def get_monitor() -> Optional[NumericsMonitor]:
    """The installed monitor, creating one lazily when
    ``HOROVOD_NUMERICS=1`` (None otherwise: call sites stay no-ops)."""
    global _monitor
    if _monitor is not None:
        return _monitor
    if not ingraph_enabled():
        return None
    with _monitor_lock:
        if _monitor is None:
            _monitor = NumericsMonitor()
        return _monitor


def install(monitor: Optional[NumericsMonitor]) -> None:
    global _monitor
    with _monitor_lock:
        _monitor = monitor


def reset_for_tests() -> None:
    install(None)


def monitor_summary() -> Optional[Dict[str, Any]]:
    return _monitor.summary() if _monitor is not None else None
