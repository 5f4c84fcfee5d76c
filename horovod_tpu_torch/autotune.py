"""The online tuner and the gradient-bucket auto-resolution: the port of
``horovod_tpu/autotune.py`` (ref common/parameter_manager.{h,cc},
common/optim/bayesian_optimization.cc / gaussian_process.cc).

**The online tuner.** :class:`ParameterManager` tunes the coordinator's
continuous knobs (fusion threshold in [0, 64] MiB, cycle time in [1, 100]
ms, and on a hierarchical mesh the cross-axis threshold), the ordinal ones
(the wire tier under HOROVOD_AUTOTUNE_COMPRESSION, the DCN schedule where
a DCN tier exists) and the categorical ones (hierarchical and torus
allreduce) with Gaussian-process regression and expected improvement
over the unit box. The coordinator feeds ``update()`` each cycle's bytes;
after a warmup every ``HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE`` cycles score
the current point, the optimizer proposes the next, and after
``HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES`` samples the best point is
pinned. A window is scored by dispatch throughput (v1), or, when the
training loop feeds :func:`feed_step_stats` (``callbacks.StepStats``), by
step throughput discounted by the share of the step blocked on
collectives (v2). The values are applied as knob overrides. The numpy
arithmetic is the JAX package's, line for line: the same clock readings
and bytes give the same overrides in the same order.

**Across ranks.** A world of several ranks dispatches deterministically,
so every rank reaches the same cycle boundaries in the same order. Rank 0
tunes and publishes its tunable knobs under a cycle-indexed key of the
c10d store (:class:`ParameterSynchronizer`, the ``autotune`` site of the
fault domain); the other ranks fetch and apply them at the same cycle.
The JAX package's transport is the jax.distributed KV store.

**HOROVOD_GRADIENT_BUCKET_BYTES=auto** resolves the winner cached under
the (gradient shapes, world size) key (:func:`grad_signature`, in the JAX
package's string form) in ``HOROVOD_BUCKET_AUTO_CACHE``. The JAX package
fills that cache from an AOT compile of each candidate scored under a
ring model with a TPU's link constants. The port has neither: it
**measures** (:func:`sweep_bucket_bytes`), running profiled steps at each
candidate and picking the least exposed collective time, ties going to
fewer collectives (JAX's rule). The ring-model functions are kept
(:func:`collective_seconds`, :func:`score_bucket_schedule`,
:func:`auto_bucket_search`), but take the link terms as arguments: the
port carries no link constants, and ``HOROVOD_DCN_SCHEDULE=auto`` resolves
``flat`` until NVLink and the network between hosts are measured.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger


class GaussianProcess:
    """GP regression with RBF kernel + noise (ref gaussian_process.cc)."""

    def __init__(self, length_scale: float = 0.2, signal_var: float = 1.0,
                 noise_var: float = 1e-4):
        self.ls = length_scale
        self.sv = signal_var
        self.nv = noise_var
        self._x: Optional[np.ndarray] = None
        self._alpha = None
        self._k_inv = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.sv * np.exp(-0.5 * d2 / self.ls ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.atleast_2d(x)
        k = self._kernel(self._x, self._x)
        k += self.nv * np.eye(len(self._x))
        self._k_inv = np.linalg.inv(k)
        self._y_mean = float(np.mean(y))
        self._alpha = self._k_inv @ (np.asarray(y, float) - self._y_mean)

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x = np.atleast_2d(x)
        ks = self._kernel(x, self._x)
        mu = ks @ self._alpha + self._y_mean
        var = self.sv - np.einsum("ij,jk,ik->i", ks, self._k_inv, ks)
        return mu, np.sqrt(np.maximum(var, 1e-12))


def expected_improvement(mu: np.ndarray, sigma: np.ndarray,
                         best: float, xi: float = 0.01) -> np.ndarray:
    """EI acquisition (ref bayesian_optimization.cc ExpectedImprovement)."""
    from math import erf, sqrt
    z = (mu - best - xi) / sigma
    cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
    pdf = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
    return (mu - best - xi) * cdf + sigma * pdf


class BayesianOptimizer:
    """Sequential maximizer over the unit box (candidates by random search,
    matching the reference's sampled acquisition maximization)."""

    def __init__(self, dims: int, seed: int = 0, n_candidates: int = 256):
        self.dims = dims
        self.rng = np.random.RandomState(seed)
        self.n_candidates = n_candidates
        self.xs: List[np.ndarray] = []
        self.ys: List[float] = []
        self.gp = GaussianProcess()

    def suggest(self) -> np.ndarray:
        if len(self.xs) < 2:
            return self.rng.rand(self.dims)
        self.gp.fit(np.stack(self.xs), np.asarray(self.ys))
        cand = self.rng.rand(self.n_candidates, self.dims)
        mu, sigma = self.gp.predict(cand)
        ei = expected_improvement(mu, sigma, max(self.ys))
        return cand[int(np.argmax(ei))]

    def observe(self, x: np.ndarray, y: float) -> None:
        self.xs.append(np.asarray(x, float))
        self.ys.append(float(y))

    @property
    def best(self) -> Tuple[np.ndarray, float]:
        i = int(np.argmax(self.ys))
        return self.xs[i], self.ys[i]


# Continuous tunables: (knob, lo, hi, to_knob_value) -- parameter_manager.h:42
_CONTINUOUS = [
    ("HOROVOD_FUSION_THRESHOLD", 0.0, 64.0,
     lambda mb: int(mb * 1024 * 1024)),
    ("HOROVOD_CYCLE_TIME", 1.0, 100.0, float),
]
# Extra dimension on hierarchical meshes: the bin capacity of collectives
# crossing the slow outer axis, tuned apart from the local one. Floored at
# 1 byte: an applied 0 would mean "fall back to the base threshold".
_CROSS_THRESHOLD = ("HOROVOD_FUSION_THRESHOLD_CROSS", 0.0, 64.0,
                    lambda mb: max(int(mb * 1024 * 1024), 1))


def continuous_dims(hierarchical: bool = False):
    """The continuous tunable set for a mesh shape."""
    return _CONTINUOUS + ([_CROSS_THRESHOLD] if hierarchical else [])


# Categorical tunables walked jointly as extra binary dims
# (parameter_manager.h:60-67).
_CATEGORICAL = [
    "HOROVOD_HIERARCHICAL_ALLREDUCE",
    "HOROVOD_TORUS_ALLREDUCE",
]

# Ordinal tunables: a knob whose value is one of an ORDERED candidate list,
# mapped onto one [0, 1] dimension by quantization. The wire tier is
# ordered lossless -> most aggressive, so neighbouring points trade
# bandwidth against precision the way neighbouring thresholds trade latency
# against batching. The coordinator keys its plans on the tier, so a
# change takes effect at the next cycle.
COMPRESSION_TIER_CANDIDATES = ("none", "bf16", "fp8_e4m3")
_COMPRESSION_ORDINAL = ("HOROVOD_GRADIENT_COMPRESSION",
                        COMPRESSION_TIER_CANDIDATES)


def ordinal_dims():
    """The ordinal tunable set for this run: the wire tier when
    HOROVOD_AUTOTUNE_COMPRESSION opts in (a tier changes the wire's
    numerics), and the DCN schedule when the run has a DCN tier."""
    dims = []
    if knobs.get("HOROVOD_AUTOTUNE_COMPRESSION"):
        dims.append(_COMPRESSION_ORDINAL)
    if _dcn_tier_present():
        dims.append(("HOROVOD_DCN_SCHEDULE", DCN_SCHEDULE_CANDIDATES))
    return dims


def _ordinal_index(choices, value: str) -> int:
    """Candidate index of an ordinal knob value. A value outside the
    candidates (fp16 and fp8_e5m2 are valid tiers the tuner does not
    sample) maps to the nearest candidate in ``compression.WIRE_TIERS``'
    order, so the first observation is credited to its neighbourhood.
    The DCN schedule's 'auto' seeds at two_level, as in the JAX package,
    whose cost model resolves two_level on any real DCN tier."""
    if value in choices:
        return choices.index(value)
    if value == "auto" and "two_level" in choices:
        return choices.index("two_level")
    from horovod_tpu_torch.compression import WIRE_TIERS
    if value not in WIRE_TIERS:
        return 0
    pos = WIRE_TIERS.index(value)
    return min(range(len(choices)),
               key=lambda i: abs(WIRE_TIERS.index(choices[i]) - pos))


# Managers that want the training loop's per-step signal (StepStats.end
# feeds every registered manager: the v2 score).
_STEP_OBSERVERS: List = []

# World-keyed GP trajectories (the live resize): archived by
# ParameterManager.archive_world_history/reseed_for_world and adopted by a
# manager built for that world size, so a grow-back resumes its trajectory.
# Process-lifetime state, like the knob registry it tunes.
_WORLD_HISTORY: Dict[int, Dict[str, Any]] = {}


def feed_step_stats(step_seconds: float,
                    collective_seconds: float = 0.0) -> None:
    """Forward one training step's wall time and seconds blocked on
    collectives to every active ParameterManager (``callbacks.StepStats.
    end`` calls it): the v2 score judges a knob set by the step."""
    for mgr in list(_STEP_OBSERVERS):
        mgr._observe_step(step_seconds, collective_seconds)


class ParameterManager:
    """The tuner (ref parameter_manager.cc). Feed ``update()`` each
    cycle with the bytes moved; it scores the current point over each
    sample window and proposes the next until ``max_samples``, then pins
    the best values."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 synchronize_fn: Optional[Callable[[Dict], None]] = None,
                 continuous: Optional[List] = None,
                 ordinal: Optional[List] = None,
                 world: Optional[int] = None):
        from horovod_tpu_torch import metrics as M
        self.enabled = bool(knobs.get("HOROVOD_AUTOTUNE"))
        # The world key of the trajectory: scores taken at world N never
        # feed the posterior at world M (reseed_for_world).
        self._world = world
        self._clock = clock
        self._sync = synchronize_fn
        self._continuous = list(continuous) if continuous is not None \
            else list(_CONTINUOUS)
        self._ordinal = list(ordinal) if ordinal is not None \
            else ordinal_dims()
        self.warmup_remaining = knobs.get("HOROVOD_AUTOTUNE_WARMUP_SAMPLES")
        self.steps_per_sample = knobs.get("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE")
        self.max_samples = knobs.get("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES")
        self._opt = BayesianOptimizer(
            len(self._continuous) + len(self._ordinal) + len(_CATEGORICAL))
        # Opened at the first row: a follower, disabled before it scores
        # anything, must not truncate the leader's log on a shared path.
        self._log_path = knobs.get("HOROVOD_AUTOTUNE_LOG") \
            if self.enabled else ""
        self._log_file = None
        # update() runs on the cycle thread while StepStats feeds the
        # window from the training thread.
        self._lock = threading.Lock()
        self._steps = 0
        self._bytes = 0
        self._step_seconds = 0.0
        self._step_collective_seconds = 0.0
        self._step_observations = 0
        self._t0 = self._clock()
        self._samples = 0
        self._current = self._normalize_current()
        self.converged = not self.enabled
        self._adopt_world_history()
        if self.enabled:
            _STEP_OBSERVERS.append(self)
        # aggregation='leader': every rank holds the same values (the
        # synchronizer), so a cluster sum would inflate them.
        self._m_knob = M.gauge(
            "hvd_autotune_knob", "Current value of each tuned knob "
            "(bytes for thresholds, ms for cycle time, 0/1 for booleans)",
            labelnames=("knob",), aggregation="leader")
        self._m_converged = M.gauge(
            "hvd_autotune_converged",
            "1 once the Bayesian search pinned its best parameters "
            "(or tuning is disabled), else 0", aggregation="leader")
        self._m_samples = M.counter(
            "hvd_autotune_samples_total",
            "Scored autotune sample windows")
        self._m_converged.set(1.0 if self.converged else 0.0)
        self._publish_knob_gauges()

    def disable(self) -> None:
        """Turn tuning off and mark it settled (a follower, no store)."""
        self.enabled = False
        self.converged = True
        self._m_converged.set(1.0)

    # -- world-keyed trajectory (the live resize) ----------------------------
    def archive_world_history(self) -> None:
        """Archive the trajectory under this manager's world key, for the
        next manager built for that world (the grow-back warm start). The
        resize calls it before it tears the coordinator down; a plain
        shutdown does not, so a later run starts afresh."""
        if self._world is None or not self.enabled:
            return
        _WORLD_HISTORY[int(self._world)] = {
            "opt": self._opt,
            "samples": self._samples,
            "converged": self.converged,
            "warmup_remaining": self.warmup_remaining,
            "current": self._current,
        }

    def _adopt_world_history(self) -> None:
        if self._world is None or not self.enabled:
            return
        hist = _WORLD_HISTORY.get(int(self._world))
        if hist is None or hist["opt"].dims != self._opt.dims:
            return
        self._opt = hist["opt"]
        self._samples = hist["samples"]
        self.converged = hist["converged"]
        self.warmup_remaining = hist["warmup_remaining"]
        self._current = hist["current"]

    def reseed_for_world(self, world: int) -> None:
        """Archive the trajectory under its world key and restart tuning
        for ``world``, resuming that world's own archive when it was seen
        before. No-op when tuning is disabled."""
        if not self.enabled and self._world is None:
            return
        self.archive_world_history()
        self._world = int(world)
        self._opt = BayesianOptimizer(
            len(self._continuous) + len(self._ordinal) + len(_CATEGORICAL))
        self._samples = 0
        self.warmup_remaining = knobs.get("HOROVOD_AUTOTUNE_WARMUP_SAMPLES")
        with self._lock:
            self._steps = 0
            self._bytes = 0
            self._step_seconds = 0.0
            self._step_collective_seconds = 0.0
            self._step_observations = 0
            self._t0 = self._clock()
        if self.enabled:
            self.converged = False
            self._m_converged.set(0.0)
        self._current = self._normalize_current()
        self._adopt_world_history()
        if self.converged:
            self._m_converged.set(1.0)
        self._publish_knob_gauges()

    def _publish_knob_gauges(self) -> None:
        for name, _, _, _ in self._continuous:
            v = knobs.get(name)
            if isinstance(v, dict):
                v = v.get("local", next(iter(v.values())))
            self._m_knob.labels(knob=name).set(float(v))
        for name, choices in self._ordinal:
            idx = _ordinal_index(choices, str(knobs.get(name)))
            self._m_knob.labels(knob=name).set(float(idx))
        for name in _CATEGORICAL:
            self._m_knob.labels(knob=name).set(
                1.0 if knobs.get(name) else 0.0)

    # -- point <-> knob translation -----------------------------------------
    def _normalize_current(self) -> np.ndarray:
        vals = []
        for name, lo, hi, _ in self._continuous:
            v = knobs.get(name)
            if name == "HOROVOD_FUSION_THRESHOLD_CROSS" and not v:
                # 0 falls back to the base threshold (its cross entry when
                # per-axis): the first observation is scored at that.
                v = knobs.get("HOROVOD_FUSION_THRESHOLD")
                if isinstance(v, dict):
                    v = v.get("cross", next(iter(v.values())))
            if isinstance(v, dict):        # per-axis HOROVOD_FUSION_THRESHOLD
                v = v.get("local", next(iter(v.values())))
            v = float(v)
            if name.startswith("HOROVOD_FUSION_THRESHOLD"):
                v /= 1024 * 1024
            vals.append((min(max(v, lo), hi) - lo) / (hi - lo))
        for name, choices in self._ordinal:
            idx = _ordinal_index(choices, str(knobs.get(name)))
            vals.append(idx / max(len(choices) - 1, 1))
        for name in _CATEGORICAL:
            vals.append(1.0 if knobs.get(name) else 0.0)
        return np.asarray(vals)

    def _apply(self, x: np.ndarray) -> None:
        applied = {}
        for (name, lo, hi, conv), xi in zip(self._continuous, x):
            val = conv(lo + float(np.clip(xi, 0, 1)) * (hi - lo))
            knobs.set_override(name, val)
            applied[name] = val
        off = len(self._continuous)
        for (name, choices), xi in zip(self._ordinal, x[off:]):
            idx = int(round(float(np.clip(xi, 0, 1))
                            * (len(choices) - 1)))
            val = choices[idx]
            knobs.set_override(name, val)
            applied[name] = val
        off += len(self._ordinal)
        for name, xi in zip(_CATEGORICAL, x[off:]):
            val = bool(xi >= 0.5)
            knobs.set_override(name, val)
            applied[name] = val
        self._publish_knob_gauges()
        if self._sync:
            self._sync(applied)  # ref Controller::SynchronizeParameters

    # -- scoring loop --------------------------------------------------------
    def _observe_step(self, step_seconds: float,
                      collective_seconds: float = 0.0) -> None:
        """One training step's wall and blocked seconds (StepStats),
        folded into the current window's v2 score."""
        if not self.enabled or self.converged:
            return
        with self._lock:
            self._step_seconds += max(float(step_seconds), 0.0)
            self._step_collective_seconds += max(float(collective_seconds),
                                                 0.0)
            self._step_observations += 1

    def _window_score(self, dt: float) -> float:
        """The window's score. v1: bytes over the manager's own clock (ref
        parameter_manager.cc:44). v2, when StepStats fed the window: bytes
        per second of step wall time, discounted by the share of the steps
        spent blocked on collectives."""
        if self._step_observations > 0 and self._step_seconds > 0:
            exposed = min(self._step_collective_seconds
                          / self._step_seconds, 1.0)
            return (self._bytes / self._step_seconds) * (1.0 - exposed)
        return self._bytes / dt

    def update(self, tensor_bytes: int) -> bool:
        """Record one cycle. Returns True when parameters changed."""
        if not self.enabled or self.converged:
            return False
        with self._lock:
            self._steps += 1
            self._bytes += int(tensor_bytes)
            if self._steps < self.steps_per_sample:
                return False
            dt = max(self._clock() - self._t0, 1e-9)
            score = self._window_score(dt)
            self._steps = 0
            self._bytes = 0
            self._step_seconds = 0.0
            self._step_collective_seconds = 0.0
            self._step_observations = 0
            self._t0 = self._clock()
        if self.warmup_remaining > 0:
            self.warmup_remaining -= 1
            return False
        self._opt.observe(self._current, score)
        if self._log_path:
            if self._log_file is None:
                self._log_file = open(self._log_path, "w")
            row = ",".join(str(v) for v in
                           [self._samples, score, *self._current])
            self._log_file.write(row + "\n")
            self._log_file.flush()
        self._samples += 1
        self._m_samples.inc()
        if self._samples >= self.max_samples:
            best_x, best_y = self._opt.best
            self._apply(best_x)
            self.converged = True
            self._m_converged.set(1.0)
            get_logger("horovod_tpu_torch.autotune").info(
                "autotune converged: score=%.3g params=%s",
                best_y, knobs.snapshot())
            return True
        self._current = self._opt.suggest()
        self._apply(self._current)
        return True

    def close(self) -> None:
        if self in _STEP_OBSERVERS:
            _STEP_OBSERVERS.remove(self)
        self._log_path = ""
        if self._log_file:
            self._log_file.close()
            self._log_file = None


# ---------------------------------------------------------------------------
# gradient-bucket auto-resolution (HOROVOD_GRADIENT_BUCKET_BYTES=auto)
# ---------------------------------------------------------------------------

BUCKET_CANDIDATES_MIB = (8, 16, 25, 50, 100)
DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024


def _dtype_name(dtype) -> str:
    """A dtype as numpy names it (``float32``, ``bfloat16``): a torch
    dtype loses its ``torch.`` prefix, so both packages key a model
    alike."""
    return str(dtype).replace("torch.", "")


def grad_signature(leaves, world: int) -> str:
    """Cache key of the auto-bucket winner: ``<sha256[:16]>/n<world>``
    over the gradient leaves' (shape, dtype) pairs, sorted, in the JAX
    package's form. ``leaves`` may be tensors or (shape, dtype) pairs."""
    parts = []
    for leaf in leaves:
        if isinstance(leaf, tuple):
            shape, dtype = leaf
        else:
            shape, dtype = leaf.shape, leaf.dtype
        parts.append(f"{tuple(int(s) for s in shape)}:{_dtype_name(dtype)}")
    h = hashlib.sha256("|".join(sorted(parts)).encode()).hexdigest()[:16]
    return f"{h}/n{int(world)}"


def _link(value: Optional[float], name: str) -> float:
    if value is None:
        raise ValueError(
            f"{name} not given: the port carries no link constants (the "
            f"JAX package's are a TPU's); pass the term measured for the "
            f"card's links")
    return float(value)


def _ring_time(nbytes: float, n: int, gbps: float, hop_s: float,
               allreduce: bool = True) -> float:
    """Ring-collective seconds: allreduce moves 2(n-1)/n of the payload
    per rank (reduce-scatter + all-gather halves move (n-1)/n each)."""
    if n <= 1:
        return 0.0
    passes = 2 if allreduce else 1
    return (passes * (n - 1) / n * nbytes / (gbps * 1e9)
            + passes * (n - 1) * hop_s)


def collective_seconds(nbytes: int, n_devices: int, *,
                       schedule: str = "flat",
                       dcn_slices: int = 1,
                       wire_itemsize: Optional[int] = None,
                       src_itemsize: int = 4,
                       ici_gbps: Optional[float] = None,
                       ici_hop_s: Optional[float] = None,
                       dcn_gbps: Optional[float] = None,
                       dcn_hop_s: Optional[float] = None) -> float:
    """Model time of ONE gradient collective under a schedule, given the
    fast tier's (``ici_*``) and, across slices, the slow tier's
    (``dcn_*``) bandwidth in GB/s and latency per hop in seconds. A term
    the schedule needs and the caller did not give raises.

    - ``flat``: one ring over all ``n_devices``; across slices it moves at
      the slow tier's bandwidth and each slice boundary pays its latency.
    - ``two_level``: reduce-scatter on the fast tier, allreduce of the
      1/n_fast shard across slices, all-gather on the fast tier.
    - ``two_level_compressed``: the same, the shard narrowed to
      ``wire_itemsize`` bytes an element (``src_itemsize`` uncompressed).
    """
    ici_bw = _link(ici_gbps, "ici_gbps")
    ici_hop = _link(ici_hop_s, "ici_hop_s")
    n = max(int(n_devices), 2)
    slices = max(int(dcn_slices), 1)
    if slices <= 1:
        return _ring_time(nbytes, n, ici_bw, ici_hop)
    dcn_bw = _link(dcn_gbps, "dcn_gbps")
    dcn_hop = _link(dcn_hop_s, "dcn_hop_s")
    if schedule == "flat":
        t_bw = 2 * (n - 1) / n * nbytes / (dcn_bw * 1e9)
        t_lat = 2 * slices * dcn_hop + 2 * max(n - 1 - slices, 0) * ici_hop
        return t_bw + t_lat
    n_ici = max(n // slices, 1)
    shard = nbytes / max(n_ici, 1)
    if schedule == "two_level_compressed" and wire_itemsize:
        shard = shard * wire_itemsize / max(src_itemsize, 1)
    rs = _ring_time(nbytes, n_ici, ici_bw, ici_hop, allreduce=False)
    x = _ring_time(shard, slices, dcn_bw, dcn_hop)
    ag = _ring_time(nbytes, n_ici, ici_bw, ici_hop, allreduce=False)
    return rs + x + ag


def score_bucket_schedule(grad_ars, n_devices: int,
                          ring_gbps: Optional[float] = None,
                          hop_latency_s: Optional[float] = None,
                          schedule: str = "flat",
                          dcn_slices: int = 1,
                          wire_itemsize: Optional[int] = None,
                          dcn_gbps: Optional[float] = None,
                          dcn_hop_latency_s: Optional[float] = None) -> Dict:
    """Model-exposed communication seconds of one step's gradient
    collectives. ``grad_ars``: one row per collective (``bytes``,
    ``hideable_fusions`` or ``hideable_conv_fusions`` and the matching
    ``*_total``); each costs :func:`collective_seconds` under the given
    link terms, and its hideable share of the backward overlaps it."""
    exposed = comm = 0.0
    weighted_hideable = total_bytes = 0
    for r in grad_ars:
        nbytes = int(r["bytes"])
        hideable = int(r.get("hideable_conv_fusions",
                             r.get("hideable_fusions", 0)))
        total = max(int(r.get("conv_fusions_total",
                              r.get("fusions_total", 1))), 1)
        frac = hideable / total
        t = collective_seconds(
            nbytes, n_devices, schedule=schedule, dcn_slices=dcn_slices,
            wire_itemsize=wire_itemsize, ici_gbps=ring_gbps,
            ici_hop_s=hop_latency_s, dcn_gbps=dcn_gbps,
            dcn_hop_s=dcn_hop_latency_s)
        comm += t
        exposed += t * (1.0 - frac)
        weighted_hideable += nbytes * frac
        total_bytes += nbytes
    return {
        "collectives": len(grad_ars),
        "schedule": schedule,
        "comm_s": comm,
        "exposed_comm_s": exposed,
        "hideable_fraction_weighted": (
            weighted_hideable / total_bytes if total_bytes else 0.0),
    }


DCN_SCHEDULE_CANDIDATES = ("flat", "two_level")


def score_dcn_schedules(payload_bytes: int, ici_world: int,
                        dcn_world: int,
                        wire_itemsize: Optional[int] = None,
                        **link) -> Dict:
    """Model-score flat, two-level and two-level compressed for one
    payload on a DCN-tiered mesh under the link terms ``link`` (the
    keyword arguments of :func:`collective_seconds`). ``winner`` is the
    cheaper of the two schedules that keep the numerics."""
    n = max(int(ici_world), 1) * max(int(dcn_world), 1)
    rows = {}
    for sched in ("flat", "two_level", "two_level_compressed"):
        wi = wire_itemsize if sched == "two_level_compressed" else None
        if sched == "two_level_compressed" and not wire_itemsize:
            continue
        rows[sched] = {
            "comm_s": collective_seconds(
                int(payload_bytes), n, schedule=sched,
                dcn_slices=dcn_world, wire_itemsize=wi, **link),
        }
    winner = min(("flat", "two_level"),
                 key=lambda s: rows[s]["comm_s"])
    return {
        "payload_bytes": int(payload_bytes),
        "ici_world": int(ici_world),
        "dcn_world": int(dcn_world),
        "schedules": rows,
        "winner": winner,
        "latency_model": dict(link),
    }


_dcn_auto_logged: List[bool] = []


def resolve_dcn_schedule(payload_bytes: int, ici_world: int,
                         dcn_world: int) -> str:
    """The schedule of one sync whose axes cross the DCN tier: 'flat' when
    either tier has one rank, else HOROVOD_DCN_SCHEDULE, with 'auto'
    resolving 'flat' (no link constants; see the module docstring).
    Exported as the ``hvd_dcn_schedule`` gauge (0 flat, 1 two_level)."""
    mode = str(knobs.get("HOROVOD_DCN_SCHEDULE"))
    if int(dcn_world) <= 1 or int(ici_world) <= 1:
        resolved = "flat"
    elif mode != "auto":
        resolved = mode
    else:
        resolved = "flat"
        if not _dcn_auto_logged:
            _dcn_auto_logged.append(True)
            get_logger("horovod_tpu_torch.autotune").info(
                "HOROVOD_DCN_SCHEDULE=auto resolves 'flat': the ICI-vs-DCN "
                "cost model's constants are a TPU's and the card's links "
                "are not measured yet; set 'two_level' to force the tier.")
    from horovod_tpu_torch import metrics as M
    M.gauge("hvd_dcn_schedule",
            "Schedule of the most recent DCN-tiered gradient sync "
            "(0 = flat, 1 = two_level); absent on single-slice meshes",
            aggregation="leader").set(1.0 if resolved == "two_level"
                                      else 0.0)
    return resolved


def _dcn_tier_present() -> bool:
    """Whether this run has a DCN tier the schedule could steer: a
    virtual-slice or mesh knob, or an initialized topology with the
    ``hvd_dcn`` axis."""
    if int(knobs.get("HOROVOD_DCN_VIRTUAL_SLICES") or 0) > 1:
        return True
    if str(knobs.get("HOROVOD_DCN_MESH") or "").strip():
        return True
    from horovod_tpu_torch.runtime import context
    if not context.is_initialized():
        return False
    return context.get_context().topology.has_dcn


def auto_bucket_search(compile_eval: Callable[[int], list],
                       n_devices: int, candidates=None, **link) -> Dict:
    """Score each candidate bucket size's collective rows
    (``compile_eval(bucket_bytes)``, see :func:`score_bucket_schedule`)
    under the link terms ``link`` (``ring_gbps``, ``hop_latency_s``) and
    pick the least exposed communication, ties going to fewer
    collectives. The port fills its cache from measurements instead
    (:func:`sweep_bucket_bytes`)."""
    rows = {}
    for mib in (candidates or BUCKET_CANDIDATES_MIB):
        bb = int(mib) << 20
        rows[bb] = score_bucket_schedule(compile_eval(bb), n_devices,
                                         **link)
    winner = _winner(rows)
    return {"candidates": rows, "winner_bucket_bytes": winner,
            "latency_model": {**link, "n_devices": int(n_devices)}}


def _winner(rows: Dict[Any, Dict]) -> Any:
    """JAX's rule: the least exposed communication, ties to fewer
    collectives."""
    return min(rows, key=lambda bb: (rows[bb]["exposed_comm_s"],
                                     rows[bb]["collectives"]))


def profiled_step_row(events, bucket_bytes: Sequence[int],
                      device: Optional[bool] = None) -> Dict:
    """One profiled step's row for :func:`score_measured_steps`, from its
    trace events (``tracing.profile.read_trace_events`` of a
    ``StepProfiler`` window of one step): each bucket of the plan, in
    launch order, with its bytes, the device seconds of the collectives
    launched under its ``hvd_bucket<k>`` label and the part of them that
    overlapped compute; and the step's exposed collective seconds."""
    from horovod_tpu_torch.tracing import profile
    events = list(events)
    by = profile.bucket_collective_seconds(events, device)
    buckets = []
    for k, nbytes in enumerate(bucket_bytes):
        coll, overlapped = by.get(f"hvd_bucket{k}", (0.0, 0.0))
        buckets.append({"bytes": int(nbytes), "nccl_seconds": coll,
                        "overlapped_seconds": overlapped})
    exposed = profile.attribute(events, steps=1, device=device)[
        "exposed_collective_seconds_per_step"]
    if exposed is None:
        raise ValueError("the profiled step has no device events: nothing "
                         "was measured")
    return {"buckets": buckets,
            "exposed_collective_seconds_per_step": float(exposed)}


def score_measured_steps(steps: Sequence[Dict]) -> Dict:
    """One candidate's score from its profiled steps (rows of
    :func:`profiled_step_row`): the medians over the steps of the exposed
    collective seconds and of the collectives' device seconds, the exposed
    time's spread (min, max), the per-bucket medians, and the number of
    collectives (buckets)."""
    if not steps:
        raise ValueError("a candidate needs at least one profiled step")
    n = {len(s["buckets"]) for s in steps}
    if len(n) != 1:
        raise ValueError(f"the profiled steps ran different bucket plans: "
                         f"{sorted(n)} buckets")
    exposed = [float(s["exposed_collective_seconds_per_step"])
               for s in steps]
    comm = [sum(float(b["nccl_seconds"]) for b in s["buckets"])
            for s in steps]
    buckets = [{"bytes": int(steps[0]["buckets"][k]["bytes"]),
                **{f: float(np.median([float(s["buckets"][k][f])
                                       for s in steps]))
                   for f in ("nccl_seconds", "overlapped_seconds")}}
               for k in range(n.pop())]
    return {"collectives": len(buckets),
            "comm_s": float(np.median(comm)),
            "exposed_comm_s": float(np.median(exposed)),
            "exposed_comm_s_spread": [min(exposed), max(exposed)],
            "exposed_comm_s_steps": exposed,
            "steps": len(steps),
            "buckets": buckets}


def sweep_bucket_bytes(measure: Callable[[int], Sequence[Dict]],
                       n_devices: int, *, workload: str, leaves,
                       candidates=BUCKET_CANDIDATES_MIB) -> Dict:
    """Fill the auto-bucket cache for one model and world from
    measurements. ``measure(bucket_bytes)`` runs profiled steps of the
    model at that bucket size and returns one :func:`profiled_step_row`
    each; the winner has the least median exposed collective time, ties
    going to fewer collectives.

    A sweep persisted in the artifact store for (:func:`grad_signature`
    of ``leaves`` and ``n_devices``, ``workload``) is served warm and
    nothing is measured. Otherwise every candidate is measured and the
    record persisted. Rank 0 writes the winner to the cache and publishes
    it over the c10d store; the other ranks adopt it and write it to
    their cache. Every rank must call this (the steps ``measure`` runs are
    collective) and see the same artifact store. Returns the sweep record
    with ``winner_bucket_bytes``, ``measured_candidates`` and ``warm``."""
    from horovod_tpu_torch.utils import schedhooks
    sig = grad_signature(leaves, n_devices)
    record = load_auto_sweep(sig, workload)
    warm = record is not None
    if not warm:
        rows = {}
        for mib in candidates:
            bb = int(mib) << 20
            rows[bb] = score_measured_steps(measure(bb))
        record = {"cache_key": sig, "workload": str(workload),
                  "sweep": {"evidence": "measured",
                            "n_devices": int(n_devices),
                            "candidates": {str(bb): r
                                           for bb, r in rows.items()},
                            "winner_bucket_bytes": int(_winner(rows))}}
    winner = int(record["sweep"]["winner_bucket_bytes"])
    leader = schedhooks.process_world()[0] == 0
    if leader:
        bucket_cache_store(sig, winner)
        if not warm:
            persist_auto_sweep(sig, workload, record)
    winner = _broadcast_resolution(sig, winner)
    if not leader:
        bucket_cache_store(sig, winner)
    return {**record, "winner_bucket_bytes": winner,
            "measured_candidates": 0 if warm else len(candidates),
            "warm": warm}


def _bucket_auto_store_key(store, sig: str, workload: str):
    return store.key("bucket_auto_sweep", grad_signature=sig,
                     workload=str(workload))


def load_auto_sweep(sig: str, workload: str) -> Optional[Dict]:
    """The sweep record persisted in the artifact store for (grad
    signature, workload), or None (no store, or a miss). A hit skips
    every candidate's measurement, counted by
    ``hvd_bucket_auto_warm_hits_total``."""
    from horovod_tpu_torch.store import artifact_store as _store_mod
    store = _store_mod.from_env()
    if store is None:
        return None
    obj = store.load_blob(_bucket_auto_store_key(store, sig, workload))
    if obj is not None:
        from horovod_tpu_torch import metrics as M
        M.counter(
            "hvd_bucket_auto_warm_hits_total",
            "Bucket-auto sweeps served warm from the artifact store "
            "(all candidate measurements skipped)").inc()
        get_logger("horovod_tpu_torch.autotune").info(
            "bucket auto: warm sweep for %s/%s from the artifact store "
            "— %d candidate measurements skipped",
            sig, workload, len(obj.get("sweep", {}).get("candidates", ())))
    return obj


def persist_auto_sweep(sig: str, workload: str, record: Dict) -> bool:
    """Publish a completed sweep's record, so that the next process's
    :func:`load_auto_sweep` measures nothing. False when the store is off
    or the publish failed (logged, never raised)."""
    from horovod_tpu_torch.store import artifact_store as _store_mod
    store = _store_mod.from_env()
    if store is None:
        return False
    return store.publish_blob(
        _bucket_auto_store_key(store, sig, workload), record,
        extra_meta={"label": f"bucket_auto:{workload}"})


def _bucket_cache_path() -> str:
    path = knobs.get("HOROVOD_BUCKET_AUTO_CACHE")
    if path:
        return os.path.expanduser(str(path))
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "horovod_tpu_torch", "bucket_auto.json")


def bucket_cache_load() -> Dict[str, int]:
    try:
        with open(_bucket_cache_path()) as f:
            data = json.load(f)
        return {str(k): int(v) for k, v in data.items()}
    except (OSError, ValueError):
        return {}


@contextlib.contextmanager
def _cache_locked(path: str):
    """Serialize the cache's read-modify-write across processes (a lock
    file; unlocked where fcntl is missing)."""
    try:
        import fcntl
    except ImportError:
        yield
        return
    with open(path + ".lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def bucket_cache_store(key: str, bucket_bytes: int) -> None:
    """Write one winner to the cache: under the lock, atomically, and
    loudly when it replaces a different winner (two sweeps of one key on
    different links: the last one wins)."""
    path = _bucket_cache_path()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with _cache_locked(path):
        data = bucket_cache_load()
        prev = data.get(str(key))
        if prev is not None and int(prev) != int(bucket_bytes):
            get_logger("horovod_tpu_torch.autotune").warning(
                "bucket auto-cache: overwriting %s: %d -> %d bytes (a "
                "sweep over other links with the same world size? "
                "training-time auto resolves whichever sweep ran last)",
                key, int(prev), int(bucket_bytes))
        data[str(key)] = int(bucket_bytes)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)    # readers see the old file or the new


_auto_miss_warned = set()


def _broadcast_resolution(sig: str, resolved: int, kv=None,
                          leader=None) -> int:
    """Make every rank bucket alike: rank 0's resolution is published on
    the c10d store and the others adopt it, since host-local caches may
    differ and differently bucketed ranks would issue different
    collectives. A rank that cannot fetch it within the timeout keeps its
    own value and warns. A no-op in a world of one."""
    from horovod_tpu_torch.utils import schedhooks
    rank, world = schedhooks.process_world()
    if kv is None:
        if world <= 1:
            return resolved
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        kv = distributed_kv(site="autotune")
        if kv is None:
            return resolved
    if leader is None:
        leader = rank == 0
    key = f"hvd/bucket_auto/{sig}"
    if leader:
        kv.set(key, str(int(resolved)), overwrite=True)
        return resolved
    try:
        return int(kv.get(key, 120.0))
    except Exception:
        get_logger("horovod_tpu_torch.autotune").warning(
            "HOROVOD_GRADIENT_BUCKET_BYTES=auto: rank 0 did not publish a "
            "bucket resolution for %s — keeping this rank's local value "
            "%d. If the ranks' bucket caches differ their gradient syncs "
            "will diverge; make the cache file (%s) the same on every "
            "host or set a numeric bucket size.", sig, resolved,
            _bucket_cache_path(), exc_info=True)
        return resolved


def resolve_bucket_bytes(leaves=None, world=None) -> int:
    """The effective gradient bucket size in bytes (0 = one bucket).

    A number passes through. 'auto' resolves the cached sweep winner of
    the (``leaves`` = [(shape, dtype)], ``world``) key; a miss falls back
    to :data:`DEFAULT_BUCKET_BYTES` with a warning, once per key, naming
    the sweep. In a world of several ranks rank 0's resolution is adopted
    by every rank. Exported as the ``hvd_gradient_bucket_bytes`` gauge."""
    raw = knobs.get("HOROVOD_GRADIENT_BUCKET_BYTES")
    if raw != "auto":
        resolved = int(raw or 0)
    else:
        resolved = DEFAULT_BUCKET_BYTES
        sig = miss = None
        if leaves is not None and world is not None:
            sig = miss = grad_signature(leaves, world)
            cached = bucket_cache_load().get(sig)
            if cached is not None:
                resolved = int(cached)
                miss = None
        if miss is not None and miss not in _auto_miss_warned:
            _auto_miss_warned.add(miss)
            get_logger("horovod_tpu_torch.autotune").warning(
                "HOROVOD_GRADIENT_BUCKET_BYTES=auto: no cached sweep winner "
                "for key %s (cache %s) — using the %d MiB default. Run "
                "horovod_tpu_torch.autotune.sweep_bucket_bytes over "
                "profiled steps of this model at this world size to "
                "measure bucket sizes and cache the winner.",
                miss, _bucket_cache_path(), DEFAULT_BUCKET_BYTES >> 20)
        resolved = _broadcast_resolution(sig or "default", resolved)
    from horovod_tpu_torch import metrics as M
    M.gauge("hvd_gradient_bucket_bytes",
            "Effective HOROVOD_GRADIENT_BUCKET_BYTES for the most recent "
            "gradient-sync plan (after 'auto' cache resolution); 0 = "
            "single fused buffer", aggregation="leader").set(float(resolved))
    return resolved


# ---------------------------------------------------------------------------
# cross-rank parameter synchronization (ref Controller::SynchronizeParameters
# controller.cc:40-54: the coordinator rank broadcasts tuned values)
# ---------------------------------------------------------------------------

class ParameterSynchronizer:
    """Keeps the tunable knobs in lockstep across ranks.

    The LEADER (rank 0) runs the ParameterManager on its own scores and at
    every cycle boundary publishes the tunable-knob snapshot under a
    cycle-indexed key; the FOLLOWERS fetch the same key at the same cycle
    and apply it. Deterministic dispatch brings every rank to the same
    cycle boundaries in the same order, so the (cycle, knobs) trajectory,
    and with it every bin plan and flush point, is the same everywhere.
    Once the leader converges it publishes a final marker and both sides
    go quiet."""

    def __init__(self, kv, leader: bool, prefix: str = "hvd/autotune",
                 timeout: float = 300.0):
        self._kv = kv
        self.is_leader = leader
        self._prefix = prefix
        self._timeout = timeout
        self.done = False
        # True when `done` came from a degraded-mode freeze (leader side):
        # the coordinator then disables its tuner.
        self.frozen = False
        # (cycle, {knob: value}) pairs published or applied.
        self.history: List[tuple] = []

    def _key(self, cycle: int) -> str:
        return f"{self._prefix}/{cycle}"

    @staticmethod
    def _tunable_snapshot() -> Dict:
        return {name: knobs.get(name)
                for name, kn in knobs.knobs().items() if kn.tunable}

    def publish(self, cycle: int, converged: bool) -> None:
        """Leader side: publish this cycle's knob values.

        When the fault domain sheds the 'autotune' site, or the
        publication exhausts its retry budget, the leader FREEZES: it
        marks this cycle final at the current snapshot (followers adopt
        the same values) and sets ``frozen`` so the coordinator disables
        its tuner. A follower never freezes on its own: a healthy leader
        would tune past it. If the final publication cannot land, the
        followers stop loudly at their timeout. A semantic error (a key
        reused: ALREADY_EXISTS) raises."""
        if self.done:
            return
        from horovod_tpu_torch.resilience import faults
        freeze = faults.should_shed("autotune")
        snap = self._tunable_snapshot()
        final = bool(converged or freeze)
        try:
            self._kv.set(self._key(cycle),
                         json.dumps({"final": final, "knobs": snap}))
        except Exception as e:
            if not (isinstance(e, faults.RetryBudgetExhausted)
                    or faults.is_transient(e)):
                raise
            get_logger("horovod_tpu_torch.autotune").warning(
                "autotune sync: publication for cycle %d failed; "
                "freezing the knob trajectory (tuner disabled). "
                "Followers that never receive a final marker will stop "
                "loudly at their sync timeout.", cycle, exc_info=True)
            self.done = True
            self.frozen = True
            return
        self.history.append((cycle, snap))
        if final:
            self.done = True
            self.frozen = self.frozen or freeze
            if freeze:
                get_logger("horovod_tpu_torch.autotune").warning(
                    "autotune sync shed (fault domain degraded): final "
                    "knob values published at cycle %d; trajectory "
                    "frozen for the rest of the run", cycle)

    def apply(self, cycle: int) -> None:
        """Follower side: fetch and apply the leader's values for this
        cycle, blocking. The fetch goes in chunks of at most 15 s; after
        ``timeout`` in all it raises a descriptive RuntimeError, never a
        silent freeze at stale values (a live leader would tune past
        them and the ranks' bins would diverge)."""
        if self.done:
            return
        deadline = time.monotonic() + self._timeout
        while True:
            chunk = min(15.0, max(1.0, deadline - time.monotonic()))
            try:
                raw = self._kv.get(self._key(cycle), chunk)
                break
            except Exception as e:
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"autotune parameter sync: leader (rank 0) never "
                        f"published knob values for cycle {cycle} within "
                        f"{self._timeout:.0f}s — leader crashed or stalled. "
                        f"Disable HOROVOD_AUTOTUNE or restart the job; "
                        f"continuing with unsynchronized knobs would "
                        f"desynchronize fused dispatch across ranks."
                    ) from e
        msg = json.loads(raw)
        for name, val in msg["knobs"].items():
            knobs.set_override(name, val)
        self.history.append((cycle, dict(msg["knobs"])))
        if msg["final"]:
            self.done = True


# Generation counter: the c10d store's keys outlive shutdown()+init() in a
# process, so each synchronizer gets a fresh prefix. Every rank creates the
# same number of synchronizers, so the prefixes agree without coordination.
_sync_generation = 0
_sync_generation_lock = threading.Lock()


def make_parameter_synchronizer(kv=None, leader=None):
    """The synchronizer of this process over the c10d store (site
    ``autotune``), or None when there is no store (a world of one)."""
    global _sync_generation
    from horovod_tpu_torch.utils import schedhooks
    if kv is None:
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        kv = distributed_kv(site="autotune")
    if kv is None:
        return None
    if leader is None:
        leader = schedhooks.process_world()[0] == 0
    with _sync_generation_lock:
        gen = _sync_generation
        _sync_generation += 1
    return ParameterSynchronizer(kv, leader,
                                 prefix=f"hvd/autotune/g{gen}")
