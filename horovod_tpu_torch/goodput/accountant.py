"""Time-attribution accountant: the goodput state machine.

The port's copy of ``horovod_tpu/goodput/accountant.py``: the same phase
catalog, attribution primitives and report; ``init_begin`` re-arms the
run ledger's once-per-run record (``goodput/ledger.py``).

One process-global wall-clock timeline, partitioned so that every second
since the accountant's epoch is attributed to exactly ONE phase — the
invariant the phase breakdown rests on is ``sum(phases) == total`` (the
report computes both from the same ``perf_counter`` read, so a bench run
can assert the sum closes within 1%).

Two attribution primitives:

- :func:`set_phase` — the AMBIENT phase: what the process is doing now
  (the train loop drives input-wait/step-compute/checkpoint/restart;
  ``init`` drives init; everything else is idle). Elapsed time
  accrues to the current phase until the next transition.
- :func:`carve` — RETROSPECTIVE reattribution: a signal source that
  measured a sub-interval inside the ambient phase (StepStats' exposed
  handle-wait seconds, a retry backoff, a checkpoint's device->host
  copy) moves that many seconds from the ambient bucket into its own
  phase. Carves clamp at what the source bucket
  holds, so the total is preserved no matter how signals race.

Threading: one lock guards the whole accumulator; both primitives are a
few float ops under it, and nothing blocking ever runs while it is held.
Signals arrive from the train loop and the checkpoint writer thread;
attribution across threads shares the single timeline, which is the
point: wall time, not CPU time.

The OFF path (``HOROVOD_GOODPUT=0``): every module-level helper returns
immediately on a plain bool read — no lock, no allocation.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.goodput")

# The phase catalog. Every second of run wall time lands in exactly one.
INIT = "init"                          # init / process bring-up
COMPILE = "compile"                    # kernel builds and compiles
STEP_COMPUTE = "step_compute"          # useful training work — THE goodput
EXPOSED_COLLECTIVE = "exposed_collective"  # blocked on collectives (waits)
INPUT_WAIT = "input_wait"              # waiting on the data pipeline
CHECKPOINT = "checkpoint"              # on-step-path checkpoint cost
RESTART = "restart"                    # restore/rollback after a (re)start
DEGRADED = "degraded"                  # retry backoffs / degraded operation
IDLE = "idle"                          # none of the above

PHASES = (INIT, COMPILE, STEP_COMPUTE, EXPOSED_COLLECTIVE, INPUT_WAIT,
          CHECKPOINT, RESTART, DEGRADED, IDLE)

# Phases counted as goodput: useful training work only. Exposed
# collective time is deliberately excluded: it is wall time the step
# spent blocked.
GOODPUT_PHASES = (STEP_COMPUTE,)


class GoodputAccountant:
    """The per-process phase accumulator (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._acc: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._cur = INIT
        self._since = self._epoch
        self._transitions = 0
        self._carved: Dict[str, float] = {}

    # -- internals (call with the lock held) ---------------------------------
    def _flush_locked(self, now: float) -> None:
        self._acc[self._cur] += max(now - self._since, 0.0)
        self._since = now

    # -- the two attribution primitives --------------------------------------
    def set_phase(self, phase: str) -> str:
        """Transition the ambient phase; returns the previous one."""
        if phase not in self._acc:
            raise ValueError(f"unknown goodput phase {phase!r} "
                             f"(catalog: {PHASES})")
        with self._lock:
            now = time.perf_counter()
            self._flush_locked(now)
            prev, self._cur = self._cur, phase
            self._transitions += 1
            return prev

    def carve(self, to_phase: str, seconds: float,
              from_phase: Optional[str] = None) -> float:
        """Move up to ``seconds`` from ``from_phase`` (default: the
        current ambient phase) into ``to_phase``; returns what actually
        moved (clamped at the source bucket — total preserved)."""
        if to_phase not in self._acc:
            raise ValueError(f"unknown goodput phase {to_phase!r}")
        with self._lock:
            now = time.perf_counter()
            self._flush_locked(now)
            src = from_phase if from_phase is not None else self._cur
            moved = min(max(float(seconds), 0.0), self._acc.get(src, 0.0))
            if moved > 0.0:
                self._acc[src] -= moved
                self._acc[to_phase] += moved
                self._carved[to_phase] = \
                    self._carved.get(to_phase, 0.0) + moved
            return moved

    # -- reads ---------------------------------------------------------------
    @property
    def current_phase(self) -> str:
        return self._cur

    def report(self) -> Dict[str, Any]:
        """The full breakdown. ``sum(phases.values())`` equals
        ``total_seconds`` exactly (both derive from one clock read);
        rounding is the only slack, hence the 1% acceptance margin."""
        with self._lock:
            now = time.perf_counter()
            self._flush_locked(now)
            phases = dict(self._acc)
            total = now - self._epoch
            cur = self._cur
            transitions = self._transitions
        good = sum(phases[p] for p in GOODPUT_PHASES)
        return {
            "total_seconds": round(total, 6),
            "attributed_seconds": round(sum(phases.values()), 6),
            "phases": {p: round(v, 6) for p, v in phases.items()},
            "goodput_seconds": round(good, 6),
            "goodput_fraction": round(good / total, 6) if total > 0 else 0.0,
            "current_phase": cur,
            "transitions": transitions,
        }


# ---------------------------------------------------------------------------
# process-global instance + the cheap module-level API every signal
# source calls (OFF path: one bool read)
# ---------------------------------------------------------------------------

_accountant: Optional[GoodputAccountant] = None
_enabled = False
_gauges_installed = False
_lifecycle_lock = threading.Lock()


def get_accountant() -> GoodputAccountant:
    global _accountant
    with _lifecycle_lock:
        if _accountant is None:
            _accountant = GoodputAccountant()
        return _accountant


def enabled() -> bool:
    return _enabled


def current_phase() -> str:
    """The ambient phase (``'untracked'`` while accounting is off) —
    the tag the timeline's cycle markers carry so Perfetto and the
    accountant agree on phase boundaries."""
    if not _enabled or _accountant is None:
        return "untracked"
    return _accountant.current_phase


def set_phase(phase: str) -> None:
    if _enabled and _accountant is not None:
        _accountant.set_phase(phase)


def carve(to_phase: str, seconds: float,
          from_phase: Optional[str] = None) -> float:
    if not _enabled or _accountant is None or seconds <= 0:
        return 0.0
    return _accountant.carve(to_phase, seconds, from_phase=from_phase)


@contextmanager
def phase_scope(phase: str):
    """Ambient phase for a ``with`` body, restoring the previous phase
    on exit (the restore/checkpoint/drain call sites)."""
    if not _enabled or _accountant is None:
        yield
        return
    prev = _accountant.set_phase(phase)
    try:
        yield
    finally:
        _accountant.set_phase(prev)


def goodput_report() -> Dict[str, Any]:
    """Public API: the live phase breakdown and goodput fraction.
    Available even before ``init()`` (the accountant is created on first
    use, phase ``init``)."""
    return get_accountant().report()


def health_block() -> Optional[Dict[str, Any]]:
    """The compact ``goodput`` block of a health report (None while
    accounting is off)."""
    if not _enabled or _accountant is None:
        return None
    r = _accountant.report()
    return {"fraction": r["goodput_fraction"],
            "phase": r["current_phase"],
            "total_seconds": r["total_seconds"]}


# ---------------------------------------------------------------------------
# lifecycle: wired from init() (runtime/context.py)
# ---------------------------------------------------------------------------

def init_begin() -> None:
    """Called at the top of ``init()``: resolve the enable knob and
    enter the ``init`` phase (idempotent across init/shutdown cycles —
    the accumulator, like the metrics registry, survives in-process)."""
    global _enabled
    from horovod_tpu_torch.goodput import ledger as _ledger
    _ledger._mark_run_start()
    _enabled = bool(knobs.get("HOROVOD_GOODPUT"))
    if not _enabled:
        return
    acc = get_accountant()
    acc.set_phase(INIT)


def init_end() -> None:
    """Called when ``init()`` completes: ``init`` ends, gauges and
    the scrape-time collector come up."""
    if not _enabled:
        return
    get_accountant().set_phase(IDLE)
    _install_gauges()


def _install_gauges() -> None:
    """``hvd_goodput_fraction`` + ``hvd_goodput_phase_seconds{phase=}``,
    refreshed at scrape time. ``leader`` aggregation: each process owns
    its own timeline; summing fractions across hosts would be
    meaningless."""
    global _gauges_installed
    with _lifecycle_lock:
        if _gauges_installed:
            return
        _gauges_installed = True
    from horovod_tpu_torch import metrics as M
    g_frac = M.gauge(
        "hvd_goodput_fraction",
        "Fraction of run wall time attributed to step compute "
        "(goodput accountant)",
        aggregation="leader")
    g_phase = M.gauge(
        "hvd_goodput_phase_seconds",
        "Run wall time attributed per goodput phase; the phases "
        "partition the timeline (sum == total)",
        labelnames=("phase",), aggregation="leader")

    def _collect():
        if not _enabled or _accountant is None:
            return
        r = _accountant.report()
        g_frac.set(r["goodput_fraction"])
        for p, v in r["phases"].items():
            g_phase.labels(phase=p).set(v)

    M.get_registry().register_collector(_collect)


def reset_for_tests() -> None:
    """Fresh accountant + disabled state (unit tests only). The gauge
    collector stays installed — it reads through the module globals."""
    global _accountant, _enabled
    with _lifecycle_lock:
        _accountant = None
        _enabled = False
