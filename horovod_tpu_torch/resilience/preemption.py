"""Preemption-aware shutdown: catch the eviction notice, quiesce every
rank at the same step, commit a final synchronous snapshot, exit
resumable.

The port's copy of ``horovod_tpu/resilience/preemption.py``. Trigger
sources (any of them arms the handler):

- **SIGTERM / SIGINT**: what a node drain, a k8s pod eviction or an
  operator's Ctrl-C delivers;
- **sentinel file** (``HOROVOD_PREEMPTION_FILE``): for node agents that
  relay scheduled maintenance by touching a file. Files older than the
  handler are ignored, so a leftover notice from the previous incarnation
  cannot stop the resumed run;
- **programmatic**: ``handler.request(...)`` (the chaos harness's fake
  notice uses this).

Quiesce protocol (several ranks): the first rank that observes a trigger
publishes ``stop_step = its current step + QUIESCE_MARGIN`` to the c10d
store of the default process group (write-once, ``compare_set``:
concurrent triggers agree on whoever won). Every rank polls the key from
``check()`` and stops at the published step, so all ranks snapshot the
SAME step. A rank already past the published step stops at once and logs
the skew. The c10d store lives as long as the process group, so the key
carries the handler's sequence number among the handlers this process
made as the same (rank, world size): every rank makes its handlers in the
same order, and a later handler never reads an earlier one's stop step.
Counting per (rank, world size), not per process, lets the ranks that the
model checker (``analysis.model``) plays in one process agree too.

Exit contract: ``RESUMABLE_EXIT_CODE`` (75, EX_TEMPFAIL) tells the
launcher the run ended with durable state on purpose; it relaunches and
the loop restores the latest committed snapshot.
"""

from __future__ import annotations

import itertools
import os
import signal
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils import schedhooks
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.resilience")

# EX_TEMPFAIL: "try again later" — the run is restartable from its own
# committed state. Distinct from the elastic RESTART_EXIT_CODE (73),
# which means "re-rendezvous me, my in-memory world is stale".
RESUMABLE_EXIT_CODE = 75

_KV_STOP_KEY = "hvd_preempt/stop_step"
# (rank, world size) -> the sequence of that identity's handlers
_handler_seqs: Dict[Tuple[int, int], Iterator[int]] = {}
_handler_seqs_lock = threading.Lock()


def _next_handler_seq() -> int:
    world = schedhooks.process_world()
    with _handler_seqs_lock:
        seq = _handler_seqs.setdefault(world, itertools.count())
        return next(seq)

_active_handler: Optional["PreemptionHandler"] = None
_active_lock = threading.Lock()


def active_handler() -> Optional["PreemptionHandler"]:
    """The process's installed handler (the train loop and the fault
    domain consult it), or None."""
    return _active_handler


class PreemptionHandler:
    """See module docstring. One per process at a time: constructing it
    registers it as the process-global handler (:func:`active_handler`)."""

    def __init__(self, checkpointer: Optional[Any] = None,
                 sentinel: Optional[str] = None,
                 margin: Optional[int] = None,
                 install_signals: bool = True):
        from horovod_tpu_torch import metrics as M
        self.checkpointer = checkpointer
        self.sentinel = (knobs.get("HOROVOD_PREEMPTION_FILE")
                         if sentinel is None else sentinel) or None
        self.margin = (knobs.get("HOROVOD_PREEMPTION_QUIESCE_MARGIN")
                       if margin is None else int(margin))
        self._m_notices = M.counter(
            "hvd_preemption_notices_total",
            "Preemption triggers observed", labelnames=("source",))
        self._m_stop_step = M.gauge(
            "hvd_preemption_stop_step",
            "Agreed quiesce step of an in-progress preemption (0 = none)",
            aggregation="leader")
        self._requested = schedhooks.Event()
        self._flight_dumped = False
        self._pending_signal: Optional[int] = None
        self._reason: Optional[str] = None
        self._stop_step: Optional[int] = None
        self._published = False
        self._last_kv_poll = 0.0
        self._start_time = time.time()
        self._stop_key = f"{_KV_STOP_KEY}/{_next_handler_seq()}"
        self._stop_watch = schedhooks.Event()
        self._prev_handlers = {}
        if install_signals:
            self._install_signals()
        if self.sentinel:
            schedhooks.Thread(target=self._watch_sentinel,
                              name="hvd-preempt-watch", daemon=True).start()
        with _active_lock:
            global _active_handler
            _active_handler = self

    # -- triggers -----------------------------------------------------------
    def _install_signals(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            logger.warning("PreemptionHandler created off the main "
                           "thread; SIGTERM/SIGINT hooks not installed")
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._on_signal)
            except (ValueError, OSError):   # pragma: no cover
                pass

    def _on_signal(self, signum, frame) -> None:
        # Async-signal-safe only: a plain attribute store (GIL-atomic).
        # request() takes the metrics lock and logs — if the signal landed
        # while the main thread held that same lock (metrics snapshot/
        # render runs there), calling it here would deadlock the handler.
        # The flag is promoted to a full request() from normal context by
        # the `requested` property / check().
        self._pending_signal = signum
        # Second delivery escalates to the previous disposition (default:
        # die) so a stuck run can still be killed by a repeated Ctrl-C /
        # a supervisor's escalation.
        prev = self._prev_handlers.get(signum, signal.SIG_DFL)
        try:
            signal.signal(signum, prev)
        except (ValueError, OSError):       # pragma: no cover
            pass

    def _promote_pending_signal(self) -> None:
        """Turn a handler-frame signal flag into a full request(), from
        ordinary (non-signal) execution context."""
        signum = self._pending_signal
        if signum is not None and not self._requested.is_set():
            self.request(f"signal {signal.Signals(signum).name}",
                         source="signal")

    def _watch_sentinel(self) -> None:
        poll = max(float(knobs.get("HOROVOD_PREEMPTION_POLL_SECONDS")),
                   0.05)
        while not self._stop_watch.is_set() and not self._requested.is_set():
            self._promote_pending_signal()
            try:
                mtime = os.stat(self.sentinel).st_mtime
            except OSError:
                mtime = None
            if mtime is not None and mtime >= self._start_time:
                self.request(f"sentinel {self.sentinel}", source="sentinel")
                return
            self._stop_watch.wait(poll)

    def request(self, reason: str, source: str = "api") -> None:
        """Arm the handler (idempotent). Training quiesces at the next
        ``check()`` boundary."""
        if self._requested.is_set():
            return
        self._reason = reason
        self._requested.set()
        self._m_notices.labels(source=source).inc()
        logger.warning("preemption requested (%s); quiescing for a final "
                       "snapshot", reason)

    @property
    def requested(self) -> bool:
        self._promote_pending_signal()
        return self._requested.is_set()

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    @property
    def stop_step(self) -> Optional[int]:
        return self._stop_step

    # -- quiesce ------------------------------------------------------------
    def _kv(self):
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        return distributed_kv(site="preemption")

    def check(self, step: int) -> bool:
        """Call once per training step with the CURRENT step number.
        Returns True when this is the quiesce step: take the final
        synchronous snapshot (``finalize``) and exit resumable."""
        self._promote_pending_signal()
        kv = self._kv()
        if self._requested.is_set() and not self._published:
            self._published = True
            proposal = step + self.margin
            if kv is not None:
                try:
                    kv.set(self._stop_key, str(proposal))
                except Exception:
                    pass                     # a peer won the write-once race
                try:
                    proposal = int(kv.get(self._stop_key, timeout_s=10))
                except Exception:
                    logger.warning("could not agree on a quiesce step "
                                   "over the KV store; stopping locally")
            self._stop_step = proposal
            self._m_stop_step.set(proposal)
        elif self._stop_step is None and kv is not None:
            # Peer-poll throttled to the sentinel cadence: the quiesce
            # MARGIN must cover poll_seconds/step_time steps of skew.
            now = time.monotonic()
            if now - self._last_kv_poll < max(
                    float(knobs.get("HOROVOD_PREEMPTION_POLL_SECONDS")),
                    0.0):
                return False
            self._last_kv_poll = now
            try:
                v = kv.try_get(self._stop_key)
            except Exception:
                v = None
            if v is not None:
                self._stop_step = int(v)
                self._m_stop_step.set(self._stop_step)
                self.request(f"peer published stop step {v}",
                             source="kvstore")
                self._published = True
        if self._stop_step is None:
            return False
        if step >= self._stop_step:
            if step > self._stop_step:
                logger.warning("preemption stop step %d already passed "
                               "(at %d); stopping now",
                               self._stop_step, step)
            self._dump_flight(step)
            return True
        return False

    def _dump_flight(self, step: int) -> None:
        """Ship the span ring buffer with the abort: the quiesce decision
        just ended this run — the last-N spans ARE the story of why/how
        (what was in flight, how long the drain took). Once per
        preemption; never raises."""
        if self._flight_dumped:
            return
        self._flight_dumped = True
        from horovod_tpu_torch.tracing import spans as trace
        trace.instant("preemption.quiesce", cat=trace.CAT_PREEMPTION,
                      attrs={"step": step, "reason": self._reason or ""})
        trace.dump_flight_recording(f"preemption-step{step}")

    def finalize(self, step: int, state: Any) -> int:
        """Commit the final synchronous snapshot (when a checkpointer is
        attached) and return the resumable exit status."""
        from horovod_tpu_torch.tracing import spans as trace
        if self.checkpointer is not None:
            with trace.span("preemption.drain", cat=trace.CAT_PREEMPTION,
                            attrs={"step": step}
                            if trace.enabled() else None):
                self.checkpointer.save(step, state, sync=True)
            logger.warning("final preemption snapshot committed at step "
                           "%d; exiting resumable (%d)", step,
                           RESUMABLE_EXIT_CODE)
        self._dump_flight(step)
        return RESUMABLE_EXIT_CODE

    def close(self) -> None:
        self._stop_watch.set()
        with _active_lock:
            global _active_handler
            if _active_handler is self:
                _active_handler = None
        if self._prev_handlers and \
                threading.current_thread() is threading.main_thread():
            for sig, prev in self._prev_handlers.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):   # pragma: no cover
                    pass
            self._prev_handlers = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
