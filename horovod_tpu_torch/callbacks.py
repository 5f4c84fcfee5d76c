"""Training-loop callbacks of the port: the step-stats accumulator and
the checkpoint callback.

The counterparts of ``horovod_tpu/callbacks.py``'s ``StepStats`` (l.165)
and ``CheckpointCallback`` (l.249), with the ``Callback`` base.
The other callbacks and the LR schedules (broadcast, metric average,
warmup, best-model) wait for ROADMAP A.9.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from horovod_tpu_torch import metrics as _metrics


class Callback:
    def on_train_begin(self, logs: Dict) -> None: ...
    def on_epoch_begin(self, epoch: int, logs: Dict) -> None: ...
    def on_batch_end(self, batch: int, logs: Dict) -> None: ...
    def on_epoch_end(self, epoch: int, logs: Dict) -> None: ...


class StepStats:
    """Per-step runtime-stats accumulator, read from the metrics registry.

    ``begin()`` snapshots the running totals (bytes dispatched, seconds
    blocked on collectives); ``end()`` returns the per-step deltas (wall
    time, bytes reduced, collective seconds and the collective-time
    fraction), feeds the ``hvd_step_duration_seconds`` histogram (which
    the auto checkpoint cadence tunes against), and rolls the window so
    back-to-back ``end()`` calls measure consecutive steps. The wall time
    is the host's: on the card a step's kernels may still be queued when
    it ends, and the next step's wait absorbs them."""

    def __init__(self):
        self._m_steps = _metrics.counter(
            "hvd_steps_total", "Training steps observed by StepStats")
        self._m_step_dur = _metrics.histogram(
            "hvd_step_duration_seconds", "Wall time per training step")
        self._t0: Optional[float] = None
        self._base: Optional[Dict[str, float]] = None
        self.last: Dict[str, float] = {}

    def begin(self) -> None:
        self._t0 = time.perf_counter()
        self._base = _metrics.runtime_totals()

    def end(self) -> Dict[str, float]:
        if self._t0 is None:
            self.begin()
            return {}
        wall = time.perf_counter() - self._t0
        cur = _metrics.runtime_totals()
        coll = max(cur["collective_seconds"]
                   - self._base["collective_seconds"], 0.0)
        # Goodput fold: the step's handle-wait seconds are wall time the
        # caller spent blocked on collectives; move them from the ambient
        # phase into exposed_collective (no-op when accounting is off).
        from horovod_tpu_torch.goodput import accountant as _goodput
        _goodput.carve(_goodput.EXPOSED_COLLECTIVE, coll)
        stats = {
            "step_time_s": wall,
            "bytes_reduced": cur["bytes_reduced"]
            - self._base["bytes_reduced"],
            "collective_time_s": coll,
            "collective_fraction": min(coll / wall, 1.0) if wall > 0
            else 0.0,
        }
        self._m_steps.inc()
        self._m_step_dur.observe(wall)
        self.last = stats
        self.begin()
        return stats


class CheckpointCallback(Callback):
    """Drives a resilience.AsyncCheckpointer from a Keras-style loop:
    after every batch, ``maybe_save`` snapshots ``logs['state']`` off the
    step path at the configured/auto cadence; if a preemption handler is
    attached (or installed process-globally) and the quiesce step is
    reached, a final synchronous snapshot is committed and
    ``logs['stop_training']``/``logs['exit_code']`` tell the loop to wind
    down with the resumable status."""

    def __init__(self, checkpointer, preemption=None):
        self.checkpointer = checkpointer
        self.preemption = preemption
        self._step = 0

    def on_train_begin(self, logs: Dict) -> None:
        if "state" in logs:
            restored = self.checkpointer.restore_latest(
                template=logs["state"])
            if restored is not None:
                self._step, logs["state"] = restored
                logs["restored_step"] = self._step

    def on_batch_end(self, batch: int, logs: Dict) -> None:
        from horovod_tpu_torch.resilience import preemption as _preemption
        from horovod_tpu_torch.resilience.preemption import (
            RESUMABLE_EXIT_CODE)
        self._step += 1
        state = logs.get("state")
        if state is None:
            return
        handler = self.preemption or _preemption.active_handler()
        if handler is not None and handler.check(self._step):
            self.checkpointer.save(self._step, state, sync=True)
            logs["stop_training"] = True
            logs["exit_code"] = RESUMABLE_EXIT_CODE
            return
        self.checkpointer.maybe_save(self._step, state)
