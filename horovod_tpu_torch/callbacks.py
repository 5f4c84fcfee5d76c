"""Training-loop callbacks and LR schedules of the port.

The counterparts of ``horovod_tpu/callbacks.py`` (the reference's
keras/callbacks.py and _keras/callbacks.py): ``warmup_schedule`` and
``scaled_lr``; the ``Callback`` base and ``CallbackList``;
``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback``,
``LearningRateScheduleCallback``, ``LearningRateWarmupCallback``,
``BestModelCheckpoint``; ``StepStats`` with ``MetricsCallback``; and
``CheckpointCallback``. The callbacks drive a plain Python loop
(``on_train_begin``, ``on_epoch_begin/end``, ``on_batch_end``) through a
``logs`` dict: ``logs['state']`` is the training state (an ``nn.Module``
or a tree of tensors), ``logs['metrics']`` the metrics, ``logs['lr']`` the
learning rate a schedule sets.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from horovod_tpu_torch import metrics as _metrics


def warmup_schedule(base_lr: float, warmup_steps: int,
                    initial_multiplier: float = 1.0 / 8
                    ) -> Callable[[Any], float]:
    """LR warmup (ref LearningRateWarmupCallback keras/callbacks.py:98):
    an exponential ramp from ``base_lr * initial_multiplier`` at step 0 to
    ``base_lr`` at ``warmup_steps``, flat after."""
    if warmup_steps <= 0:
        return lambda step: base_lr

    def schedule(step):
        frac = min(float(step), warmup_steps) / warmup_steps
        return base_lr * initial_multiplier ** (1.0 - frac)

    return schedule


def scaled_lr(base_lr: float, scale: Optional[float] = None) -> float:
    """``base_lr`` scaled linearly by the world size (ref
    DistributedOptimizer docs: lr * hvd.size())."""
    if scale is None:
        from horovod_tpu_torch.runtime.context import size
        scale = size()
    return base_lr * scale


class Callback:
    def on_train_begin(self, logs: Dict) -> None: ...
    def on_epoch_begin(self, epoch: int, logs: Dict) -> None: ...
    def on_batch_end(self, batch: int, logs: Dict) -> None: ...
    def on_epoch_end(self, epoch: int, logs: Dict) -> None: ...


class CallbackList:
    """Fires an event on every callback in order."""

    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def __getattr__(self, name):
        def fire(*args, **kwargs):
            for cb in self.callbacks:
                getattr(cb, name)(*args, **kwargs)
        return fire


class BroadcastGlobalVariablesCallback(Callback):
    """Rank ``root_rank``'s initial state on every rank before the first
    step (ref keras/callbacks.py:23): ``logs['state']`` (an ``nn.Module``,
    its buffers included, or a tree of tensors), in place, and
    ``optimizer``'s state when one is given."""

    def __init__(self, root_rank: int = 0, optimizer=None):
        self.root_rank = root_rank
        self.optimizer = optimizer

    def on_train_begin(self, logs: Dict) -> None:
        from horovod_tpu_torch.functions import (broadcast_optimizer_state,
                                                 broadcast_parameters)
        if "state" in logs:
            logs["state"] = broadcast_parameters(logs["state"],
                                                 self.root_rank)
        if self.optimizer is not None:
            broadcast_optimizer_state(self.optimizer, self.root_rank)


class MetricAverageCallback(Callback):
    """Each of ``logs['metrics']`` averaged over the ranks (or the members
    of ``process_set``) at the end of an epoch (ref
    _keras/callbacks.py:62), as a CPU f32 tensor of the metric's shape."""

    def __init__(self, process_set=None):
        self.process_set = process_set

    def on_epoch_end(self, epoch: int, logs: Dict) -> None:
        from horovod_tpu_torch.eager import allreduce
        from horovod_tpu_torch.ops.reduce_ops import Average
        from horovod_tpu_torch.runtime.context import get_context
        dev = get_context().device
        metrics = logs.get("metrics", {})
        for k, v in list(metrics.items()):
            t = torch.as_tensor(v, dtype=torch.float32).to(dev)
            metrics[k] = allreduce(t, Average,
                                   process_set=self.process_set).cpu()


class LearningRateScheduleCallback(Callback):
    """``logs['lr'] = initial_lr * multiplier(epoch)`` at the start of
    each epoch in [start_epoch, end_epoch) (ref keras/callbacks.py:98)."""

    def __init__(self, initial_lr: float,
                 multiplier: Callable[[int], float],
                 start_epoch: int = 0, end_epoch: Optional[int] = None):
        self.initial_lr = initial_lr
        self.multiplier = multiplier
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch

    def on_epoch_begin(self, epoch: int, logs: Dict) -> None:
        if epoch < self.start_epoch:
            return
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return
        logs["lr"] = self.initial_lr * self.multiplier(epoch)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """The epoch-level warmup (ref keras/callbacks.py:131): the
    multiplier ramps exponentially from ``initial_multiplier`` to 1 over
    ``warmup_epochs``."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 initial_multiplier: float = 1.0 / 8):
        def mult(epoch):
            if epoch >= warmup_epochs:
                return 1.0
            frac = epoch / max(warmup_epochs, 1)
            return initial_multiplier ** (1.0 - frac)
        super().__init__(initial_lr, mult, 0, None)


def _to_cpu(state: Any) -> Any:
    if isinstance(state, nn.Module):
        state = state.state_dict()
    if torch.is_tensor(state):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_cpu(v) for v in state)
    return state


class BestModelCheckpoint(Callback):
    """Saves ``logs['state']`` to ``path`` when ``logs['metrics'][monitor]``
    improves (``mode`` min or max), on rank 0 only (ref
    keras/callbacks.py:161). The default ``save_fn`` is ``torch.save`` of
    the state's tensors on the CPU (an ``nn.Module``'s ``state_dict``)."""

    def __init__(self, path: str, monitor: str = "val_loss",
                 mode: str = "min",
                 save_fn: Optional[Callable[[str, Any], None]] = None):
        self.path = path
        self.monitor = monitor
        self.sign = 1.0 if mode == "min" else -1.0
        self.best = math.inf
        self.save_fn = save_fn or self._default_save

    @staticmethod
    def _default_save(path: str, state: Any) -> None:
        torch.save(_to_cpu(state), path)

    def on_epoch_end(self, epoch: int, logs: Dict) -> None:
        from horovod_tpu_torch.runtime.context import rank
        metrics = logs.get("metrics", {})
        if self.monitor not in metrics:
            return
        val = float(torch.as_tensor(metrics[self.monitor]).reshape(-1)[0])
        if self.sign * val < self.best:
            self.best = self.sign * val
            if rank() == 0 and "state" in logs:
                self.save_fn(self.path, logs["state"])


class StepStats:
    """Per-step runtime-stats accumulator, read from the metrics registry.

    ``begin()`` snapshots the running totals (bytes dispatched, seconds
    blocked on collectives); ``end()`` returns the per-step deltas (wall
    time, bytes reduced, collective seconds and the collective-time
    fraction), feeds the ``hvd_step_duration_seconds`` histogram (which
    the auto checkpoint cadence tunes against), and rolls the window so
    back-to-back ``end()`` calls measure consecutive steps, and feeds
    the online tuner (``autotune.feed_step_stats``). The wall time is the
    host's: on the card a step's kernels may still be queued when it ends,
    and the next step's wait absorbs them; synchronize the card before
    ``end()`` where the time must hold the step's device work."""

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
        # the online tuner's v2 score (a no-op without an active tuner)
        from horovod_tpu_torch import autotune as _autotune
        _autotune.feed_step_stats(wall, coll)
        self.last = stats
        self.begin()
        return stats


class MetricsCallback(Callback):
    """Publishes :class:`StepStats` into the loop's logs: after every
    batch ``logs['metrics']`` carries ``step_time_s``,
    ``collective_fraction`` and ``bytes_reduced``, and ``history`` keeps
    every step's row."""

    def __init__(self):
        self.stats = StepStats()
        self.history: List[Dict[str, float]] = []

    def on_epoch_begin(self, epoch: int, logs: Dict) -> None:
        self.stats.begin()

    def on_batch_end(self, batch: int, logs: Dict) -> None:
        row = self.stats.end()
        if not row:
            return
        self.history.append(row)
        logs.setdefault("metrics", {}).update(row)


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
