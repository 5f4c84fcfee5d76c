"""SchedulerHooks: the injectable yield-point seam of the protocol code.

The port's copy of ``horovod_tpu/utils/schedhooks.py``. The coordination
protocols (``resilience/async_checkpoint``, ``resilience/preemption``)
construct their locks, events, queues and threads and perform their commit
renames through this module instead of calling ``threading``/``queue``/
``os`` directly. In production the installed hooks are a passthrough that
returns exactly the stdlib objects; a model checker or a test may install
a :class:`SchedulerHooks` subclass whose primitives yield to a scheduler
of its own, so it drives the real protocol code.

Contract for protocol modules:

- construct every lock/event/queue/thread that takes part in a
  cross-thread protocol through the module-level factories below;
- route every atomic-rename commit point through :func:`rename`;
- never cache ``hooks()`` across calls;
- assume only the stdlib interface actually used.

``kv_client()``/``world()`` let a test substitute the KV client and the
(rank, world size) identity of a simulated process; production returns
None for both, meaning "ask ``torch.distributed``"
(:func:`process_world`).
"""

from __future__ import annotations

import os as _os
import queue as _queue
import threading as _threading
import time as _time
from typing import Any, Optional, Tuple


class SchedulerHooks:
    """No-op production hooks: plain stdlib primitives, real os.rename."""

    def lock(self):
        return _threading.Lock()

    def rlock(self):
        return _threading.RLock()

    def condition(self, lock=None):
        return _threading.Condition(lock)

    def event(self):
        return _threading.Event()

    def queue(self):
        return _queue.Queue()

    def thread(self, target, name: Optional[str] = None,
               daemon: bool = True, args: tuple = ()):
        return _threading.Thread(target=target, name=name, daemon=daemon,
                                 args=args)

    def rename(self, src: str, dst: str) -> None:
        _os.rename(src, dst)

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)

    def kv_client(self) -> Optional[Any]:
        """KV client override (a c10d ``Store``); None = the
        default process group's store."""
        return None

    def world(self) -> Optional[Tuple[int, int]]:
        """(rank, world size) override; None = ask torch.distributed."""
        return None


_DEFAULT = SchedulerHooks()
_current: SchedulerHooks = _DEFAULT


def hooks() -> SchedulerHooks:
    """The currently installed hooks (the production no-op unless a
    model-checking run has installed its shims)."""
    return _current


def install(h: Optional[SchedulerHooks]) -> SchedulerHooks:
    """Install ``h`` (None restores the production default); returns the
    previously installed hooks so callers can restore them in a finally."""
    global _current
    prev = _current
    _current = h if h is not None else _DEFAULT
    return prev


# -- construction-site factories --------------------------------------------

def Lock():
    return _current.lock()


def RLock():
    return _current.rlock()


def Condition(lock=None):
    return _current.condition(lock)


def Event():
    return _current.event()


def Queue():
    return _current.queue()


def Thread(target, name: Optional[str] = None, daemon: bool = True,
           args: tuple = ()):
    return _current.thread(target, name=name, daemon=daemon, args=args)


def rename(src: str, dst: str) -> None:
    _current.rename(src, dst)


def sleep(seconds: float) -> None:
    _current.sleep(seconds)


def process_world() -> Tuple[int, int]:
    """(rank, world size) of this process: the installed hooks' override,
    else the default process group's, else (0, 1)."""
    world = _current.world()
    if world is not None:
        return world
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
