"""Process-wide runtime of the port: init/shutdown and the rank/size
queries.

The subset of ``horovod_tpu/runtime/context.py`` that a training step
uses, over ``torch.distributed``. The unit of parallelism is the process,
one per card, as in the reference Horovod: ``size()`` is the number of
processes, ``rank()`` this process's index among them.

``init`` joins the world the launcher describes (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` in the environment, with
``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` for the per-host view, as ``torchrun``
sets them). Without that environment it forms a world of one on an
in-process store, so a single process runs the same collective path. The
backend is NCCL for a CUDA device and gloo for ``device="cpu"``.

Not ported yet (slice 3): ``Topology`` and ``mesh()``, process sets, and
the timeline, metrics and goodput hooks that the JAX ``init`` starts.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.utils.device import resolve_device

_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

_lock = threading.RLock()
_context: Optional["Context"] = None


class NotInitializedError(RuntimeError):
    def __init__(self):
        super().__init__("horovod_tpu_torch has not been initialized; call "
                         "horovod_tpu_torch.init() first.")


class Context:
    """What ``init`` set up: the device this process drives, the backend,
    the per-host layout, and whether ``init`` created the process group
    (and so ``shutdown`` destroys it)."""

    def __init__(self, device: torch.device, backend: str, local_size: int,
                 local_rank: int, owns_group: bool):
        self.device = device
        self.backend = backend
        self.local_size = local_size
        self.local_rank = local_rank
        self.owns_group = owns_group

    @property
    def size(self) -> int:
        return dist.get_world_size()

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def cross_size(self) -> int:
        return max(self.size // self.local_size, 1)

    @property
    def cross_rank(self) -> int:
        return self.rank // self.local_size


def init(device="cuda", backend: Optional[str] = None) -> Context:
    """Initialize the runtime (idempotent: a second call returns the
    context of the first). ``device="cuda"`` raises without a GPU; with
    several cards on a host, each process takes card ``LOCAL_RANK``."""
    global _context
    with _lock:
        if _context is not None:
            return _context
        dev = resolve_device(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        launched = all(k in os.environ for k in _LAUNCH_ENV)
        local_rank = int(os.environ.get("LOCAL_RANK", 0)) if launched else 0
        local_size = (int(os.environ.get("LOCAL_WORLD_SIZE", 1))
                      if launched else 1)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda",
                                   local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        owns = not dist.is_initialized()
        if owns:
            if launched:
                dist.init_process_group(backend, init_method="env://")
            else:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
        _context = Context(dev, backend, local_size, local_rank, owns)
        return _context


def shutdown() -> None:
    """Tear the runtime down; ``init`` works again afterwards."""
    global _context
    with _lock:
        if _context is None:
            return
        if _context.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        _context = None


def is_initialized() -> bool:
    return _context is not None


def get_context() -> Context:
    if _context is None:
        raise NotInitializedError()
    return _context


def size() -> int:
    return get_context().size


def rank() -> int:
    return get_context().rank


def local_size() -> int:
    return get_context().local_size


def local_rank() -> int:
    return get_context().local_rank


def cross_size() -> int:
    return get_context().cross_size


def cross_rank() -> int:
    return get_context().cross_rank
