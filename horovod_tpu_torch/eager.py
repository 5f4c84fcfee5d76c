"""Horovod's eager PyTorch API on the port: the collectives as a training
script calls them, their async handles, and ``join``.

The counterpart of ``horovod_tpu/eager.py`` (l.95-1183), per rank and SPMD
as ``ops/collectives.py`` is: rank r passes the ``x[r]`` of the JAX eager
API's rank-stacked ``x`` and gets what rank r holds there. Every function
runs over all ranks of the mesh (its axes linearized row-major, so an
index along them is the global rank), or over ``process_set``. Not
ported: the DLPack frontend bridge and the cycle coordinator with its
fusion cycle (ROADMAP A.9b).

**Join** (``join``; ref Request::JOIN message.h:65, JoinOp
collective_operations.h:312, controller.cc:269-327) is the JAX package's
registry, called in program order on every rank: ``join(r)`` marks rank r
joined and returns -1 while some ranks remain; the call that completes the
set, or a bare ``join()`` (which appends the remaining ranks in rank
order), runs a barrier, resets the registry for the next epoch and returns
the last rank that joined. Every rank makes the same calls, so the
registry is the same everywhere without an exchange. While ranks are
joined, ``allreduce`` and ``grouped_allreduce`` take the op's identity
from them and Average divides by the active count (a process set's own
members with its own registry), and ``allgather`` drops their rows. The
global registry lives on the ``Context``, each process set has its own.
Reference Horovod's torch ``join()``, where one rank calls it alone while
the others go on and its background thread answers them with zeros, needs
the coordinator's negotiation (ROADMAP A.9b).

**Handles.** A ``*_async`` function starts the collective with
``torch.distributed``'s ``async_op=True`` and returns a :class:`Handle`;
``synchronize(h)`` (``h.wait()``) returns the result, ``poll(h)`` whether
it is done. The join registry is read when the call is made. On the card
the handle makes the current stream wait for the collective and queues
the step that forms the result behind it, then records a CUDA event:
``poll`` is True once that event has completed (NCCL's works may report
completion before the result can be read on the current stream), and
``wait`` blocks on it. On the CPU (gloo) ``wait`` waits on
the works, then forms the result. An error of a collective is raised by
``wait``. The uneven forms (allgather of differing first dims, alltoall
with ``splits``) and allgather on a process set exchange their sizes
first, synchronously; only the data movement after that is in flight
when the call returns. Adasum's butterfly has one exchange per level,
each needing the last, so ``allreduce_async(op=Adasum)`` runs it whole
before it returns. Outstanding handles are tracked by the stall inspector
(``stall_inspector.py``); the seconds ``wait`` blocks go to the
``hvd_handle_wait_seconds`` histogram.

**Elastic mode.** Under ``HOROVOD_ELASTIC`` a ``torch.distributed`` work
that fails in ``wait()`` raises ``elastic.HorovodInternalError``
(``ops/collectives.wait_work``; ref WaitForEventsElastic
gpu_operations.cc:98-106), the error the ``elastic.run`` wrapper
recovers from. Every handle not yet waited on is
kept in a registry: :func:`reset_outstanding` (the elastic reset and the
live resize call it before the process group goes away) resolves each
with ``elastic.ResizeInterrupt``, so its ``wait()`` raises at once
instead of waiting on a work of a destroyed group.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Optional, Sequence, Union

import torch

from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops.reduce_ops import ReduceOp
from horovod_tpu_torch.runtime.context import get_context

_name_lock = threading.Lock()
_name_counter = 0
# handles whose wait() has not run yet (see reset_outstanding); reentrant,
# since a handle's __del__ may run while this thread holds it
_outstanding: "weakref.WeakSet[Handle]" = weakref.WeakSet()
_outstanding_lock = threading.RLock()


def _auto_name(prefix: str) -> str:
    global _name_counter
    with _name_lock:
        _name_counter += 1
        return f"{prefix}.noname.{_name_counter}"


def _wait_hist():
    from horovod_tpu_torch import metrics as M
    return M.histogram(
        "hvd_handle_wait_seconds",
        "Wall time a synchronize()/wait() blocked on an async collective "
        "handle")


class Handle:
    """An async collective (ref torch/handle_manager.h): ``wait()``
    returns its result, ``done()`` whether it has completed."""

    __slots__ = ("name", "_pending", "_value", "_error", "_event",
                 "_formed", "_tracked", "__weakref__")

    def __init__(self, name: str, pending: "C._Pending",
                 device: torch.device):
        from horovod_tpu_torch.stall_inspector import get_stall_inspector
        self.name = name
        self._pending = pending
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._event: Optional[torch.cuda.Event] = None
        self._formed = False
        get_stall_inspector().record_start(name)
        self._tracked = True
        with _outstanding_lock:
            _outstanding.add(self)
        if device.type == "cuda":
            # NCCL: waiting on a work orders the current stream after the
            # collective without blocking the host
            self._form()
            self._event = torch.cuda.Event()
            self._event.record()

    def _form(self) -> None:
        if not self._formed:
            self._formed = True
            try:
                self._value = self._pending.wait()
            except Exception as exc:    # raised by wait()
                self._error = exc

    def _untrack(self) -> None:
        with _outstanding_lock:
            _outstanding.discard(self)
        if self._tracked:
            from horovod_tpu_torch.stall_inspector import get_stall_inspector
            get_stall_inspector().record_done(self.name)
            self._tracked = False

    def done(self) -> bool:
        ready = self._error is not None or (
            self._pending.is_completed()
            and (self._event is None or self._event.query()))
        if ready:
            self._untrack()
        return ready

    def wait(self) -> Any:
        from horovod_tpu_torch.tracing import spans
        t0 = time.perf_counter()
        span = spans.span(self.name, cat=spans.CAT_WAIT,
                          attrs={"op": "handle.wait"}
                          if spans.enabled() else None)
        span.__enter__()
        try:
            self._form()
            if self._error is not None:
                raise self._error
            if self._event is not None:
                self._event.synchronize()
            return self._value
        finally:
            span.__exit__(None, None, None)
            _wait_hist().observe(time.perf_counter() - t0)
            self._untrack()

    def __del__(self):      # a dropped handle is no stall
        try:
            self._untrack()
        except Exception:
            pass


def reset_outstanding(error: Optional[BaseException] = None) -> int:
    """Resolve every handle not yet waited on with ``error`` (default: an
    ``elastic.ResizeInterrupt``): its ``wait()`` raises it at once. The
    elastic reset and the live resize call this before the process group
    is destroyed. Returns how many handles were resolved."""
    from horovod_tpu_torch.elastic.exceptions import ResizeInterrupt
    if error is None:
        error = ResizeInterrupt("the world is being reset; this collective "
                                "was never completed")
    with _outstanding_lock:
        handles = list(_outstanding)
        _outstanding.clear()
    for h in handles:
        h._formed = True
        h._error = error
        h._event = None
    return len(handles)


def synchronize(handle: Handle) -> Any:
    """Block until the handle's collective has finished; its result (ref
    torch/mpi_ops.py:1237)."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True once the handle's collective has completed (ref
    torch/mpi_ops.py poll)."""
    return handle.done()


# ---------------------------------------------------------------------------
# the axis and the join registry of a call
# ---------------------------------------------------------------------------

def _axis():
    """Every axis of the mesh: the world, linearized row-major."""
    axes = tuple(get_context().topology.flat_axes)
    return axes if len(axes) > 1 else axes[0]


def _joined_for(process_set) -> tuple:
    """A snapshot of the registry that governs a call: the Context's for
    the global set, the set's own otherwise."""
    if process_set is None or process_set.process_set_id == 0:
        return tuple(get_context().joined_ranks)
    return tuple(process_set.joined_ranks)


def _handle(prefix: str, name: Optional[str], pending, tensor) -> Handle:
    return Handle(name or _auto_name(prefix), pending, tensor.device)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              process_set=None, prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """This rank's ``tensor`` reduced over the ranks (or the members of
    ``process_set``; other ranks get their own value); Average by default,
    as the reference's torch API (torch/mpi_ops.py)."""
    del name
    return _allreduce_start(tensor, op, process_set, prescale_factor,
                            postscale_factor).wait()


def _allreduce_start(tensor, op, process_set, prescale_factor,
                     postscale_factor):
    return C.allreduce_start(tensor, op, _axis(), process_set,
                             prescale_factor, postscale_factor,
                             _joined_for(process_set))


def allreduce_async(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                    process_set=None,
                    prescale_factor: Optional[float] = None,
                    postscale_factor: Optional[float] = None,
                    name: Optional[str] = None) -> Handle:
    return _handle("allreduce", name, _allreduce_start(
        tensor, op, process_set, prescale_factor, postscale_factor), tensor)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE, process_set=None,
                      prescale_factor: Optional[float] = None,
                      postscale_factor: Optional[float] = None,
                      name: Optional[str] = None):
    """All ``tensors`` reduced as one op, one collective per dtype (ref
    grouped_allreduce, torch/mpi_ops.py); a list in input order."""
    del name
    return C.grouped_allreduce_start(
        tensors, op, _axis(), process_set, prescale_factor, postscale_factor,
        _joined_for(process_set)).wait()


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            op: ReduceOp = ReduceOp.AVERAGE,
                            process_set=None,
                            prescale_factor: Optional[float] = None,
                            postscale_factor: Optional[float] = None,
                            name: Optional[str] = None) -> Handle:
    """One handle for the group: ``wait()`` returns the list."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("grouped_allreduce needs at least one tensor")
    return _handle("grouped_allreduce", name, C.grouped_allreduce_start(
        tensors, op, _axis(), process_set, prescale_factor, postscale_factor,
        _joined_for(process_set)), tensors[0])


def allgather(tensor: torch.Tensor, process_set=None,
              name: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``tensor`` (first dims may differ) concatenated along
    dim 0 in rank order; a joined rank's rows are left out."""
    del name
    return _allgather_start(tensor, process_set).wait()


def _allgather_start(tensor, process_set):
    if tensor.dim() and get_context().rank in _joined_for(process_set):
        tensor = tensor[:0]
    return C.allgather_start(tensor, _axis(), process_set)


def allgather_async(tensor: torch.Tensor, process_set=None,
                    name: Optional[str] = None) -> Handle:
    """The first dims are exchanged before this returns; the gather is in
    flight after."""
    return _handle("allgather", name, _allgather_start(tensor, process_set),
                   tensor)


def broadcast(tensor: torch.Tensor, root_rank: int = 0, process_set=None,
              name: Optional[str] = None) -> torch.Tensor:
    """The root's ``tensor`` on every rank (ref torch/mpi_ops.py
    broadcast), as a new tensor."""
    del name
    return C.broadcast(tensor, root_rank, _axis(), process_set)


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    process_set=None, name: Optional[str] = None) -> Handle:
    return _handle("broadcast", name, C.broadcast_start(
        tensor.clone(), root_rank, _axis(), process_set), tensor)


def alltoall(tensor: torch.Tensor, splits=None, process_set=None,
             name: Optional[str] = None):
    """Dim 0 split into per-rank chunks, chunk i to rank i; with
    ``splits`` returns ``(out, received_splits)`` (ref torch/mpi_ops.py
    alltoall)."""
    del name
    return C.alltoall(tensor, splits, _axis(), process_set)


def alltoall_async(tensor: torch.Tensor, splits=None, process_set=None,
                   name: Optional[str] = None) -> Handle:
    """With ``splits`` the send vectors are exchanged before this
    returns; the rows are in flight after."""
    return _handle("alltoall", name, C.alltoall_start(
        tensor, splits, _axis(), process_set), tensor)


def reducescatter(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                  process_set=None, prescale_factor: Optional[float] = None,
                  postscale_factor: Optional[float] = None,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce, then rank i keeps the i-th slice of dim 0 (the first
    ``rows % n`` ranks one row more; ref collective_operations.h:282)."""
    del name
    return C.reducescatter(tensor, op, _axis(), process_set,
                           prescale_factor, postscale_factor)


def reducescatter_async(tensor: torch.Tensor,
                        op: ReduceOp = ReduceOp.AVERAGE, process_set=None,
                        prescale_factor: Optional[float] = None,
                        postscale_factor: Optional[float] = None,
                        name: Optional[str] = None) -> Handle:
    return _handle("reducescatter", name, C.reducescatter_start(
        tensor, op, _axis(), process_set, prescale_factor, postscale_factor),
        tensor)


def barrier(process_set=None) -> None:
    """Returns once every rank (or member of ``process_set``) called it
    (ref torch/mpi_ops.py:1283)."""
    C.barrier(process_set)


def join(rank: Optional[Union[int, Sequence[int]]] = None,
         process_set=None) -> int:
    """Mark ``rank`` (an int or several) joined and return -1 while ranks
    remain; the call that completes the set, or a bare ``join()``, runs a
    barrier, resets the registry and returns the last rank that joined
    (the module docstring has the contract). ``process_set`` scopes the
    join to that set's registry."""
    ctx = get_context()
    if process_set is None or process_set.process_set_id == 0:
        registry, members = ctx.joined_ranks, list(range(ctx.size))
    else:
        registry, members = process_set.joined_ranks, process_set.ranks
    if rank is not None:
        for r in (rank if isinstance(rank, (list, tuple)) else [rank]):
            r = int(r)
            if r not in members:
                raise ValueError(
                    f"join rank {r} is not a member of the process set")
            if r not in registry:
                registry.append(r)
        if len(registry) < len(members):
            return -1
    else:
        for r in members:
            if r not in registry:
                registry.append(r)
    last = registry[-1]
    registry.clear()
    barrier(process_set=process_set)
    return last
