"""Horovod's eager PyTorch API on the port: the collectives as a training
script calls them, their async handles, ``join``, and the DLPack frontend
bridge.

The counterpart of ``horovod_tpu/eager.py`` (l.95-1183), per rank and SPMD
as ``ops/collectives.py`` is: rank r passes the ``x[r]`` of the JAX eager
API's rank-stacked ``x`` and gets what rank r holds there. Every function
runs over all ranks of the mesh (its axes linearized row-major, so an
index along them is the global rank), or over ``process_set``.

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
The JAX package has no join in which one rank blocks alone while the
others go on (reference Horovod torch's), so neither has the port.

**Handles.** Every ``*_async`` function enqueues its tensor with the
context's fusion-cycle coordinator (``ops/coordinator.py``, as the JAX
``_enqueue_async`` does) and returns a pending :class:`Handle`; the
coordinator fuses compatible queued tensors into bins and resolves the
handles when it dispatches them. ``synchronize(h)`` (``h.wait()``)
returns the result, ``poll(h)`` whether it is done. In a world of several
ranks both are flush points: a handle still queued makes the coordinator
run its cycle. The join registry is read at enqueue. The tensor must not
be changed until its handle is done (the coordinator reads it when it
packs the bin). On the card a result is ordered on the stream of its bin
behind a CUDA event; ``poll`` is True once the event has completed and
``wait`` blocks on it. An error of a collective is raised by ``wait``.
``allreduce_async(op=Adasum)`` (and the grouped form with Adasum) is not
queued: Adasum's butterfly has one exchange per level, each needing the
last, and combining tensors of different calls would change its result,
so it runs whole before it returns. The synchronous forms are direct
calls. Outstanding handles are tracked by the stall inspector
(``stall_inspector.py``); the seconds ``wait`` blocks go to the
``hvd_handle_wait_seconds`` histogram.

**The DLPack frontend bridge** (the JAX ``_frontend_bridge``, l.384-550;
ref torch/adapter_v2.cc): the public collectives also take another
framework's arrays (a numpy array, or any object with ``__dlpack__``,
such as a jax array). They come in through ``torch.from_numpy`` or
``torch.from_dlpack`` (a host copy when the zero-copy import is refused,
bf16 by its bits), move to the context's device, and the results go back
in the caller's framework, cast back to the caller's dtype within its
family (float to float, integer to integer: an alltoall's received
splits stay integers); an async handle converts at ``wait``. The port
imports no frontend: it reaches one only through the array's own
``__array_namespace__()`` or a module the caller already loaded, and that
module's ``from_dlpack``. When it finds none, it returns the torch tensor.

**Elastic mode.** Under ``HOROVOD_ELASTIC`` a collective that fails
raises ``elastic.HorovodInternalError`` at ``wait()``
(``ops/collectives.wait_work`` and the coordinator's dispatch; ref
WaitForEventsElastic gpu_operations.cc:98-106), the error the
``elastic.run`` wrapper recovers from. Every handle not yet waited on is
kept in a registry: :func:`reset_outstanding` (the elastic reset and the
live resize call it before the process group goes away) resolves each,
queued or dispatched, with ``elastic.ResizeInterrupt``, so its ``wait()``
raises at once instead of waiting on a work of a destroyed group.
"""

from __future__ import annotations

import functools
import inspect
import sys
import threading
import time
import weakref
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops.reduce_ops import ReduceOp, check_supported
from horovod_tpu_torch.runtime.context import get_context

_name_lock = threading.Lock()
_name_counter = 0
# handles whose wait() has not run yet (see reset_outstanding); reentrant,
# since a handle's __del__ may run while this thread holds it
_outstanding: "weakref.WeakSet[Handle]" = weakref.WeakSet()
_outstanding_lock = threading.RLock()
_CPU = torch.device("cpu")


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
    returns its result, ``done()`` whether it has completed.

    Two lifecycles: an *immediate* handle wraps a collective already
    started (``Handle(name, pending, device)``, ``pending`` a
    ``collectives._Pending``); a *pending* one (:meth:`pending`) is a
    tensor queued in the coordinator, which resolves it at dispatch
    (``_set_result``/``_set_error``; ref torch/mpi_ops_v2.cc:94
    MarkDone)."""

    __slots__ = ("name", "_pending", "_value", "_error", "_resolved",
                 "_event", "_watch", "_formed", "_tracked", "_coordinator",
                 "_frontend", "__weakref__")

    def __init__(self, name: str, pending: Optional["C._Pending"],
                 device: torch.device):
        from horovod_tpu_torch.stall_inspector import get_stall_inspector
        self.name = name
        self._pending = pending
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._resolved = threading.Event()
        self._resolved.set()
        self._event: Optional[torch.cuda.Event] = None
        self._watch = None      # FlushWatch of a flush dispatched unchecked
        self._formed = pending is None
        self._coordinator = None
        self._frontend = None   # (frontend, dtypes) of the DLPack bridge
        get_stall_inspector().record_start(name)
        self._tracked = True
        with _outstanding_lock:
            _outstanding.add(self)
        if pending is not None and device.type == "cuda":
            # NCCL: waiting on a work orders the current stream after the
            # collective without blocking the host
            self._form()
            self._event = torch.cuda.Event()
            self._event.record()

    @classmethod
    def pending(cls, name: str) -> "Handle":
        """A handle the coordinator resolves when it dispatches the
        entry."""
        h = cls(name, None, _CPU)
        h._resolved.clear()
        return h

    # -- coordinator-side resolution ----------------------------------------
    def _set_result(self, value: Any, event=None, watch=None) -> None:
        self._value = value
        self._event = event
        self._watch = watch
        self._resolved.set()

    def _set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._resolved.set()

    def _form(self) -> None:
        if not self._formed:
            self._formed = True
            try:
                self._value = self._pending.wait()
            except Exception as exc:    # raised by wait()
                self._error = exc

    def _flush_if_deferred(self) -> None:
        """A deterministic coordinator (several ranks) defers dispatch to
        symmetric flush points; a wait or poll of a still-queued handle is
        one (in the same program order on every rank)."""
        coord = self._coordinator
        if coord is not None and coord.deterministic \
                and not self._resolved.is_set():
            coord.run_cycle()

    def _untrack(self) -> None:
        if self._tracked:
            from horovod_tpu_torch.stall_inspector import get_stall_inspector
            get_stall_inspector().record_done(self.name)
            self._tracked = False

    def _retrack(self) -> None:
        """(Re)start the stall clock: a deferred entry is tracked from its
        dispatch, not its enqueue (a parked request is not a stall)."""
        if not self._tracked:
            from horovod_tpu_torch.stall_inspector import get_stall_inspector
            get_stall_inspector().record_start(self.name)
            self._tracked = True

    def _forget(self) -> None:
        self._untrack()
        with _outstanding_lock:
            _outstanding.discard(self)

    def _export(self, value):
        if self._frontend is not None:
            return _dlpack_export(value, *self._frontend)
        return value

    def result(self) -> Any:
        """The result (None while still queued), in the caller's
        framework as ``wait`` returns it."""
        if self._value is None:
            return None
        return self._export(self._value)

    def done(self) -> bool:
        self._flush_if_deferred()
        if not self._resolved.is_set():
            return False
        ready = self._error is not None or (
            (self._pending is None or self._pending.is_completed())
            and (self._event is None or self._event.query()))
        if ready:
            self._forget()
        return ready

    def wait(self) -> Any:
        from horovod_tpu_torch.tracing import spans
        t0 = time.perf_counter()
        span = spans.span(self.name, cat=spans.CAT_WAIT,
                          attrs={"op": "handle.wait"}
                          if spans.enabled() else None)
        span.__enter__()
        try:
            self._flush_if_deferred()
            if not self._resolved.is_set():
                from horovod_tpu_torch.timeline import WAIT, get_timeline
                tl = get_timeline()
                if tl.active:
                    with tl.span(self.name, WAIT, mirror=False):
                        self._resolved.wait()
                else:
                    self._resolved.wait()
            self._form()
            if self._error is not None:
                raise self._error
            if self._event is not None:
                if self._watch is not None:     # a peer may have diverged
                    self._watch.wait_until(self._event.query)
                else:
                    self._event.synchronize()
            return self._export(self._value)
        finally:
            span.__exit__(None, None, None)
            _wait_hist().observe(time.perf_counter() - t0)
            self._forget()

    def __del__(self):      # a dropped handle is no stall
        try:
            self._untrack()
        except Exception:
            pass


class _GroupedHandle(Handle):
    """The per-tensor handles of one registered group: ``wait`` returns
    the list of results in input order."""

    __slots__ = ("_parts",)

    def __init__(self, name: str, parts: List[Handle]):
        super().__init__(name, None, _CPU)
        self._parts = parts

    def done(self) -> bool:
        ready = self._error is not None or all(h.done()
                                               for h in self._parts)
        if ready:
            self._forget()
        return ready

    def wait(self) -> List[Any]:
        try:
            if self._error is not None:
                raise self._error
            return self._export([h.wait() for h in self._parts])
        finally:
            self._forget()


def reset_outstanding(error: Optional[BaseException] = None) -> int:
    """Resolve every handle not yet waited on with ``error`` (default: an
    ``elastic.ResizeInterrupt``): its ``wait()`` raises it at once. The
    coordinator's queue is drained first (``Coordinator.reset``). The
    elastic reset and the live resize call this before the process group
    is destroyed. Returns how many handles were resolved."""
    from horovod_tpu_torch.elastic.exceptions import ResizeInterrupt
    from horovod_tpu_torch.runtime import context
    if error is None:
        error = ResizeInterrupt("the world is being reset; this collective "
                                "was never completed")
    ctx = context._context
    if ctx is not None and ctx.coordinator is not None:
        ctx.coordinator.reset(error)
    with _outstanding_lock:
        handles = list(_outstanding)
        _outstanding.clear()
    for h in handles:
        h._formed = True
        h._error = error
        h._event = None
        h._resolved.set()
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
# the DLPack frontend bridge
# ---------------------------------------------------------------------------

_NUMPY = "numpy"          # frontend tag of numpy arrays
_TORCH_OUT = "torch"      # a foreign input whose framework has no importer


def _is_foreign(v) -> bool:
    return not isinstance(v, torch.Tensor) and (
        isinstance(v, np.ndarray) or hasattr(v, "__dlpack__"))


def _frontend_of(v):
    """Where results for the foreign input ``v`` go: ``'numpy'``, the
    module whose ``from_dlpack`` makes ``v``'s framework's arrays (its
    ``__array_namespace__()``, or the loaded module its type comes from),
    or ``'torch'`` when there is none."""
    if isinstance(v, np.ndarray):
        return _NUMPY
    ns = None
    get_ns = getattr(v, "__array_namespace__", None)
    if get_ns is not None:
        try:
            ns = get_ns()
        except Exception:
            ns = None
    if ns is None:
        ns = sys.modules.get(type(v).__module__.split(".")[0])
    return ns if ns is not None and hasattr(ns, "from_dlpack") \
        else _TORCH_OUT


def _dlpack_scan(x):
    """The frontend of the first foreign array in ``x`` (a list, tuple or
    one value), or None when there is none."""
    for v in (x if isinstance(x, (list, tuple)) else [x]):
        if _is_foreign(v):
            return _frontend_of(v)
    return None


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":         # no torch dtype for numpy's:
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _dlpack_import(x):
    """A foreign array as a torch tensor on this context's device
    (zero-copy where DLPack allows it); lists element-wise; everything
    else unchanged."""
    def one(v):
        if not _is_foreign(v):
            return v
        if isinstance(v, np.ndarray):
            t = _from_numpy(v)
        else:
            try:
                t = torch.from_dlpack(v)
            except Exception:
                # host copy: a dtype, layout or device the importer refuses
                try:
                    arr = np.asarray(v)
                except Exception as e:
                    dev = getattr(v, "device", "<unknown device>")
                    raise TypeError(
                        f"cannot ingest {type(v).__module__}."
                        f"{type(v).__name__} on {dev}: the zero-copy DLPack "
                        f"import was rejected and the frontend offers no "
                        f"host conversion; copy the tensor to CPU before "
                        f"passing it to horovod_tpu_torch") from e
                t = _from_numpy(arr)
        from horovod_tpu_torch.runtime import context
        ctx = context._context
        if ctx is not None and t.device != ctx.device:
            t = t.to(ctx.device)
        return t
    if isinstance(x, (list, tuple)):
        return [one(v) for v in x]
    return one(x)


def _torch_dtype(d) -> Optional[torch.dtype]:
    """The torch dtype of a frontend dtype (by its numpy name)."""
    if d is None:
        return None
    name = getattr(d, "name", None) or str(d)
    got = getattr(torch, str(name).replace("torch.", ""), None)
    return got if isinstance(got, torch.dtype) else None


def _to_numpy(t: torch.Tensor, d) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bf16 = d if getattr(d, "name", None) == "bfloat16" else getattr(
            sys.modules.get("ml_dtypes"), "bfloat16", None)
        if bf16 is None:
            return t.float().numpy()
        return t.view(torch.uint16).numpy().view(bf16)
    return t.numpy()


def _dlpack_export(value, frontend, dtypes=None):
    """Torch results -> the frontend's arrays, recursively over lists and
    tuples (alltoall with splits returns ``(rows, received_splits)``).
    ``dtypes`` (one caller dtype, or a list for grouped ops) restores the
    input's dtype within its family (float to float, integer to integer),
    so an integer output such as the received splits never takes a float
    input's dtype."""
    def cast(t, d):
        td = _torch_dtype(d)
        if td is None or td == t.dtype:
            return t
        if t.is_floating_point() == td.is_floating_point \
                and t.is_complex() == td.is_complex:
            return t.to(td)
        return t

    def one(a, d):
        if not isinstance(a, torch.Tensor):
            return a
        a = cast(a, d)
        if frontend == _NUMPY:
            return _to_numpy(a, d)
        if frontend == _TORCH_OUT:
            return a
        for src in (a.detach(), a.detach().cpu()):
            try:
                return frontend.from_dlpack(src)
            except Exception:
                continue
        return a                # the frontend refuses it: torch out

    def walk(v, d):
        if isinstance(v, tuple):
            return tuple(walk(e, d) for e in v)
        if isinstance(v, list):
            if isinstance(d, list) and len(d) == len(v):
                return [walk(e, de) for e, de in zip(v, d)]
            return [walk(e, d) for e in v]
        return one(v, d if not isinstance(d, list) else
                   (d[0] if d else None))

    return walk(value, dtypes)


def _frontend_bridge(fn):
    """Wrap a public collective so foreign input arrays come in through
    DLPack and results go back in the same framework; an async function
    tags its Handle, which converts at ``wait()``."""
    first_param = next(iter(inspect.signature(fn).parameters))

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if args:
            x = args[0]
        elif first_param in kwargs:     # keyword call (tensors=grads)
            x = kwargs[first_param]
        else:
            return fn(*args, **kwargs)
        frontend = _dlpack_scan(x)
        if frontend is None:
            return fn(*args, **kwargs)
        if isinstance(x, (list, tuple)):
            dtypes = [getattr(v, "dtype", None) if _is_foreign(v) else None
                      for v in x]
        else:
            dtypes = getattr(x, "dtype", None)
        converted = _dlpack_import(x)
        if args:
            args = (converted,) + args[1:]
        else:
            kwargs = dict(kwargs, **{first_param: converted})
        out = fn(*args, **kwargs)
        if isinstance(out, Handle):
            out._frontend = (frontend, dtypes)
            return out
        return _dlpack_export(out, frontend, dtypes)
    return wrapped


# ---------------------------------------------------------------------------
# the coordinator's queue
# ---------------------------------------------------------------------------

def _enqueue_async(op_type: str, tensor: torch.Tensor, name: Optional[str],
                   *, op=None, process_set=None, prescale_factor=None,
                   postscale_factor=None, root_rank=0, splits=None,
                   group_id=None, group_size=0) -> Handle:
    """Create a pending handle and enqueue the request with the context's
    coordinator (ref EnqueueTensorAllreduce operations.cc:1404); a cycle
    fuses compatible queued tensors and dispatches one collective per bin
    and dtype."""
    from horovod_tpu_torch.ops.coordinator import Entry, get_coordinator
    ctx = get_context()
    if op is not None:
        op = check_supported(op)
    if op_type in ("allgather", "alltoall", "reducescatter") \
            and tensor.dim() == 0:
        raise ValueError(f"{op_type} needs at least one dimension")
    handle = Handle.pending(name or _auto_name(op_type))
    entry = Entry(name=handle.name, op_type=op_type, x=tensor, handle=handle,
                  op=op if op is not None else ReduceOp.AVERAGE,
                  process_set=process_set, prescale_factor=prescale_factor,
                  postscale_factor=postscale_factor, root_rank=root_rank,
                  splits=splits, group_id=group_id, group_size=group_size)
    try:
        coordinator = get_coordinator(ctx)
        handle._coordinator = coordinator
        coordinator.enqueue(entry)
    except Exception:
        # The rejected handle must not untrack the ORIGINAL in-flight op of
        # the same name from the stall inspector when it is collected.
        handle._tracked = False
        with _outstanding_lock:
            _outstanding.discard(handle)
        raise
    return handle


_group_lock = threading.Lock()
_group_counter = 0


def _next_group_id() -> int:
    global _group_counter
    with _group_lock:
        _group_counter += 1
        return _group_counter


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@_frontend_bridge
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


@_frontend_bridge
def allreduce_async(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                    process_set=None,
                    prescale_factor: Optional[float] = None,
                    postscale_factor: Optional[float] = None,
                    name: Optional[str] = None) -> Handle:
    if check_supported(op) == ReduceOp.ADASUM:
        return _handle("allreduce", name, _allreduce_start(
            tensor, op, process_set, prescale_factor, postscale_factor),
            tensor)
    return _enqueue_async("allreduce", tensor, name, op=op,
                          process_set=process_set,
                          prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor)


@_frontend_bridge
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


@_frontend_bridge
def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            op: ReduceOp = ReduceOp.AVERAGE,
                            process_set=None,
                            prescale_factor: Optional[float] = None,
                            postscale_factor: Optional[float] = None,
                            name: Optional[str] = None) -> Handle:
    """One handle for the group: ``wait()`` returns the list. The tensors
    are enqueued as one registered group, which the coordinator never
    splits across bins (ref GroupTable group_table.h,
    controller.cc:330-377)."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("grouped_allreduce needs at least one tensor")
    if check_supported(op) == ReduceOp.ADASUM:
        return _handle("grouped_allreduce", name, C.grouped_allreduce_start(
            tensors, op, _axis(), process_set, prescale_factor,
            postscale_factor, _joined_for(process_set)), tensors[0])
    gid = _next_group_id()
    base = name or _auto_name("grouped_allreduce")
    parts: List[Handle] = []
    try:
        for i, t in enumerate(tensors):
            parts.append(_enqueue_async(
                "allreduce", t, f"{base}.{i}", op=op,
                process_set=process_set, prescale_factor=prescale_factor,
                postscale_factor=postscale_factor, group_id=gid,
                group_size=len(tensors)))
    except Exception as exc:
        # Abort the whole group: members already queued would otherwise be
        # deferred forever (the group can never complete).
        from horovod_tpu_torch.ops.coordinator import get_coordinator
        removed = get_coordinator(get_context()).queue.remove_group(gid)
        abort = RuntimeError(f"grouped_allreduce {base} aborted: member "
                             f"{len(parts)} failed to enqueue: {exc}")
        for e in removed:
            e.handle._set_error(abort)
        for h in parts:
            if not h._resolved.is_set():
                h._set_error(abort)
        raise
    return _GroupedHandle(base, parts)


@_frontend_bridge
def allgather(tensor: torch.Tensor, process_set=None,
              name: Optional[str] = None,
              _joined: Optional[tuple] = None) -> torch.Tensor:
    """Every rank's ``tensor`` (first dims may differ) concatenated along
    dim 0 in rank order; a joined rank's rows are left out. ``_joined``:
    the coordinator's enqueue-time snapshot of the join registry, for a
    deferred dispatch."""
    del name
    return _allgather_start(tensor, process_set, _joined).wait()


def _allgather_start(tensor, process_set, joined=None):
    if joined is None:
        joined = _joined_for(process_set)
    if tensor.dim() and get_context().rank in joined:
        tensor = tensor[:0]
    return C.allgather_start(tensor, _axis(), process_set)


@_frontend_bridge
def allgather_async(tensor: torch.Tensor, process_set=None,
                    name: Optional[str] = None) -> Handle:
    """Queued: the coordinator gathers the first dims of a cycle's
    allgathers in one exchange, then fuses them."""
    return _enqueue_async("allgather", tensor, name, process_set=process_set)


@_frontend_bridge
def broadcast(tensor: torch.Tensor, root_rank: int = 0, process_set=None,
              name: Optional[str] = None) -> torch.Tensor:
    """The root's ``tensor`` on every rank (ref torch/mpi_ops.py
    broadcast), as a new tensor."""
    del name
    return C.broadcast(tensor, root_rank, _axis(), process_set)


@_frontend_bridge
def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    process_set=None, name: Optional[str] = None) -> Handle:
    return _enqueue_async("broadcast", tensor, name, root_rank=root_rank,
                          process_set=process_set)


@_frontend_bridge
def alltoall(tensor: torch.Tensor, splits=None, process_set=None,
             name: Optional[str] = None):
    """Dim 0 split into per-rank chunks, chunk i to rank i; with
    ``splits`` returns ``(out, received_splits)`` (ref torch/mpi_ops.py
    alltoall)."""
    del name
    return C.alltoall(tensor, splits, _axis(), process_set)


@_frontend_bridge
def alltoall_async(tensor: torch.Tensor, splits=None, process_set=None,
                   name: Optional[str] = None) -> Handle:
    """Never fused: the coordinator dispatches it alone."""
    return _enqueue_async("alltoall", tensor, name, splits=splits,
                          process_set=process_set)


@_frontend_bridge
def reducescatter(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                  process_set=None, prescale_factor: Optional[float] = None,
                  postscale_factor: Optional[float] = None,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce, then rank i keeps the i-th slice of dim 0 (the first
    ``rows % n`` ranks one row more; ref collective_operations.h:282)."""
    del name
    return C.reducescatter(tensor, op, _axis(), process_set,
                           prescale_factor, postscale_factor)


@_frontend_bridge
def reducescatter_async(tensor: torch.Tensor,
                        op: ReduceOp = ReduceOp.AVERAGE, process_set=None,
                        prescale_factor: Optional[float] = None,
                        postscale_factor: Optional[float] = None,
                        name: Optional[str] = None) -> Handle:
    """Never fused: the coordinator dispatches it alone."""
    return _enqueue_async("reducescatter", tensor, name, op=op,
                          process_set=process_set,
                          prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor)


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
