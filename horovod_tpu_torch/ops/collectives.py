"""Collectives of the port over ``torch.distributed`` process groups (NCCL
on the card, gloo on the CPU): the counterpart of
``horovod_tpu/ops/collectives.py`` (l.63-568) and of the uneven forms of
``horovod_tpu/eager.py`` (l.740-1120).

**Semantics.** Per rank and SPMD, as in the reference Horovod's PyTorch
API: every rank calls the function with ITS OWN tensor and the same
``axis=``/``process_set=`` arguments, and rank r gets what device r holds
after the JAX in-jit function of the same name runs under ``shard_map``.
The JAX eager API's rank-stacked ``x`` of shape ``(size, ...)`` is rank r
passing ``x[r]`` here.

**Axes** name the mesh of ``runtime/topology.py``; a collective over an
axis (or a tuple of them, linearized row-major in the order given) runs
within this rank's row along it, on that row's process group
(``runtime.context.Context.axis_group``). ``hvd`` names every rank, also
on a mesh that has no ``hvd`` axis. A ``process_set`` partitions the
ranks of an ``axis`` that spans the world: for reductions and broadcast
the members act together and every other rank keeps its own value (the
JAX package's member group plus singletons); the shape-changing
collectives (allgather, alltoall, reducescatter) run in this rank's group
of the set's size-uniform partition where one exists
(:func:`_uniform_partition_groups`), so each rank gets its own group's
result, and otherwise (a ragged set) in the set's own group, every other
rank keeping its own value (the JAX eager layer's host-mediated path,
``eager.py`` l.803 and 921).

**Uneven forms** (the JAX eager layer's): ``allgather`` of first dims
that differ between ranks; ``alltoall(x, splits=)`` returning ``(out,
received_splits)``; ``reducescatter`` of rows not divisible by the group
(the first ``rows % n`` ranks take one more row). Data movement goes as
bytes (``uint8``), so every dtype moves on both backends.

``allreduce`` supports Sum, Average (the eager default), Min, Max,
Product and Adasum (``ops/adasum.py``) with ``prescale_factor``/
``postscale_factor`` (applied in the tensor's dtype, as in the JAX
package). ``joined_ranks`` (indices along the axis) are ranks that joined
(``eager.join``): they contribute the op's identity, and Average divides
by the active count of each rank's group. ``allreduce_`` and
``broadcast_`` work in place. ``psum`` is the differentiable sum over the
ranks that a model calls inside a step whose axis is bound
(``bind_axis``): sync batch norm. ``allreduce_async`` and
``wire_sum_async`` start the SUMs of the bucketed gradient sync
(``parallel/distributed.py``) and return a handle to wait on. Each
collective of the eager API also has a ``*_start`` form returning a
:class:`_Pending` (its ``torch.distributed`` works and the step that
forms the result once they are done), which ``eager.py``'s handles wrap.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.profiler import record_function

from horovod_tpu_torch.ops.reduce_ops import ReduceOp, check_supported
from horovod_tpu_torch.runtime.context import Group, get_context
from horovod_tpu_torch.runtime.topology import (CROSS_AXIS, DCN_AXIS,
                                                HVD_AXIS, LOCAL_AXIS,
                                                AxisSpec)

_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.AVERAGE: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def wait_work(work) -> None:
    """``work.wait()`` of a ``torch.distributed`` work. Under
    ``HOROVOD_ELASTIC`` a work that fails raises
    ``elastic.HorovodInternalError`` (ref WaitForEventsElastic
    gpu_operations.cc:98-106), the error ``elastic.run`` recovers from."""
    try:
        work.wait()
    except Exception as exc:
        from horovod_tpu_torch.config import knobs
        from horovod_tpu_torch.elastic.exceptions import HorovodInternalError
        if isinstance(exc, HorovodInternalError) or \
                not knobs.get("HOROVOD_ELASTIC"):
            raise
        raise HorovodInternalError(f"collective failed: {exc}") from exc


class _Done:
    """The handle of a collective that had nothing to do (a group of
    one)."""

    @staticmethod
    def wait() -> bool:
        return True


class _Pending:
    """A started collective: ``works`` (``torch.distributed`` Work
    objects, started with ``async_op=True``) to wait on, then ``finish()``
    forms the result from their buffers. A collective of several
    dependent stages runs all but its last when it starts."""

    __slots__ = ("works", "finish")

    def __init__(self, works, finish):
        self.works = [w for w in works if w is not None]
        self.finish = finish

    def is_completed(self) -> bool:
        return all(w.is_completed() for w in self.works)

    def wait(self):
        for w in self.works:
            wait_work(w)
        # some gloo works (reduce_scatter_tensor's) never report
        # completion, even once waited on
        self.works = []
        return self.finish()


def _ready(value) -> _Pending:
    """A :class:`_Pending` whose result is already there."""
    return _Pending((), lambda: value)


def _scale_(x: torch.Tensor, factor: Optional[float]) -> torch.Tensor:
    """x *= factor in place, in x's dtype (integers through f32/f64, as
    the JAX ``_apply_scale`` does)."""
    if factor is None or factor == 1.0:
        return x
    if x.is_floating_point():
        return x.mul_(factor)
    wide = torch.float64 if x.dtype == torch.int64 else torch.float32
    return x.copy_((x.to(wide) * factor).to(x.dtype))


def _join_neutral(op: ReduceOp, dtype: torch.dtype):
    """The identity of ``op`` in ``dtype``: what padding contributes."""
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
        return 0
    floating = dtype.is_floating_point
    if op == ReduceOp.MIN:
        return float("inf") if floating else torch.iinfo(dtype).max
    if op == ReduceOp.MAX:
        return float("-inf") if floating else torch.iinfo(dtype).min
    if op == ReduceOp.PRODUCT:
        return 1
    raise ValueError(f"join does not support {op}")


# ---------------------------------------------------------------------------
# groups: axes and process sets -> this rank's Group
# ---------------------------------------------------------------------------

def axis_rank(axis: AxisSpec = HVD_AXIS) -> int:
    """This rank's index along ``axis`` (row-major over several axes)."""
    return get_context().axis_group(axis).index


def axis_size(axis: AxisSpec = HVD_AXIS) -> int:
    """Ranks along ``axis``; inside a step that binds ``axis`` with
    :func:`bind_axis`, the ranks :func:`psum` sums over."""
    if isinstance(axis, str) and axis in _bound_axes.get():
        return get_context().size
    return get_context().topology.axis_size(axis)


def _resolve_groups(process_set, axis: AxisSpec = HVD_AXIS):
    """``(axis_index_groups, group size per rank, group rank per rank)``
    of a process set, or ``(None, None, None)`` for the global set: the
    JAX package's tables, in numpy."""
    if process_set is None or process_set.process_set_id == 0:
        return None, None, None
    groups = process_set.axis_index_groups()
    world = sum(len(g) for g in groups)
    gsize = np.ones((world,), np.int32)
    grank = np.zeros((world,), np.int32)
    for g in groups:
        for i, r in enumerate(g):
            gsize[r] = len(g)
            grank[r] = i
    return groups, gsize, grank


def _uniform_partition_groups(process_set, opname: str):
    """The partition a shape-changing collective over ``process_set``
    runs in, or None for the global set. Where one exists it is the JAX
    package's size-uniform partition (l.250-303): (1) the set with
    registered disjoint sets of its size that cover the world (seeded with
    this set); (2) else, for an aligned contiguous set, the contiguous
    chunks of its size. Otherwise (a ragged set, which the JAX in-jit
    layer rejects and its eager layer runs host-mediated) it is the set's
    member group and a singleton per other rank, as for the reductions.
    ``opname`` names the collective for the caller's errors."""
    del opname
    if process_set is None or process_set.process_set_id == 0:
        return None
    process_set._check_registered()
    table = process_set._table
    world = table.world_size
    k = len(process_set.ranks)
    if k and world % k == 0:
        siblings = [s for s in table.all_sets()
                    if s.process_set_id != 0 and s.ranks
                    and len(s.ranks) == k]
        cover: List[List[int]] = [list(process_set.ranks)]
        seen: set = set(process_set.ranks)
        for s in siblings:
            if not seen.intersection(s.ranks):
                cover.append(list(s.ranks))
                seen.update(s.ranks)
        if len(seen) == world:
            return sorted(cover)
        ranks = list(process_set.ranks)
        if ranks == list(range(ranks[0], ranks[0] + k)) \
                and ranks[0] % k == 0:
            return [list(range(g * k, (g + 1) * k))
                    for g in range(world // k)]
    return process_set.axis_index_groups()


def _frame(axis: AxisSpec, process_set) -> Group:
    """This rank's group along ``axis``; with a process set the axis must
    span the world (the set's ranks index it)."""
    ctx = get_context()
    g = ctx.axis_group(axis)
    if process_set is not None and process_set.process_set_id != 0 \
            and g.size != ctx.size:
        raise ValueError(
            f"process_set needs an axis over every rank; {axis!r} spans "
            f"{g.size} of {ctx.size}")
    return g


def _set_group(axis: AxisSpec, process_set) -> Group:
    """The group a reduction or broadcast over ``process_set`` runs in:
    the members' group for a member, a group of one otherwise."""
    g = _frame(axis, process_set)
    groups, _, _ = _resolve_groups(process_set, axis)
    if groups is None:
        return g
    members = [g.members[i] for i in groups[0]]
    sub = get_context().subgroup(members)
    return sub if sub is not None else Group([g.members[g.index]], 0, None)


def _uniform_group(axis: AxisSpec, process_set, opname: str) -> Group:
    """The group of a shape-changing collective: the axis row, or this
    rank's group of the set's partition
    (:func:`_uniform_partition_groups`)."""
    g = _frame(axis, process_set)
    partition = _uniform_partition_groups(process_set, opname)
    if partition is None:
        return g
    glob = [[g.members[i] for i in grp] for grp in partition]
    mine = next(grp for grp in glob if g.members[g.index] in grp)
    return get_context().subgroup(mine, glob)


def _outside(process_set, g: Group) -> bool:
    """True on a rank outside a ragged ``process_set``: it keeps its own
    value."""
    return (g.pg is None and process_set is not None
            and process_set.process_set_id != 0
            and not process_set.included())


# ---------------------------------------------------------------------------
# primitives over one Group (members in axis order); bytes for movement
# ---------------------------------------------------------------------------

def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _to_torch_order(chunks: Sequence[torch.Tensor], g: Group):
    """Chunks listed by member position, reordered by torch group rank."""
    return list(chunks) if g.ordered else [chunks[p] for p in g.torch_order]


def _from_torch_order(chunks: Sequence[torch.Tensor], g: Group):
    if g.ordered:
        return list(chunks)
    out = [None] * g.size
    for j, p in enumerate(g.torch_order):
        out[p] = chunks[j]
    return out


def _all_gather_start(x: torch.Tensor, g: Group) -> _Pending:
    """Every member's ``x`` (same shape on each), concatenated along dim 0
    in member order."""
    if g.pg is None:
        return _ready(x.clone())
    src = _bytes(x)
    buf = torch.empty(g.size * src.numel(), dtype=torch.uint8,
                      device=x.device)
    work = dist.all_gather_into_tensor(buf, src, group=g.pg, async_op=True)
    shape = (g.size * x.shape[0],) + x.shape[1:]

    def finish():
        out = buf if g.ordered else torch.cat(
            _from_torch_order(buf.chunk(g.size), g))
        return out.view(x.dtype).reshape(shape)

    return _Pending([work], finish)


def _all_gather(x: torch.Tensor, g: Group, async_op: bool = False):
    """:func:`_all_gather_start`, waited on; with ``async_op`` returns
    ``(handle, out)``, ``out`` valid once ``handle.wait()`` returned."""
    if not async_op:
        return _all_gather_start(x, g).wait()
    if g.pg is None:
        return _Done(), x.clone()
    p = _all_gather_start(x, g)
    if not g.ordered:
        return _Done(), p.wait()
    return p.works[0], p.finish()


def _reduce_scatter_start(x: torch.Tensor, op: ReduceOp, g: Group
                          ) -> _Pending:
    """Chunk i of dim 0 (``x.shape[0] % g.size == 0``) reduced over the
    members with ``op`` lands on member i."""
    if g.pg is None:
        return _ready(x.clone())
    chunks = x.chunk(g.size)
    src = x.contiguous() if g.ordered else torch.cat(
        _to_torch_order(chunks, g))
    out = torch.empty_like(chunks[0])
    work = dist.reduce_scatter_tensor(out, src, op=_TORCH_OP[op],
                                      group=g.pg, async_op=True)
    return _Pending([work], lambda: out)


def _reduce_scatter(x: torch.Tensor, op: ReduceOp, g: Group
                    ) -> torch.Tensor:
    return _reduce_scatter_start(x, op, g).wait()


def _all_to_all_start(x: torch.Tensor, g: Group, send_rows: Sequence[int],
                      recv_rows: Sequence[int]) -> _Pending:
    """Rows ``send_rows[i]`` of ``x`` (in order) go to member i; the
    result is what arrives, ``recv_rows[i]`` rows from member i, in member
    order."""
    trailing = x.shape[1:]
    if g.pg is None:
        return _ready(x.clone())
    row = int(np.prod(trailing, dtype=np.int64)) * x.element_size()
    src = _bytes(x)
    if not g.ordered:
        pieces = list(src.split([r * row for r in send_rows]))
        src = torch.cat(_to_torch_order(pieces, g))
    in_sizes = [r * row for r in _to_torch_order(list(send_rows), g)]
    out_sizes = [r * row for r in _to_torch_order(list(recv_rows), g)]
    buf = torch.empty(sum(out_sizes), dtype=torch.uint8, device=x.device)
    work = dist.all_to_all_single(buf, src, output_split_sizes=out_sizes,
                                  input_split_sizes=in_sizes, group=g.pg,
                                  async_op=True)

    def finish():
        out = buf if g.ordered else torch.cat(
            _from_torch_order(list(buf.split(out_sizes)), g))
        return out.view(x.dtype).reshape((sum(recv_rows),) + trailing)

    return _Pending([work], finish)


def _exchange_ints(vals: Sequence[int], g: Group, device) -> np.ndarray:
    """[g.size, len(vals)] table of every member's ``vals`` (one small
    all-gather and a host sync)."""
    t = torch.tensor(list(vals), dtype=torch.int64, device=device)
    return _all_gather(t.reshape(1, -1), g).cpu().numpy()


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _active_count(g: Group, frame: Group, joined: Sequence[int]) -> int:
    """Members of ``g`` that did not join (``joined`` indexes ``frame``),
    at least 1: what Average divides by."""
    if not joined:
        return g.size
    out = {frame.members[j] for j in joined if 0 <= j < frame.size}
    return max(sum(1 for m in g.members if m not in out), 1)


def allreduce_start(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                    axis: AxisSpec = HVD_AXIS, process_set=None,
                    prescale_factor: Optional[float] = None,
                    postscale_factor: Optional[float] = None,
                    joined_ranks: Sequence[int] = (),
                    inplace: bool = False) -> _Pending:
    """Start :func:`allreduce` (``inplace``: :func:`allreduce_`). Adasum
    runs its butterfly before it returns."""
    op = check_supported(op)
    if inplace and op == ReduceOp.AVERAGE and not tensor.is_floating_point():
        raise TypeError("allreduce_: Average of an integer tensor cannot "
                        "stay in place; use allreduce")
    frame = _frame(axis, process_set)
    joined = tuple(int(j) for j in joined_ranks)
    buf = tensor if inplace else tensor.clone()
    if frame.index in joined:
        buf.fill_(_join_neutral(op, buf.dtype))
    _scale_(buf, prescale_factor)
    if op == ReduceOp.ADASUM:
        from horovod_tpu_torch.ops.adasum import adasum_allreduce
        out = _scale_(adasum_allreduce(buf, axis, process_set, joined),
                      postscale_factor)
        return _ready(buf.copy_(out) if inplace else out)
    g = _set_group(axis, process_set)
    work = (dist.all_reduce(buf, op=_TORCH_OP[op], group=g.pg,
                            async_op=True) if g.pg is not None else None)

    def finish():
        out = buf
        if op == ReduceOp.AVERAGE:
            n = _active_count(g, frame, joined)
            out = buf.div_(n) if buf.is_floating_point() else buf / n
        return _scale_(out, postscale_factor)

    return _Pending([work], finish)


def allreduce_(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
               axis: AxisSpec = HVD_AXIS, process_set=None,
               prescale_factor: Optional[float] = None,
               postscale_factor: Optional[float] = None,
               joined_ranks: Sequence[int] = ()) -> torch.Tensor:
    """In-place allreduce of this rank's ``tensor`` over ``axis`` (and
    ``process_set``); returns it. Average divides the sum by the group's
    active size (floating-point tensors only)."""
    return allreduce_start(tensor, op, axis, process_set, prescale_factor,
                           postscale_factor, joined_ranks,
                           inplace=True).wait()


def allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              axis: AxisSpec = HVD_AXIS, process_set=None,
              prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None,
              joined_ranks: Sequence[int] = ()) -> torch.Tensor:
    """Allreduce of this rank's ``tensor`` into a new tensor (the input is
    left as it was). Members of ``process_set`` get the set's reduction,
    other ranks their own value (scaled). Average of an integer tensor
    returns a floating-point result, as the JAX package's does."""
    return allreduce_start(tensor, op, axis, process_set, prescale_factor,
                           postscale_factor, joined_ranks).wait()


def grouped_allreduce_start(tensors: Sequence[torch.Tensor],
                            op: ReduceOp = ReduceOp.AVERAGE,
                            axis: AxisSpec = HVD_AXIS, process_set=None,
                            prescale_factor: Optional[float] = None,
                            postscale_factor: Optional[float] = None,
                            joined_ranks: Sequence[int] = ()) -> _Pending:
    """Start :func:`grouped_allreduce`: one collective per dtype buffer
    (per tensor with HOROVOD_BATCH_D2D_MEMCOPIES=0), all in flight
    together."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops.fusion import (flatten_for_fusion,
                                              unflatten_from_fusion)
    tensors = list(tensors)
    if knobs.get("HOROVOD_BATCH_D2D_MEMCOPIES") and len(tensors) > 1:
        by_dtype: dict = {}
        for i, x in enumerate(tensors):
            by_dtype.setdefault(x.dtype, []).append(i)
        groups = list(by_dtype.values())
    else:
        groups = [[i] for i in range(len(tensors))]
    starts = []
    for idxs in groups:
        buf, specs = flatten_for_fusion([tensors[i] for i in idxs])
        starts.append((idxs, specs, allreduce_start(
            buf, op, axis, process_set, prescale_factor, postscale_factor,
            joined_ranks)))

    def finish():
        out: List[torch.Tensor] = [None] * len(tensors)  # type: ignore
        for idxs, specs, p in starts:
            for i, v in zip(idxs, unflatten_from_fusion(p.finish(), specs)):
                out[i] = v
        return out

    return _Pending([w for _, _, p in starts for w in p.works], finish)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE,
                      axis: AxisSpec = HVD_AXIS, process_set=None,
                      prescale_factor: Optional[float] = None,
                      postscale_factor: Optional[float] = None,
                      joined_ranks: Sequence[int] = ()
                      ) -> List[torch.Tensor]:
    """All tensors reduced as one logical op: packed into one buffer per
    dtype, one collective per buffer, unpacked (``ops.fusion``'s packing,
    honouring HOROVOD_BATCH_D2D_MEMCOPIES; Adasum then combines each
    packed buffer as one vector, as the JAX package's does). Inputs are
    left as they were."""
    return grouped_allreduce_start(tensors, op, axis, process_set,
                                   prescale_factor, postscale_factor,
                                   joined_ranks).wait()


def allreduce_async(buf: torch.Tensor, axis: AxisSpec = HVD_AXIS):
    """Start the in-place SUM of this rank's ``buf`` over ``axis``;
    returns the handle (``.wait()``)."""
    g = get_context().axis_group(axis)
    if g.pg is None:
        return _Done()
    return dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g.pg,
                           async_op=True)


def wire_sum_async(wire: torch.Tensor, axis: AxisSpec = HVD_AXIS):
    """Start the SUM of this rank's wire buffer (bf16, fp16 or fp8) over
    ``axis``; returns ``(handle, out)``: ``out`` holds the sum in the wire
    dtype once ``handle.wait()`` has returned.

    gloo has no fp8 sums and NCCL refuses float8 reductions in many torch
    builds, so both backends take one route, which is the JAX package's
    CPU semantics (XLA sums bf16 in f32 and fp8 in f16, then rounds once):
    the buffer is padded to a multiple of n (the group's size),
    ``all_to_all_single`` of its bytes hands each rank every member's copy
    of its own shard, the n copies are summed in f32 in group-rank order
    and rounded once to the wire dtype, and ``all_gather_into_tensor`` of
    the bytes puts the full sum on every rank. It moves 2(n-1)/n of the
    wire bytes per rank, as a ring allreduce does. The process group keeps
    the buffers the all_gather reads and writes alive until
    ``handle.wait()``; on the card the caller records ``out`` on the
    stream that reads it."""
    g = get_context().axis_group(axis)
    if g.pg is None:
        return _Done(), wire.clone()
    world = g.size
    n, dtype = wire.numel(), wire.dtype
    pad = (-n) % world
    # bytes throughout: the wire dtype only for the sum
    flat = wire.reshape(-1).view(torch.uint8)
    if pad:
        flat = torch.cat([flat, torch.zeros(pad * dtype.itemsize,
                                            dtype=torch.uint8,
                                            device=wire.device)])
    recv = torch.empty_like(flat)
    dist.all_to_all_single(recv, flat, group=g.pg, async_op=True).wait()
    shards = recv.view(dtype).view(world, (n + pad) // world)
    acc = shards[0].float()
    for r in range(1, world):
        acc += shards[r].float()
    mine = acc.to(dtype).view(torch.uint8)
    out = torch.empty_like(flat)
    work = dist.all_gather_into_tensor(out, mine, group=g.pg, async_op=True)
    return work, out.view(dtype)[:n].view(wire.shape)


def reducescatter_start(tensor: torch.Tensor,
                        op: ReduceOp = ReduceOp.AVERAGE,
                        axis: AxisSpec = HVD_AXIS, process_set=None,
                        prescale_factor: Optional[float] = None,
                        postscale_factor: Optional[float] = None
                        ) -> _Pending:
    """Start :func:`reducescatter`."""
    op = check_supported(op)
    if op == ReduceOp.ADASUM:
        raise ValueError("reducescatter does not support Adasum")
    if tensor.dim() == 0:
        raise ValueError("reducescatter needs at least one dimension")
    g = _uniform_group(axis, process_set, "reducescatter")
    n, rows = g.size, tensor.shape[0]
    base, rem = divmod(rows, n)
    counts = [base + (1 if r < rem else 0) for r in range(n)]
    mine = counts[g.index]
    x = _scale_(tensor.clone(), prescale_factor)
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE):
        if rem:
            width = base + 1
            padded = x.new_zeros((n * width,) + x.shape[1:])
            off = 0
            for r, c in enumerate(counts):
                padded[r * width:r * width + c] = x[off:off + c]
                off += c
            p = _reduce_scatter_start(padded, ReduceOp.SUM, g)
        else:
            p = _reduce_scatter_start(x, ReduceOp.SUM, g)

        def finish():
            out = p.finish()[:mine]
            if op == ReduceOp.AVERAGE:
                out = out / n
            return _scale_(out, postscale_factor)

        return _Pending(p.works, finish)
    if g.size != _frame(axis, None).size:
        raise NotImplementedError(
            f"subgroup reducescatter supports SUM/AVERAGE (got {op})")
    work = (dist.all_reduce(x, op=_TORCH_OP[op], group=g.pg, async_op=True)
            if g.pg is not None else None)
    off = sum(counts[:g.index])
    return _Pending([work], lambda: _scale_(x[off:off + mine].clone(),
                                            postscale_factor))


def reducescatter(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                  axis: AxisSpec = HVD_AXIS, process_set=None,
                  prescale_factor: Optional[float] = None,
                  postscale_factor: Optional[float] = None) -> torch.Tensor:
    """Reduce over the group, then member i keeps the i-th slice of dim 0.
    Rows not divisible by the group's size n follow the reference's rule:
    the first ``rows % n`` members take one more row. Sum and Average run
    one reduce-scatter (uneven chunks padded with zeros, then trimmed);
    Min, Max and Product an allreduce and a slice, over the axis only (a
    process set raises, as the JAX package's in-jit op does)."""
    return reducescatter_start(tensor, op, axis, process_set,
                               prescale_factor, postscale_factor).wait()


# ---------------------------------------------------------------------------
# data movement
# ---------------------------------------------------------------------------

def allgather_start(tensor: torch.Tensor, axis: AxisSpec = HVD_AXIS,
                    process_set=None) -> _Pending:
    """Start :func:`allgather`: the first dims are exchanged (a host
    sync) before the gather starts."""
    from horovod_tpu_torch.config import knobs
    if tensor.dim() == 0:
        raise ValueError("allgather needs at least one dimension")
    g = _uniform_group(axis, process_set, "allgather")
    if g.pg is None:
        return _ready(tensor.clone())
    trailing = int(np.prod(tensor.shape[1:], dtype=np.int64))
    meta = _exchange_ints([tensor.shape[0], trailing, tensor.dim()], g,
                          tensor.device)
    if len({tuple(r[1:]) for r in meta}) != 1:
        raise ValueError("allgather requires matching trailing dims on "
                         f"every rank; got (numel, ndim) {meta[:, 1:]}")
    rows = [int(r) for r in meta[:, 0]]
    maxn = max(rows)
    if min(rows) == maxn:
        axes = get_context().topology.resolve_axes(axis)
        if (process_set is None or process_set.process_set_id == 0) \
                and len(axes) > 1 \
                and knobs.get("HOROVOD_HIERARCHICAL_ALLGATHER"):
            out = tensor
            for ax in reversed(axes):
                out = _all_gather(out, get_context().axis_group(ax))
            return _ready(out)
        return _all_gather_start(tensor, g)
    padded = tensor.new_zeros((maxn,) + tensor.shape[1:])
    padded[:tensor.shape[0]] = tensor
    p = _all_gather_start(padded, g)

    def finish():
        full = p.finish()
        return torch.cat([full[r * maxn:r * maxn + c]
                          for r, c in enumerate(rows)])

    return _Pending(p.works, finish)


def allgather(tensor: torch.Tensor, axis: AxisSpec = HVD_AXIS,
              process_set=None) -> torch.Tensor:
    """Every member's ``tensor`` concatenated along dim 0, in member
    order. First dims may differ between ranks (allgatherv): the first
    dims are exchanged first (one small all-gather and a host sync on
    every call), each rank's rows are padded to the largest, gathered in
    one ``all_gather_into_tensor`` and trimmed. Trailing dims must match.
    With HOROVOD_HIERARCHICAL_ALLGATHER and several axes, even inputs
    gather axis by axis, innermost first (same result)."""
    return allgather_start(tensor, axis, process_set).wait()


def alltoall_start(tensor: torch.Tensor, splits=None,
                   axis: AxisSpec = HVD_AXIS, process_set=None) -> _Pending:
    """Start :func:`alltoall`: with ``splits`` the send vectors are
    exchanged (a host sync) before the rows move."""
    if tensor.dim() == 0:
        raise ValueError("alltoall needs at least one dimension")
    g = _uniform_group(axis, process_set, "alltoall")
    n, rows = g.size, tensor.shape[0]
    if splits is None:
        if rows % n != 0:
            raise ValueError(
                f"alltoall first dim {rows} not divisible by group size {n}")
        c = rows // n
        return _all_to_all_start(tensor, g, [c] * n, [c] * n)
    if _outside(process_set, g):
        return _ready((tensor.clone(), torch.tensor([rows],
                                                    dtype=torch.int64)))
    send = [int(s) for s in (splits.tolist() if torch.is_tensor(splits)
                             else splits)]
    if len(send) != n:
        raise ValueError(f"splits must have {n} entries, got {len(send)}")
    table = _exchange_ints([rows] + send, g, tensor.device)
    bad = [r for r in range(n) if table[r, 1:].sum() != table[r, 0]
           or (table[r, 1:] < 0).any()]
    if bad:
        raise ValueError(
            f"splits of member(s) {bad} do not sum to their first dims: "
            f"{table.tolist()}")
    recv = [int(v) for v in table[:, 1 + g.index]]
    p = _all_to_all_start(tensor, g, send, recv)
    return _Pending(p.works, lambda: (p.finish(), torch.tensor(
        recv, dtype=torch.int64)))


def alltoall(tensor: torch.Tensor, splits=None, axis: AxisSpec = HVD_AXIS,
             process_set=None):
    """All-to-all over dim 0. Without ``splits`` dim 0 splits into n equal
    chunks (n = the group's size), chunk i goes to member i, and the
    result is the chunks received, in member order. With ``splits`` (n
    row counts: ``splits[i]`` rows go to member i) returns ``(out,
    received_splits)``: every rank's send vector is exchanged first (one
    small all-gather, read on the host), then the rows move in one uneven
    ``all_to_all_single``; ``received_splits`` is a CPU int64 tensor. A
    rank outside a ragged process set keeps its own rows."""
    return alltoall_start(tensor, splits, axis, process_set).wait()


def ppermute(tensor: torch.Tensor, perm: Sequence[Tuple[int, int]],
             axis: str = HVD_AXIS) -> torch.Tensor:
    """Point-to-point permutation along ``axis``: for each ``(src, dst)``
    pair (indices along the axis) member dst receives member src's
    tensor; a member no pair sends to receives zeros (``lax.ppermute``).
    Every pair of this rank goes in one ``batch_isend_irecv``; a self pair
    is a local copy."""
    g = get_context().axis_group(axis)
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not (0 <= v < g.size) for v in srcs + dsts):
        raise ValueError(f"ppermute needs a partial permutation of "
                         f"range({g.size}); got {perm}")
    out = torch.zeros_like(tensor)
    ops = []
    src_b, out_b = _bytes(tensor), out.view(-1).view(torch.uint8)
    for s, d in perm:
        if s == d == g.index:
            out.copy_(tensor)
        elif s == g.index:
            ops.append(dist.P2POp(dist.isend, src_b, g.members[d], g.pg))
        elif d == g.index:
            ops.append(dist.P2POp(dist.irecv, out_b, g.members[s], g.pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            wait_work(work)
    return out


def broadcast_start(tensor: torch.Tensor, root_rank: int = 0,
                    axis: AxisSpec = HVD_AXIS, process_set=None) -> _Pending:
    """Start :func:`broadcast_` on ``tensor``."""
    g = _set_group(axis, process_set)
    members = (process_set.size()
               if process_set is not None and process_set.process_set_id
               else _frame(axis, None).size)
    if not 0 <= root_rank < members:
        raise ValueError(f"root_rank {root_rank} outside a group of "
                         f"{members}")
    work = (dist.broadcast(tensor, src=g.members[root_rank], group=g.pg,
                           async_op=True) if g.pg is not None else None)
    return _Pending([work], lambda: tensor)


def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               axis: AxisSpec = HVD_AXIS, process_set=None) -> torch.Tensor:
    """In place: every member's ``tensor`` becomes the root's (``root_rank``
    indexes the axis, or the set); other ranks keep theirs. Returns it."""
    return broadcast_start(tensor, root_rank, axis, process_set).wait()


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              axis: AxisSpec = HVD_AXIS, process_set=None) -> torch.Tensor:
    """The root's ``tensor`` on every member, as a new tensor."""
    return broadcast_(tensor.clone(), root_rank, axis, process_set)


def barrier(process_set=None) -> None:
    """Returns once every rank (or every member of ``process_set``) has
    called it."""
    g = _set_group(HVD_AXIS, process_set)
    if g.pg is not None:
        dist.barrier(group=g.pg)


# ---------------------------------------------------------------------------
# topology-aware composites
# ---------------------------------------------------------------------------

def hierarchical_allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                           local_axis: str = LOCAL_AXIS,
                           cross_axis: str = CROSS_AXIS,
                           dcn_axis: Optional[str] = None) -> torch.Tensor:
    """Reduce-scatter over ``local_axis``, allreduce of the shard over
    ``cross_axis`` (and ``dcn_axis``), all-gather over ``local_axis``: the
    reference's NCCLHierarchicalAllreduce and the fork's
    NCCLTorusAllreduce, on the groups of those axes. SUM/AVERAGE only; dim
    0 must divide by the local size."""
    op = check_supported(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("hierarchical/torus allreduce supports SUM/AVERAGE")
    ctx = get_context()
    gl = ctx.axis_group(local_axis)
    gc = ctx.axis_group((cross_axis, dcn_axis) if dcn_axis
                        else (cross_axis,))
    if tensor.dim() == 0 or tensor.shape[0] % gl.size:
        raise ValueError(
            f"hierarchical_allreduce needs dim 0 divisible by the local "
            f"size {gl.size}; got shape {tuple(tensor.shape)}")
    shard = _reduce_scatter(tensor, ReduceOp.SUM, gl)
    if gc.pg is not None:
        dist.all_reduce(shard, op=dist.ReduceOp.SUM, group=gc.pg)
    out = _all_gather(shard, gl)
    if op == ReduceOp.AVERAGE:
        out = out / (gl.size * gc.size)
    return out


# Fork-specific name (HOROVOD_TORUS_ALLREDUCE).
torus_allreduce = hierarchical_allreduce


def two_level_allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                        ici_axes: AxisSpec = (CROSS_AXIS, LOCAL_AXIS),
                        dcn_axis: str = DCN_AXIS, wire_codec=None,
                        prescale_factor: Optional[float] = None,
                        postscale_factor: Optional[float] = None,
                        scope: str = "hvd_tier") -> torch.Tensor:
    """The DCN-aware two-level allreduce over dim 0:

    1. reduce-scatter over the fast ``ici_axes`` (each rank owns 1/n_ici
       of the payload, reduced within its slice);
    2. allreduce of the owned shard over ``dcn_axis``; ``wire_codec``
       (``compression.WireCodec``) narrows exactly this stage, its amax
       MAX-reduced over ``dcn_axis`` only;
    3. all-gather over ``ici_axes``.

    SUM/AVERAGE/MIN/MAX; dim 0 is padded with the op's identity to a
    multiple of n_ici and trimmed after the gather. AVERAGE folds 1/world
    into stage 2. MIN/MAX take stage 1 as a reduce and the rank's own
    slice, and ignore the codec. ``scope`` names the three stages
    (``<scope>_rs``, ``<scope>_xdcn``, ``<scope>_ag``) in profiler
    traces."""
    op = check_supported(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.MIN,
                  ReduceOp.MAX):
        raise ValueError(
            f"two_level_allreduce supports SUM/AVERAGE/MIN/MAX, got {op}")
    ici = tuple(a for a in ((ici_axes,) if isinstance(ici_axes, str)
                            else ici_axes) if a)
    if not ici:
        raise ValueError("two_level_allreduce needs >= 1 ICI axis")
    if tensor.dim() == 0:
        raise ValueError("two_level_allreduce needs at least one dimension")
    ctx = get_context()
    gi, gd = ctx.axis_group(ici), ctx.axis_group(dcn_axis)
    n_ici, world = gi.size, gi.size * gd.size
    x = _scale_(tensor.clone(), prescale_factor)
    orig = x.shape[0]
    pad = (-orig) % n_ici
    if pad:
        fill = x.new_full((pad,) + x.shape[1:], _join_neutral(op, x.dtype))
        x = torch.cat([x, fill])
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE):
        with record_function(f"{scope}_rs"):
            shard = _reduce_scatter(x, ReduceOp.SUM, gi)
        with record_function(f"{scope}_xdcn"):
            if wire_codec is not None and wire_codec.compresses(x.dtype):
                wire, scale = wire_codec.encode(shard, axes=(dcn_axis,),
                                                world=gd.size)
                work, red = wire_sum_async(wire, axis=dcn_axis)
                work.wait()
                post = (1.0 / world) if op == ReduceOp.AVERAGE else None
                shard = wire_codec.decode(red, scale, x.dtype,
                                          postscale=post)
            else:
                if gd.pg is not None:
                    dist.all_reduce(shard, op=dist.ReduceOp.SUM,
                                    group=gd.pg)
                if op == ReduceOp.AVERAGE:
                    shard = shard / world
    else:
        with record_function(f"{scope}_rs"):
            full = x.clone()
            if gi.pg is not None:
                dist.all_reduce(full, op=_TORCH_OP[op], group=gi.pg)
            chunk = x.shape[0] // n_ici
            shard = full[gi.index * chunk:(gi.index + 1) * chunk].clone()
        with record_function(f"{scope}_xdcn"):
            if gd.pg is not None:
                dist.all_reduce(shard, op=_TORCH_OP[op], group=gd.pg)
    with record_function(f"{scope}_ag"):
        out = _all_gather(shard, gi)
    if pad:
        out = out[:orig]
    return _scale_(out, postscale_factor)


# ---------------------------------------------------------------------------
# named axes inside a step (the JAX package's shard_map-bound axis names)
# ---------------------------------------------------------------------------

_bound_axes: contextvars.ContextVar[Tuple[str, ...]] = contextvars.ContextVar(
    "horovod_tpu_torch_bound_axes", default=())


@contextlib.contextmanager
def bind_axis(name: str):
    """Within the block, :func:`psum` over ``name`` sums over every rank
    of the world (what ``shard_map`` binding the data-parallel axis does
    in the JAX package)."""
    token = _bound_axes.set(_bound_axes.get() + (name,))
    try:
        yield
    finally:
        _bound_axes.reset(token)


class _AllreduceSum(torch.autograd.Function):
    """Differentiable sum over the ranks: the backward is the sum of the
    cotangents over the ranks (the transpose of ``psum``)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of the bound axis
    ``axis_name``; raises when the axis is not bound (as ``lax.psum``
    does outside ``shard_map``)."""
    if axis_name not in _bound_axes.get():
        raise NameError(f"unbound axis name: {axis_name!r} (bind it with "
                        f"collectives.bind_axis, or "
                        f"data_parallel_train_step(bind_axis=True))")
    if get_context().size == 1:
        return x
    return _AllreduceSum.apply(x)
