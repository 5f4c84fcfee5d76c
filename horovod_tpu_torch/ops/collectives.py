"""Eager collectives of the port over the default ``torch.distributed``
process group (NCCL on the card, gloo on the CPU).

Per-rank semantics, as in the reference Horovod's PyTorch API: every rank
calls the function with ITS OWN tensor and gets the result back. The JAX
package's eager API is single-controller instead: it takes one
rank-stacked array ``x`` of shape ``(size, ...)`` and returns the reduced
array of shape ``x.shape[1:]``. The two correspond row for row: rank
``r`` here passes ``x[r]``, and every rank receives what the JAX call
returns (for ``broadcast``, ``x[root_rank]``).

``allreduce`` supports Sum, Average, Min, Max and Product with
``prescale_factor``/``postscale_factor`` (applied in the tensor's dtype,
as in the JAX package). ``allreduce_`` and ``broadcast_`` work in place.
``psum`` is the differentiable sum over the ranks that a model calls
inside a step whose axis is bound (``bind_axis``): sync batch norm.
Not ported yet: allgather, alltoall, reducescatter, the hierarchical and
two-level allreduce, Adasum, process sets and the async handle API
(ROADMAP A.3).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.reduce_ops import ReduceOp, check_supported
from horovod_tpu_torch.runtime.context import get_context

_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.AVERAGE: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _scale_(x: torch.Tensor, factor: Optional[float]) -> torch.Tensor:
    """x *= factor in place, in x's dtype (integers through f32/f64, as
    the JAX ``_apply_scale`` does)."""
    if factor is None or factor == 1.0:
        return x
    if x.is_floating_point():
        return x.mul_(factor)
    wide = torch.float64 if x.dtype == torch.int64 else torch.float32
    return x.copy_((x.to(wide) * factor).to(x.dtype))


def allreduce_(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
               prescale_factor: Optional[float] = None,
               postscale_factor: Optional[float] = None) -> torch.Tensor:
    """In-place allreduce of this rank's ``tensor``; returns it. Average
    divides the sum by ``size()`` (floating-point tensors only)."""
    op = check_supported(op)
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not yet ported to horovod_tpu_torch (slice 3)")
    if op == ReduceOp.AVERAGE and not tensor.is_floating_point():
        raise TypeError("allreduce_: Average of an integer tensor cannot "
                        "stay in place; use allreduce")
    world = get_context().size
    _scale_(tensor, prescale_factor)
    dist.all_reduce(tensor, op=_TORCH_OP[op])
    if op == ReduceOp.AVERAGE:
        tensor.div_(world)
    return _scale_(tensor, postscale_factor)


def allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None) -> torch.Tensor:
    """Allreduce of this rank's ``tensor`` into a new tensor (the input is
    left as it was). Average of an integer tensor returns a floating-point
    result, as the JAX package's does."""
    op = check_supported(op)
    if op == ReduceOp.AVERAGE and not tensor.is_floating_point():
        summed = allreduce_(tensor.clone(), ReduceOp.SUM, prescale_factor)
        out = summed / get_context().size
        return _scale_(out, postscale_factor)
    return allreduce_(tensor.clone(), op, prescale_factor, postscale_factor)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE,
                      prescale_factor: Optional[float] = None,
                      postscale_factor: Optional[float] = None
                      ) -> List[torch.Tensor]:
    """All tensors reduced as one logical op: packed into one buffer per
    dtype, one collective per buffer, unpacked (``ops.fusion.fuse_apply``,
    honouring HOROVOD_BATCH_D2D_MEMCOPIES). Inputs are left as they were."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops.fusion import fuse_apply
    fn = functools.partial(allreduce, op=op, prescale_factor=prescale_factor,
                           postscale_factor=postscale_factor)
    return fuse_apply(fn, tensors,
                      batch=bool(knobs.get("HOROVOD_BATCH_D2D_MEMCOPIES")))


def broadcast_(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """In place: every rank's ``tensor`` becomes root's; returns it."""
    get_context()
    dist.broadcast(tensor, src=root_rank)
    return tensor


def broadcast(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Root's ``tensor`` on every rank, as a new tensor."""
    return broadcast_(tensor.clone(), root_rank)


def barrier() -> None:
    """Returns once every rank has called it."""
    get_context()
    dist.barrier()


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


def axis_size(axis_name: str) -> int:
    """Ranks over which :func:`psum` over ``axis_name`` sums."""
    if axis_name not in _bound_axes.get():
        raise NameError(f"unbound axis name: {axis_name!r}")
    return get_context().size
