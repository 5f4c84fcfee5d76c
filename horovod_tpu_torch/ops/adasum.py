"""Adasum: the scale-invariant combination of the ranks' tensors.

The counterpart of ``horovod_tpu/ops/adasum.py`` (the reference's
``Adasum<Communicator>`` VHDD, common/ops/adasum/adasum.h:38,194). Two
vectors combine as

    a' = (1 - a.b / 2|a|^2) a + (1 - a.b / 2|b|^2) b

(orthogonal vectors add, parallel ones average), recursively over the XOR
partners at distances 1, 2, 4, ... of an axis: the hypercube butterfly.
Each level exchanges the whole working vector with the partner
(``collectives.ppermute``) and both partners compute the same
combination, so after log2(n) levels every rank holds the same result.
The axis must have a power-of-two size.

**Bitwise agreement.** Each rank applies the result it computed itself,
so the two partners of a level must compute the same bits: both evaluate
one expression with the lower rank's vector first.

**Per tensor.** The dot products span one tensor, never a packed buffer:
:func:`adasum_allreduce_many` exchanges all the tensors of one dtype in
one transfer per level (one ``batch_isend_irecv``) and combines them one
by one, with the numbers of one call per tensor.

**Hierarchical form** (``axis=(cross, local)``; the reference's
AdasumGpuAllreduceOp, adasum_gpu_operations.cc:44-66): the mean over the
local axis (any size), then the butterfly over the cross axis, which alone
must be a power of two. With ``joined_ranks`` (ranks linearized row-major
over (cross, local), whose contribution the caller already replaced by
zeros) each local group divides by its ACTIVE count, so a joined rank does
not dilute its group's mean; on the flat butterfly zero is Adasum's
identity (the zero-norm guard) and the list changes nothing. A world or
axis of one rank has no level and sends nothing.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from horovod_tpu_torch.runtime.context import get_context
from horovod_tpu_torch.runtime.topology import HVD_AXIS, AxisSpec


def _pairwise_adasum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a' = (1 - a.b / 2|a|^2) a + (1 - a.b / 2|b|^2) b, the products in
    f32 (or the wider dtype), a zero norm leaving its coefficient at 1
    (ref adasum.h:420-436)."""
    ct = torch.promote_types(a.dtype, torch.float32)
    af, bf = a.reshape(-1).to(ct), b.reshape(-1).to(ct)
    dot, na, nb = torch.dot(af, bf), torch.dot(af, af), torch.dot(bf, bf)
    one = torch.ones((), dtype=ct, device=a.device)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * torch.where(na > 0, na, one)),
                     one)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * torch.where(nb > 0, nb, one)),
                     one)
    return (ca.to(a.dtype) * a + cb.to(b.dtype) * b).to(a.dtype)


def _combine(x: torch.Tensor, partner: torch.Tensor, lower: bool
             ) -> torch.Tensor:
    """One level on one rank: the same expression on both partners, the
    lower rank's vector first, so both get the same bits."""
    return (_pairwise_adasum(x, partner) if lower
            else _pairwise_adasum(partner, x))


def _by_dtype(xs: Sequence[torch.Tensor]) -> List[List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    return list(groups.values())


def _packed(xs: Sequence[torch.Tensor], fn) -> List[torch.Tensor]:
    """``fn`` on one flat buffer per dtype of ``xs``; the results as
    views with the inputs' shapes."""
    from horovod_tpu_torch.ops.fusion import (flatten_for_fusion,
                                              unflatten_from_fusion)
    out: List[torch.Tensor] = [None] * len(xs)  # type: ignore[list-item]
    for idxs in _by_dtype(xs):
        buf, specs = flatten_for_fusion([xs[i] for i in idxs])
        for i, v in zip(idxs, unflatten_from_fusion(fn(buf), specs)):
            out[i] = v
    return out


def _butterfly(xs: List[torch.Tensor], axis: AxisSpec) -> List[torch.Tensor]:
    """The XOR butterfly of every tensor of ``xs`` over ``axis``."""
    from horovod_tpu_torch.ops.collectives import ppermute
    g = get_context().axis_group(axis)
    n = g.size
    if n & (n - 1):
        raise ValueError(
            f"Adasum requires a power-of-2 axis, got {n} ranks along "
            f"{axis!r} (hierarchical meshes lift it: pass (cross, local))")
    d = 1
    while d < n:
        peer = g.index ^ d
        perm = [(r, r ^ d) for r in range(n)]
        partners = _packed(xs, lambda buf: ppermute(buf, perm, axis))
        xs = [_combine(x, p, g.index < peer) for x, p in zip(xs, partners)]
        d *= 2
    return xs


def _local_mean(xs: List[torch.Tensor], cross_axis: str, local_axis: str,
                joined_ranks: Tuple[int, ...]) -> List[torch.Tensor]:
    """The mean over ``local_axis`` of every tensor, divided by this local
    group's active count when ranks are joined."""
    import torch.distributed as dist
    ctx = get_context()
    gl = ctx.axis_group(local_axis)
    nl, denom = gl.size, gl.size
    if joined_ranks:
        mine = ctx.axis_group(cross_axis).index
        denom = max(nl - sum(1 for r in joined_ranks
                             if int(r) // nl == mine), 1)

    def mean(buf):
        buf = buf.clone()
        if gl.pg is not None:
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=gl.pg)
        return buf.div_(denom)

    return _packed(xs, mean)


def adasum_allreduce_many(xs: Sequence[torch.Tensor],
                          axis: AxisSpec = HVD_AXIS, process_set=None,
                          joined_ranks: Sequence[int] = ()
                          ) -> List[torch.Tensor]:
    """Adasum of each tensor of ``xs`` over ``axis`` (one name, or a
    ``(cross, local)`` pair for the hierarchical form); new tensors, the
    inputs are left as they were."""
    if process_set is not None and process_set.process_set_id != 0:
        raise NotImplementedError(
            "Adasum over non-global process sets is not supported "
            "(the reference's MPI Adasum also requires the global comm)")
    xs = list(xs)
    if isinstance(axis, (tuple, list)) and len(axis) == 1:
        axis = axis[0]
    if isinstance(axis, (tuple, list)):
        if len(axis) != 2:
            raise ValueError("adasum_allreduce takes one mesh axis or a "
                             "(cross, local) pair")
        cross_axis, local_axis = axis
        nc = get_context().axis_group(cross_axis).size
        if nc & (nc - 1):
            raise ValueError(
                f"hierarchical Adasum requires a power-of-2 CROSS axis, "
                f"got {nc} (ref adasum_gpu_operations.cc:44-66)")
        return _butterfly(_local_mean(xs, cross_axis, local_axis,
                                      tuple(joined_ranks)), cross_axis)
    return _butterfly([x.clone() for x in xs], axis)


def adasum_allreduce(x: torch.Tensor, axis: AxisSpec = HVD_AXIS,
                     process_set=None, joined_ranks: Sequence[int] = ()
                     ) -> torch.Tensor:
    """Adasum of this rank's ``x`` over ``axis``
    (:func:`adasum_allreduce_many` of one tensor)."""
    return adasum_allreduce_many([x], axis, process_set, joined_ranks)[0]
