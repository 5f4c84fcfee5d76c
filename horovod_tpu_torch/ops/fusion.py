"""Tensor fusion: pack many tensors into one flat buffer per dtype, run one
collective, unpack.

The counterpart of ``horovod_tpu/ops/fusion.py`` (the reference's fusion
buffer, fusion_buffer_manager.h): per step, the gradient sync issues one
collective per (sync-axes group, dtype) instead of one per parameter. On
the card the pack is one ``torch.cat`` and the unpack returns views of
the reduced buffer, so no persistent buffer is managed.

Pytrees are the port's nested ``dict``s of tensors, walked in sorted-key
order as ``jax.tree`` walks them (``utils.tree``). Not ported yet
(slice 3): ``plan_fusion_bins`` and the native planner, and the bucket
manifest of the IR verifier.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from horovod_tpu_torch.utils import tree as tree_util


def fuse_apply(fn: Callable[[torch.Tensor], torch.Tensor],
               xs: Sequence[torch.Tensor],
               batch: bool = True) -> List[torch.Tensor]:
    """Apply a collective ``fn`` (buffer -> buffer of the same size) to all
    tensors as one fused buffer per dtype; returns outputs in input order,
    with the inputs' shapes.

    ``batch=False`` (HOROVOD_BATCH_D2D_MEMCOPIES=0) skips the pack: ``fn``
    runs once per tensor, on the tensor itself."""
    xs = list(xs)
    if not xs:
        return []
    if not batch or len(xs) == 1:
        return [fn(x) for x in xs]
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    out: List[torch.Tensor] = [None] * len(xs)  # type: ignore[list-item]
    for idxs in by_dtype.values():
        fused, specs = flatten_for_fusion([xs[i] for i in idxs])
        for i, part in zip(idxs, unflatten_from_fusion(fn(fused), specs)):
            out[i] = part
    return out


def flatten_for_fusion(xs: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[Tuple[Tuple[int, ...],
                                                           int]]]:
    """Pack same-dtype tensors into one flat buffer; returns (buffer,
    specs) where specs[i] = (shape, size). Raises on mixed dtypes."""
    dtypes = {x.dtype for x in xs}
    if len(dtypes) != 1:
        raise ValueError(
            f"flatten_for_fusion needs uniform dtype, got {dtypes}")
    parts = [x.reshape(-1) for x in xs]
    specs = [(tuple(x.shape), x.numel()) for x in xs]
    return (torch.cat(parts) if len(parts) > 1 else parts[0]), specs


def unflatten_from_fusion(buffer: torch.Tensor, specs) -> List[torch.Tensor]:
    """Views of ``buffer`` with the packed tensors' shapes."""
    out = []
    offset = 0
    for shape, size in specs:
        out.append(buffer[offset:offset + size].view(shape))
        offset += size
    return out


def _is_axes(x) -> bool:
    return isinstance(x, tuple) or x is None


def group_leaves_by_axes(tree, sync_axes):
    """Align a (possibly coarse) ``sync_axes`` tree with ``tree``'s leaves
    and group leaf indices by their axes tuple.

    ``sync_axes`` mirrors ``tree`` with tuple-of-axis-names leaves; a tuple
    at an interior position covers the whole subtree. Returns
    ``(treedef, leaves, {axes_tuple: [leaf_index, ...]})`` with falsy axis
    names dropped. A structure mismatch raises here."""
    expanded = tree_util.tree_map(
        lambda a, sub: tree_util.tree_map(lambda _: a, sub),
        sync_axes, tree, is_leaf=_is_axes)
    axes_leaves = tree_util.tree_leaves(expanded, is_leaf=_is_axes)
    leaves, treedef = tree_util.tree_flatten(tree)
    if len(axes_leaves) != len(leaves):
        raise ValueError(
            f"sync_axes resolves to {len(axes_leaves)} leaves but the "
            f"gradient tree has {len(leaves)}")
    groups: Dict[Tuple, List[int]] = {}
    for i, a in enumerate(axes_leaves):
        a = a if isinstance(a, tuple) else (a,)
        groups.setdefault(tuple(x for x in a if x), []).append(i)
    return treedef, leaves, groups


def apply_by_groups(tree, sync_axes, group_fn):
    """Run ``group_fn(leaves, axes) -> synced_leaves`` once per axes group
    of :func:`group_leaves_by_axes` and rebuild the tree."""
    treedef, leaves, groups = group_leaves_by_axes(tree, sync_axes)
    out = [None] * len(leaves)
    for axes, idxs in groups.items():
        for i, s in zip(idxs, group_fn([leaves[i] for i in idxs], axes)):
            out[i] = s
    return tree_util.tree_unflatten(treedef, out)


def fused_group_apply(tree, sync_axes, make_fn):
    """:func:`apply_by_groups` with ``make_fn(axes)`` (a buffer -> buffer
    reduce closure) applied as one :func:`fuse_apply` batch per group,
    honouring HOROVOD_BATCH_D2D_MEMCOPIES."""
    from horovod_tpu_torch.config import knobs
    batch = bool(knobs.get("HOROVOD_BATCH_D2D_MEMCOPIES"))
    return apply_by_groups(
        tree, sync_axes,
        lambda leaves, axes: fuse_apply(make_fn(axes), leaves, batch=batch))
