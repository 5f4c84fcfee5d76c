"""Tensor (Megatron-style) parallelism over a mesh axis.

The counterparts of ``horovod_tpu/parallel/tensor_parallel.py``:
column- and row-parallel matmuls whose only communication is one
:func:`~horovod_tpu_torch.ops.collectives.psum` per row-parallel
projection, plus the vocab-parallel embedding and cross-entropy, so the
``[V]``-sized dimension never exists unsharded. Weights are this rank's
shard (``models.transformer.shard_params`` slices them as
``param_specs`` says); ``tp_axis`` must be bound
(``collectives.bind_axis``), as it is inside the trainer's step and the
serving engine. With ``tp_axis=None`` they are a plain matmul, an
embedding lookup and the cross-entropy.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.ops import collectives


def column_parallel(x: torch.Tensor, w_local: torch.Tensor) -> torch.Tensor:
    """y_local = x @ W[:, shard]: input replicated, output
    feature-sharded. No communication."""
    return x @ w_local


def row_parallel(x_local: torch.Tensor, w_local: torch.Tensor,
                 tp_axis: Optional[str]) -> torch.Tensor:
    """y = psum_tp(x[:, shard] @ W[shard, :]): input feature-sharded,
    output replicated. One psum, the only TP communication point."""
    y = x_local @ w_local
    if tp_axis:
        y = collectives.psum(y, tp_axis)
    return y


def _shard_lo(tp_axis: Optional[str], v_local: int) -> int:
    return collectives.axis_index(tp_axis) * v_local if tp_axis else 0


def vocab_parallel_embed(token_ids: torch.Tensor, embed_local: torch.Tensor,
                         tp_axis: Optional[str]) -> torch.Tensor:
    """Embedding lookup with the vocab dim sharded over tp: this rank
    holds rows ``[lo, lo + V/tp)`` of the table; ids outside them give
    zero rows and the psum assembles the full embedding (ids outside
    ``[0, V)`` give zeros everywhere, as in the JAX function)."""
    v_local = embed_local.shape[0]
    lo = _shard_lo(tp_axis, v_local)
    ids = token_ids.long()
    out = embed_local[(ids - lo).clamp(0, v_local - 1)]
    mask = ((ids >= lo) & (ids < lo + v_local)).unsqueeze(-1)
    out = torch.where(mask, out, torch.zeros_like(out))
    if tp_axis:
        out = collectives.psum(out, tp_axis)
    return out


def vocab_parallel_cross_entropy(x: torch.Tensor, head_local: torch.Tensor,
                                 labels: torch.Tensor,
                                 tp_axis: Optional[str],
                                 block: Optional[int] = None
                                 ) -> torch.Tensor:
    """Per-token CE loss ``[..]`` (f32) of hidden states ``x [.., D]``
    through the LM head's vocab shard ``[D, V/tp]``.

    ``block > 0`` (default HOROVOD_CE_BLOCK_VOCAB) streams the shard in
    vocab chunks (``ops.blockwise_ce``), so no ``[.., V/tp]`` logits
    exist; ``block=0`` keeps the unfused reference path, which
    materializes them. Across tp: pmax of the max shift, psum of the
    sum-exp, masked psum of the target logit."""
    from horovod_tpu_torch.ops.blockwise_ce import (blockwise_cross_entropy,
                                                    default_block)
    if block is None:
        block = default_block()
    if block and block > 0:
        return blockwise_cross_entropy(x, head_local, labels,
                                       tp_axis=tp_axis, block=block)
    logits = (x @ head_local).float()                    # [.., V_local]
    v_local = head_local.shape[-1]
    # The max shift is numerics-only (it cancels in lse - target).
    m = logits.detach().amax(dim=-1)
    if tp_axis:
        m = collectives.pmax(m, tp_axis)
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    if tp_axis:
        sumexp = collectives.psum(sumexp, tp_axis)
    lse = torch.log(sumexp) + m
    lo = _shard_lo(tp_axis, v_local)
    ids = labels.long() - lo
    target = torch.gather(logits, -1, ids.clamp(0, v_local - 1)[..., None]
                          )[..., 0]
    in_range = (ids >= 0) & (ids < v_local)
    target = torch.where(in_range, target, torch.zeros_like(target))
    if tp_axis:
        target = collectives.psum(target, tp_axis)
    return lse - target
