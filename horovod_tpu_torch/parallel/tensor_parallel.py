"""Megatron-style projection helpers of the port, for ``tp_axis=None``.

The counterparts of ``horovod_tpu/parallel/tensor_parallel.py``. Without
a tensor-parallel axis they are a plain matmul, an embedding lookup and
the (blockwise) cross-entropy; tensor parallelism comes in a later slice,
so a set axis raises.
"""

from __future__ import annotations

from typing import Optional

import torch


def _no_tp(tp_axis: Optional[str]) -> None:
    if tp_axis:
        raise NotImplementedError(
            f"tp_axis={tp_axis!r}: tensor parallelism is not yet ported "
            f"to horovod_tpu_torch")


def column_parallel(x: torch.Tensor, w_local: torch.Tensor) -> torch.Tensor:
    """y = x @ W (input replicated, output feature-sharded under TP)."""
    return x @ w_local


def row_parallel(x_local: torch.Tensor, w_local: torch.Tensor,
                 tp_axis: Optional[str]) -> torch.Tensor:
    """y = x @ W; under TP this would be followed by a sum over tp."""
    _no_tp(tp_axis)
    return x_local @ w_local


def vocab_parallel_embed(token_ids: torch.Tensor, embed_local: torch.Tensor,
                         tp_axis: Optional[str]) -> torch.Tensor:
    """Embedding lookup; ids outside ``[0, V)`` give zero rows, as in the
    JAX function."""
    _no_tp(tp_axis)
    v_local = embed_local.shape[0]
    ids = token_ids.long()
    out = embed_local[ids.clamp(0, v_local - 1)]
    mask = ((ids >= 0) & (ids < v_local)).unsqueeze(-1)
    return torch.where(mask, out, torch.zeros_like(out))


def vocab_parallel_cross_entropy(x: torch.Tensor, head_local: torch.Tensor,
                                 labels: torch.Tensor,
                                 tp_axis: Optional[str],
                                 block: Optional[int] = None
                                 ) -> torch.Tensor:
    """Per-token CE loss ``[..]`` (f32) of hidden states ``x [.., D]``
    through the LM head ``[D, V]``.

    ``block > 0`` (default HOROVOD_CE_BLOCK_VOCAB) streams the head in
    vocab chunks (``ops.blockwise_ce``), so no ``[.., V]`` logits exist;
    ``block=0`` keeps the unfused reference path, which materializes them
    and is the numerics reference the blockwise tests compare against."""
    _no_tp(tp_axis)
    from horovod_tpu_torch.ops.blockwise_ce import (blockwise_cross_entropy,
                                                    default_block)
    if block is None:
        block = default_block()
    if block and block > 0:
        return blockwise_cross_entropy(x, head_local, labels, block=block)
    logits = (x @ head_local).float()                    # [.., V]
    v_local = head_local.shape[-1]
    # The max shift is numerics-only (it cancels in lse - target).
    m = logits.detach().amax(dim=-1)
    lse = torch.log(torch.exp(logits - m[..., None]).sum(dim=-1)) + m
    ids = labels.long()
    target = torch.gather(logits, -1, ids.clamp(0, v_local - 1)[..., None]
                          )[..., 0]
    in_range = (ids >= 0) & (ids < v_local)
    return lse - torch.where(in_range, target, torch.zeros_like(target))
