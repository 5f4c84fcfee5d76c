"""Megatron-style projection helpers of the port, for ``tp_axis=None``.

The counterparts of ``horovod_tpu/parallel/tensor_parallel.py``. Without
a tensor-parallel axis they are a plain matmul and an embedding lookup;
tensor-parallel serving comes in a later slice, so a set axis raises.
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
