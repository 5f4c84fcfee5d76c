"""Attention over a sequence: the single-shard path of the port.

The counterpart of ``horovod_tpu/parallel/sequence.py`` for ``sp_axis=None``.
``local_attention`` is what the flagship's layers call; it runs
``ops.flash_attention.flash_attention`` on every device (the CUDA kernels
on the card, their plain versions below on the CPU).

``_block_attend`` and ``_bwd_block_plain`` are the plain PyTorch versions
of the flash forward kernel and of the backward pair, with the JAX
package's contract (unnormalized output and row stats; gradients against
global stats, with global offsets for the causal mask). They are what the
CPU runs and what the kernels are held against on the card.

Ring and Ulysses attention (``sp_axis`` set) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _causal_mask(s_q: int, s_k: int, q_offset: int, k_offset: int,
                 device) -> torch.Tensor:
    """``[Sq, Sk]`` bool: query at global ``q_offset + i`` sees the key at
    ``k_offset + j`` iff ``q_offset + i >= k_offset + j``."""
    rows = q_offset + torch.arange(s_q, device=device)[:, None]
    cols = k_offset + torch.arange(s_k, device=device)[None, :]
    return rows >= cols


def _block_attend(q, k, v, q_offset, k_offset, causal, scale):
    """One Q-block x K-block partial attention.

    q ``[B, Sq, H, D]``, k/v ``[B, Sk, H, D]`` -> (o ``[B, Sq, H, D]``
    unnormalized, m ``[B, H, Sq]`` row max, l ``[B, H, Sq]`` row sum of
    ``exp(s - m)``). A row that sees no key gives m = NEG_INF, l = 0 and
    o = 0."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, k_offset,
                            q.device)
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    # Fully masked rows: exp(NEG_INF - NEG_INF) = 1 would attend uniformly.
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o, m, l


def _bwd_block_plain(q, k, v, do, lse, dD, q_offset, k_offset, causal,
                     scale):
    """Gradients of one K/V block against the global stats ``lse`` and
    ``dD`` ``[B, H, Sq]`` (``_bwd_block_jnp`` of the JAX package), in f32:
    (dq ``[B, Sq, H, D]``, dk, dv ``[B, Sk, H, D]``)."""
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, k_offset,
                            q.device)
        p = torch.where(mask[None, None], p, torch.zeros_like(p))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = p * (dp - dD[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    return dq, dk, dv


def local_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Full attention on one shard, q/k/v ``[B, S, H, D]`` -> ``[B, S, H,
    D]`` in q's dtype, through the differentiable flash attention: the
    CUDA kernels for CUDA tensors, their plain versions for CPU tensors."""
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    return flash_attention(q, k, v, causal, scale).to(q.dtype)


def ring_attention(q, k, v, axis_name, causal=True, scale=None):
    raise NotImplementedError(
        "ring_attention (sp_axis set) is not yet ported to "
        "horovod_tpu_torch; it comes with slice 4, over the ported "
        "flash_block_attend/flash_bwd_block offsets")


def ulysses_attention(q, k, v, axis_name, causal=True, scale=None):
    raise NotImplementedError(
        "ulysses_attention (sp_axis set) is not yet ported to "
        "horovod_tpu_torch; it comes with slice 4")
