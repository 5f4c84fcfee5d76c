"""Sequence (context) parallelism: ring attention and Ulysses.

The counterpart of ``horovod_tpu/parallel/sequence.py``.
``local_attention`` is the single-shard path the flagship's layers call
without ``sp_axis``; it runs ``ops.flash_attention.flash_attention`` (the
CUDA kernels on the card, their plain versions below on the CPU).

- ``ring_attention``: Q stays put; K/V blocks rotate around the bound
  ``sp`` axis (``collectives.ppermute_start``, one point-to-point
  exchange per step), with the streaming-softmax merge, so the S x S
  score matrix never exists. The exchange of step t+1 starts before step
  t's kernels and is waited on after them. It is one
  ``torch.autograd.Function`` over the whole ring: the backward is a
  second ring in which dK/dV accumulate on the rotating blocks, so each
  block comes home summed over every rank. Each step runs
  :func:`ring_fwd_step` / :func:`ring_bwd_step`: on CUDA tensors the flash
  kernels at global offsets (``flash_block_attend``, ``flash_bwd_block``),
  on CPU tensors their plain versions. The scale is a Python float: the
  JAX package's traced-scale form (``_ring_attention_plain``) has no
  counterpart.
- ``ulysses_attention``: a differentiable all-to-all from ``[B, S/n, H,
  D]`` to ``[B, S, H/n, D]``, full-sequence attention on the local heads,
  and the inverse all-to-all.

``_block_attend`` and ``_bwd_block_plain`` are the plain PyTorch versions
of the flash forward kernel and of the backward pair, with the JAX
package's contract (unnormalized output and row stats; gradients against
global stats, with global offsets for the causal mask). They are what the
CPU runs and what the kernels are held against on the card.
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


def ring_fwd_step(q, kt, vt, q_offset: int, k_offset: int, causal: bool,
                  scale: float, acc, m, l):
    """One forward ring step: Q against the held K/V block at global
    offsets, merged into the running state. acc ``[B, Sq, H, D]`` f32
    (unnormalized), m and l ``[B, Sq, H]`` f32 (row max and row sum).
    Returns the new (acc, m, l). CUDA tensors take the flash forward
    kernel, CPU tensors ``_block_attend``."""
    if q.is_cuda:
        from horovod_tpu_torch.ops import flash_attention as fa
        o_blk, m_blk, l_blk = fa.flash_block_attend(
            q, kt, vt, q_offset, k_offset, causal, scale)
    else:
        o_blk, m_blk, l_blk = _block_attend(
            q.float(), kt.float(), vt.float(), q_offset, k_offset, causal,
            scale)
    m_blk = m_blk.transpose(1, 2)                 # [B, H, Sq] -> [B, Sq, H]
    l_blk = l_blk.transpose(1, 2)
    m_new = torch.maximum(m, m_blk)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    # rows still at -inf (or a fully masked block) contribute nothing
    c_old = torch.where(torch.isinf(m) | (m <= NEG_INF / 2), zero,
                        torch.exp(m - m_new))
    c_blk = torch.where(torch.isinf(m_blk) | (m_blk <= NEG_INF / 2), zero,
                        torch.exp(m_blk - m_new))
    acc = acc * c_old[..., None] + o_blk.float() * c_blk[..., None]
    return acc, m_new, l * c_old + l_blk * c_blk


def ring_bwd_step(q, kt, vt, do, lse, dD, q_offset: int, k_offset: int,
                  causal: bool, scale: float, dq, dkv) -> None:
    """One backward ring step: the gradients of Q against the held K/V
    block (global stats lse and dD ``[B, H, Sq]``) added in place to dq
    ``[B, Sq, H, D]`` f32 and to the rotating accumulator dkv ``[2, B,
    Sk, H, D]`` f32 (dK, dV). CUDA tensors take the two flash backward
    kernels, CPU tensors ``_bwd_block_plain``."""
    if q.is_cuda:
        from horovod_tpu_torch.ops import flash_attention as fa
        dq_b, dk_b, dv_b = fa.flash_bwd_block(q, kt, vt, do, lse, dD,
                                              q_offset, k_offset, causal,
                                              scale)
    else:
        dq_b, dk_b, dv_b = _bwd_block_plain(q, kt, vt, do, lse, dD,
                                            q_offset, k_offset, causal,
                                            scale)
    dq.add_(dq_b)
    dkv[0].add_(dk_b)
    dkv[1].add_(dv_b)


# gloo matches a pair's messages by tag: the K/V and the dK/dV exchanges of
# the backward ring are in flight together
_KV_TAG, _DKV_TAG = 0, 1


class _RingAttention(torch.autograd.Function):
    """Ring attention over the mesh axis ``axis`` (resolved from a bound
    name): ``_ring_attention_cvjp`` of the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal: bool, scale: float):
        from horovod_tpu_torch.ops import collectives
        g = collectives.get_context().axis_group(axis)
        n, my, s_local = g.size, g.index, q.shape[1]
        perm = [(i, (i + 1) % n) for i in range(n)]
        kv = torch.stack([k, v])                   # one exchange per step
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        m = torch.full(q.shape[:3], float("-inf"), dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
        for t in range(n):
            nxt = (collectives.ppermute_start(kv, perm, axis, tag=_KV_TAG)
                   if t < n - 1 else None)
            src = (my - t) % n                     # whose block is held
            acc, m, l = ring_fwd_step(q, kv[0], kv[1], my * s_local,
                                      src * s_local, causal, scale, acc, m,
                                      l)
            if nxt is not None:
                kv = nxt.wait()
        l_safe = l.clamp_min(1e-30)
        out = (acc / l_safe[..., None]).to(q.dtype)
        lse = (m + torch.log(l_safe)).transpose(1, 2).contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        from horovod_tpu_torch.ops import collectives
        q, k, v, o, lse = ctx.saved_tensors
        axis, causal, scale = ctx.axis, ctx.causal, ctx.scale
        g = collectives.get_context().axis_group(axis)
        n, my, s_local = g.size, g.index, q.shape[1]
        perm = [(i, (i + 1) % n) for i in range(n)]
        do = dout.to(q.dtype).contiguous()
        dD = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        sent = None
        for t in range(n):
            nxt = (collectives.ppermute_start(kv, perm, axis, tag=_KV_TAG)
                   if t < n - 1 else None)
            src = (my - t) % n
            if sent is not None:
                # the accumulator of the block now held, passed on by the
                # left neighbour during this step's kernels
                dkv = sent.wait()
            ring_bwd_step(q, kv[0], kv[1], do, lse, dD, my * s_local,
                          src * s_local, causal, scale, dq, dkv)
            sent = collectives.ppermute_start(dkv, perm, axis,
                                              tag=_DKV_TAG)
            if nxt is not None:
                kv = nxt.wait()
        dkv = sent.wait()                          # every block is home
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise ring attention over the bound sequence axis
    ``axis_name``: q/k/v ``[B, S_local, H, D]`` are this rank's sequence
    block (rank i of the axis holds tokens ``[i*S_local, (i+1)*S_local)``);
    returns the attention output of the local queries, ``[B, S_local, H,
    D]`` in q's dtype. On CUDA tensors every block runs the flash kernels
    (a geometry their gate refuses raises ``ValueError``); on CPU tensors
    their plain versions."""
    from horovod_tpu_torch.ops import collectives
    axis = collectives.mesh_axis(axis_name)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), axis, bool(causal),
                                float(scale))


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str, causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism over the bound axis
    ``axis_name``: a differentiable all-to-all from sequence-sharded
    ``[B, S/n, H, D]`` to head-sharded ``[B, S, H/n, D]``, full-sequence
    attention on the local heads (:func:`local_attention`), and the
    all-to-all back. The axis size must divide the head count."""
    from horovod_tpu_torch.ops import collectives
    n = collectives.bound_axis_size(axis_name)
    if q.shape[2] % n != 0:
        raise ValueError(f"ulysses: heads {q.shape[2]} not divisible by {n}")

    def reshard_fwd(x):                  # [B, S/n, H, D] -> [B, S, H/n, D]
        return collectives.all_to_all(x, axis_name, split_axis=2,
                                      concat_axis=1).contiguous()

    of = local_attention(reshard_fwd(q), reshard_fwd(k), reshard_fwd(v),
                         causal, scale)
    # [B, S, H/n, D] -> [B, S/n, H, D]
    return collectives.all_to_all(of, axis_name, split_axis=1,
                                  concat_axis=2)


def sequence_shard(x: torch.Tensor, axis_name: str,
                   seq_dim: int = 1) -> torch.Tensor:
    """This rank's sequence block of a replicated ``[.., S, ..]`` tensor
    (a static slice: the input is replicated)."""
    from horovod_tpu_torch.ops import collectives
    n = collectives.bound_axis_size(axis_name)
    i = collectives.axis_index(axis_name)
    s = x.shape[seq_dim]
    if s % n != 0:
        raise ValueError(f"sequence length {s} not divisible by sp={n}")
    blk = s // n
    return x.narrow(seq_dim, i * blk, blk)


def sequence_unshard(x: torch.Tensor, axis_name: str,
                     seq_dim: int = 1) -> torch.Tensor:
    """Inverse of :func:`sequence_shard`: the sequence blocks gathered
    (differentiable, a reduce-scatter in the backward)."""
    from horovod_tpu_torch.ops import collectives
    return collectives.all_gather(x, axis_name, axis=seq_dim, tiled=True)
