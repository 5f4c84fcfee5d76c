"""Blockwise fused cross-entropy over a chunked vocabulary.

The counterpart of ``horovod_tpu/ops/blockwise_ce.py``. The unfused loss
materializes the ``[N, V]`` logits (f32: 2.1 GB at N = 8 x 2048 tokens,
V = 32768), reads them back through the softmax reductions and keeps them
for the backward. This computes the same loss one vocab chunk at a time:
the forward carries the online (max, sum-exp, target-logit) triple per
token, and the backward recomputes each chunk's logits from the saved
hidden states and the saved max, so no ``[N, V]`` tensor exists in either
pass.

The chunk products accumulate in f32, as the JAX package's
``preferred_element_type=f32`` does: the logits as a bf16 GEMM with an
f32 result on the card, a product of widened inputs elsewhere; the
backward's products in f32, which a train step's matmul precision
(``precision.py``) runs in TF32, or with bf16 inputs, on the card. They
are plain PyTorch matmuls: the JAX package computes them outside any
Pallas kernel too. The last chunk is
narrower when the block does not divide the vocabulary; the JAX package
pads it with columns masked to -inf, which contribute nothing either way.

With ``tp_axis`` each rank streams its own vocab shard; the per-token
(max, sum-exp, target) triples combine over tp with one pmax and two
psums, and the backward recomputes each chunk's logits against the
rank's own max (the global shift enters through the psum's cotangents).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

from horovod_tpu_torch import precision
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.ops import collectives


def default_block() -> int:
    """Vocab chunk width from HOROVOD_CE_BLOCK_VOCAB (0 disables fusion:
    callers take their unfused reference path)."""
    return int(knobs.get("HOROVOD_CE_BLOCK_VOCAB"))


def _head_chunks(head: torch.Tensor, block: int
                 ) -> Tuple[List[torch.Tensor], int]:
    """[D, V] -> (column views [D, <= block] in vocab order, n_chunks)."""
    v = head.shape[1]
    cols = [head[:, c0:c0 + block] for c0 in range(0, v, block)]
    return cols, len(cols)


def _chunk_logits(x: torch.Tensor, x32: torch.Tensor,
                  head_c: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """One chunk's f32 logits ``[N, width]`` (x32: the hidden states
    widened to f32). bf16 on the card takes the tensor cores with an f32
    result (``preferred_element_type=f32`` in the JAX package); elsewhere
    the widened product. Both sum exact bf16 products in f32. ``bf16``:
    f32 inputs are rounded to bf16 first (the 'bfloat16' precision)."""
    if x.is_cuda and x.dtype == head_c.dtype == torch.bfloat16:
        return torch.mm(x, head_c, out_dtype=torch.float32)
    if bf16:
        return _bf16_mm(x, head_c)
    return torch.matmul(x32, head_c.float())


def _bf16_inputs(t: torch.Tensor) -> bool:
    """Whether an f32 product on ``t``'s device takes bf16 inputs: on the
    card inside a step run under the 'bfloat16' matmul precision. Read in
    the forward, on the step's thread: the backward runs on autograd's
    device thread, which the step's (per-thread) mode does not reach."""
    return t.is_cuda and precision.current() == "bf16"


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of the inputs rounded to bf16, accumulated and returned
    in f32."""
    return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                    out_dtype=torch.float32)


class _LseParts(torch.autograd.Function):
    """Streaming (max, sumexp, target-logit) triple over the vocabulary.

    x [N, D]; head [D, V]; labels [N] int. Returns per-token f32
    (m, sumexp, target) with ``logsumexp = log(sumexp) + m``; labels
    outside ``[0, V)`` contribute 0 to ``target``. ``m`` is the
    numerics-only max shift and is not differentiable (its contributions
    cancel in ``lse - target``)."""

    @staticmethod
    def forward(ctx, x, head, labels, block: int):
        n = x.shape[0]
        chunks, _ = _head_chunks(head, block)
        m = torch.full((n,), float("-inf"), dtype=torch.float32,
                       device=x.device)
        se = torch.zeros((n,), dtype=torch.float32, device=x.device)
        tgt = torch.zeros((n,), dtype=torch.float32, device=x.device)
        rows = torch.arange(n, device=x.device)
        x32 = x.float()
        bf16 = _bf16_inputs(x32)
        col0 = 0
        for head_c in chunks:
            logits = _chunk_logits(x, x32, head_c, bf16)
            width = head_c.shape[1]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            se = se * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            idx = labels - col0
            in_chunk = (idx >= 0) & (idx < width)
            t = logits[rows, idx.clamp(0, width - 1)]
            tgt = tgt + torch.where(in_chunk, t, torch.zeros_like(t))
            m = m_new
            col0 += width
        ctx.save_for_backward(x, head, labels, m)
        ctx.block = block
        ctx.bf16 = bf16
        ctx.mark_non_differentiable(m)
        return m, se, tgt

    @staticmethod
    def backward(ctx, dm, dse, dtgt):
        # the label lets a profile sum this backward's device time
        with record_function("blockwise_ce.backward"):
            return _LseParts._backward(ctx, dm, dse, dtgt)

    @staticmethod
    def _backward(ctx, dm, dse, dtgt):
        del dm                        # the max shift is numerics-only
        x, head, labels, m = ctx.saved_tensors
        n = x.shape[0]
        if dse is None:
            dse = torch.zeros_like(m)
        if dtgt is None:
            dtgt = torch.zeros_like(m)
        chunks, _ = _head_chunks(head, ctx.block)
        x32 = x.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dheads = []
        rows = torch.arange(n, device=x.device)
        bf16 = ctx.bf16
        col0 = 0
        for head_c in chunks:
            # Recompute this chunk's logits instead of keeping them: one
            # [N, block] working set, no [N, V] residual.
            logits = _chunk_logits(x, x32, head_c, bf16)
            width = head_c.shape[1]
            dlogits = dse[:, None] * torch.exp(logits - m[:, None])
            idx = labels - col0
            in_chunk = (idx >= 0) & (idx < width)
            dlogits.index_put_(
                (rows, idx.clamp(0, width - 1)),
                torch.where(in_chunk, dtgt, torch.zeros_like(dtgt)),
                accumulate=True)
            if bf16:
                dheads.append(_bf16_mm(x.t(), dlogits))
                dx.add_(_bf16_mm(dlogits, head_c.t()))
            else:
                dheads.append(x32.t() @ dlogits)
                dx.addmm_(dlogits, head_c.float().t())
            col0 += width
        dhead = torch.cat(dheads, dim=1)
        return dx.to(x.dtype), dhead.to(head.dtype), None, None


def blockwise_cross_entropy(x: torch.Tensor, head_local: torch.Tensor,
                            labels: torch.Tensor,
                            tp_axis: Optional[str] = None,
                            block: Optional[int] = None) -> torch.Tensor:
    """Per-token CE loss, streaming the LM head in vocab chunks.

    x ``[.., D]`` hidden states; head_local ``[D, V_local]`` (the full
    head when ``tp_axis`` is None, this rank's vocab shard otherwise);
    labels ``[..]`` GLOBAL int ids. Returns per-token f32 losses of
    labels' shape, with no ``[.., V]`` intermediate in forward or
    backward. ``block`` defaults to HOROVOD_CE_BLOCK_VOCAB."""
    if block is None:
        block = default_block()
    v_local = head_local.shape[-1]
    block = max(1, min(int(block), v_local))
    shape = labels.shape
    x2 = x.reshape(-1, x.shape[-1])
    l2 = labels.reshape(-1).long()
    if tp_axis:
        l2 = l2 - collectives.axis_index(tp_axis) * v_local
    m, se, tgt = _LseParts.apply(x2, head_local, l2, block)
    if tp_axis:
        # the shift cancels in lse - target: off the AD path, as pmax is
        m_g = collectives.pmax(m, tp_axis)
        se = collectives.psum(se * torch.exp(m - m_g), tp_axis)
        tgt = collectives.psum(tgt, tp_axis)
        m = m_g
    loss = torch.log(se) + m - tgt
    return loss.reshape(shape)
