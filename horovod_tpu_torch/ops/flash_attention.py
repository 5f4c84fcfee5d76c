"""Flash attention and paged decode attention: the wrappers of the CUDA
kernels.

Four kernels, each the Hopper counterpart of a Pallas kernel of
``horovod_tpu/ops/pallas/flash_attention.py``:

- ``flash_block_attend`` launches ``csrc/flash_fwd.cu`` (for ``_kernel``):
  the unnormalized block forward with row stats ``m`` and ``l``;
- ``flash_bwd_block`` launches ``csrc/flash_bwd.cu`` twice, its dq kernel
  and its dk/dv kernel (for ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``);
- ``flash_paged_decode`` launches ``csrc/paged_decode.cu`` (for
  ``_paged_decode_kernel``).

They take CUDA tensors only. The plain PyTorch versions of the same
functions are ``parallel.sequence._block_attend``,
``parallel.sequence._bwd_block_plain`` and
``serving.kv_cache.paged_attention_reference``; the dispatchers
(:func:`flash_attention`, ``kv_cache.paged_decode_attention``) use them for
CPU tensors, and nothing else does. A CUDA tensor the kernel's gate refuses
raises; it never goes to the plain version.

:func:`flash_attention` is the differentiable entry of the training path,
a ``torch.autograd.Function`` whose forward is the flash forward kernel
and whose backward is the two backward kernels, as the JAX package's
``custom_vjp`` is.

``LAUNCHES`` counts launches per kernel, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from horovod_tpu_torch.ops._build import DTYPE_CODE as _DTYPE_CODE
from horovod_tpu_torch.ops._build import check_cuda as _check_cuda
from horovod_tpu_torch.ops._build import launch as _launch

LAUNCHES: Dict[str, int] = {"paged_decode": 0, "flash_fwd": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

# Positions of a sequence one block of the paged-decode kernel takes.
PAGED_CHUNK = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# flash attention (training path)
# ---------------------------------------------------------------------------

def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Shape gate of the Hopper flash kernels: q ``[B, Sq, H, D]`` and k/v
    ``[B, Sk, H, D]`` in one dtype (bf16 or f32), D a multiple of 8 up to
    128 (16-byte row loads; the tiles are padded to 64 or 128 columns),
    B*H at most 65535 (the grid's second axis), contiguous tensors. Any
    S >= 1 passes: the kernels mask the ragged edge of the last tile."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        return False
    b, s_q, h, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != h
            or k.shape[3] != d):
        return False
    return (q.dtype in _DTYPE_CODE and q.dtype == k.dtype == v.dtype
            and d % 8 == 0 and 8 <= d <= 128 and s_q >= 1 and k.shape[1] >= 1
            and 0 < b * h <= 65535 and q.is_contiguous()
            and k.is_contiguous() and v.is_contiguous())


def _gate(fn: str, q, k, v) -> None:
    if not supports(q, k, v):
        raise ValueError(
            f"{fn}: unsupported geometry q {tuple(q.shape)} {q.dtype}, "
            f"k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} {v.dtype} "
            f"(see supports)")


def flash_block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_offset: int, k_offset: int, causal: bool,
                       scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash forward of one Q block against one K/V block on the card:
    q/k/v ``[B, S, H, D]`` -> (o ``[B, Sq, H, D]`` UNNORMALIZED f32,
    m ``[B, H, Sq]`` f32, l ``[B, H, Sq]`` f32), the causal mask taken at
    global positions ``q_offset + i >= k_offset + j``. A row that sees no
    key gives ``m = -1e30``, ``l = 0`` and ``o = 0``.

    Unlike the JAX function it takes no ``block_q``/``block_k``: the
    kernel fixes its 64-row tiles at compile time."""
    _check_cuda("flash_block_attend", (q, k, v),
                "parallel.sequence._block_attend")
    _gate("flash_block_attend", q, k, v)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((b, s_q, h, d), **f32)
    m = torch.empty((b, h, s_q), **f32)
    l = torch.empty((b, h, s_q), **f32)
    _launch("flash_fwd", "hvd_flash_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, h, s_q, s_k, d, int(q_offset),
            int(k_offset), float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype])
    LAUNCHES["flash_fwd"] += 1
    return o, m, l


def flash_bwd_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, dD: torch.Tensor,
                    q_offset: int, k_offset: int, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward of one Q block against one K/V block on the card:
    gradients of normalized attention against the GLOBAL row stats
    ``lse`` (logsumexp) and ``dD`` (rowsum(do * o)), both ``[B, H, Sq]``.
    Returns (dq ``[B, Sq, H, D]``, dk, dv ``[B, Sk, H, D]``) in f32. Two
    launches: the dq kernel and the dk/dv kernel.

    Unlike the JAX function it takes no ``block_q``/``block_k``: the
    kernels fix their 64-row tiles at compile time."""
    do = do.to(q.dtype).contiguous()
    lse = lse.to(torch.float32).contiguous()
    dD = dD.to(torch.float32).contiguous()
    _check_cuda("flash_bwd_block", (q, k, v, do, lse, dD),
                "parallel.sequence._bwd_block_plain")
    _gate("flash_bwd_block", q, k, v)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if do.shape != q.shape or lse.shape != (b, h, s_q) or \
            dD.shape != (b, h, s_q):
        raise ValueError(
            f"flash_bwd_block: do {tuple(do.shape)}, lse {tuple(lse.shape)} "
            f"and dD {tuple(dD.shape)} must be q's shape and [B, H, Sq]")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s_q, h, d), **f32)
    dk = torch.empty((b, s_k, h, d), **f32)
    dv = torch.empty((b, s_k, h, d), **f32)
    tail = (b, h, s_q, s_k, d, int(q_offset), int(k_offset), float(scale),
            int(bool(causal)), _DTYPE_CODE[q.dtype])
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), dD.data_ptr())
    _launch("flash_bwd", "hvd_flash_bwd_dq", q.device, *ins, dq.data_ptr(),
            *tail)
    LAUNCHES["flash_bwd_dq"] += 1
    _launch("flash_bwd", "hvd_flash_bwd_dkv", q.device, *ins, dk.data_ptr(),
            dv.data_ptr(), *tail)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Normalized attention over the full sequence: the flash forward,
    then the dq and dk/dv backward (``_flash_attention_fwd``/``_bwd`` of
    the JAX package). CUDA tensors go through the kernels, CPU tensors
    through their plain versions in ``parallel.sequence``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.is_cuda:
            o_un, m, l = flash_block_attend(q, k, v, 0, 0, causal, scale)
        else:
            from horovod_tpu_torch.parallel.sequence import _block_attend
            o_un, m, l = _block_attend(q.float(), k.float(), v.float(), 0, 0,
                                       causal, scale)
        l_safe = l.clamp_min(1e-30)
        o = (o_un / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
        lse = m + torch.log(l_safe)                       # [B, H, S]
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dD = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)  # [B,H,S]
        if q.is_cuda:
            dq, dk, dv = flash_bwd_block(q, k, v, do, lse, dD, 0, 0,
                                         ctx.causal, ctx.scale)
        else:
            from horovod_tpu_torch.parallel.sequence import _bwd_block_plain
            dq, dk, dv = _bwd_block_plain(q, k, v, do, lse, dD, 0, 0,
                                          ctx.causal, ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable normalized attention, q/k/v ``[B, S, H, D]`` ->
    ``[B, S, H, D]`` in q's dtype. It follows its tensors' device: on the
    card the forward and backward are the flash kernels; on the CPU their
    plain versions. ``scale`` defaults to ``D ** -0.5``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


# ---------------------------------------------------------------------------
# paged decode attention (serving path)
# ---------------------------------------------------------------------------

def paged_decode_supports(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: Optional[torch.Tensor] = None) -> bool:
    """Shape gate of the Hopper kernel: q ``[B, H, D]`` and pages
    ``[n_pages, page, KVH, D]`` in one dtype (bf16 or f32), D a multiple
    of 8 up to 256 (16-byte row loads, one thread per output element),
    Q heads grouping evenly over KV heads, contiguous tensors. Any page
    size passes."""
    if q.ndim != 3 or k_pages.ndim != 4:
        return False
    b, h, d = q.shape
    kvh = k_pages.shape[2]
    if v_pages is not None and (v_pages.shape != k_pages.shape
                                or v_pages.dtype != k_pages.dtype
                                or not v_pages.is_contiguous()):
        return False
    return (q.dtype in _DTYPE_CODE and q.dtype == k_pages.dtype
            and d % 8 == 0 and 0 < d <= 256 and k_pages.shape[3] == d
            and kvh > 0 and h % kvh == 0
            and q.is_contiguous() and k_pages.is_contiguous())


def flash_paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """Paged decode attention on the card -> normalized ``[B, H, D]`` f32.

    q ``[B, H, D]``; k/v pages ``[n_pages, page, KVH, D]`` in q's dtype;
    block_tables ``[B, n_max]`` and lengths ``[B]`` int32 on the same
    device. Raises on anything the kernel does not take.

    The kernel splits each sequence into chunks of ``PAGED_CHUNK``
    positions, one block per (chunk, sequence, KV head), and merges the
    chunks' partial softmax states in chunk order (two launches of one C
    call, counted as one). The partials go to an f32 scratch
    ``[B, H, n_chunks, D + 2]`` allocated here per call through the
    caching allocator (no kernel runs to allocate it), so a captured
    decode step can take the same buffer as an argument. The lengths stay
    on the card: the grid is sized from ``n_max * page``."""
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_paged_decode takes CUDA tensors only; "
                         "use kv_cache.paged_attention_reference on the CPU")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_paged_decode: tensors on different devices")
    if not paged_decode_supports(q, k_pages, v_pages):
        raise ValueError(
            f"flash_paged_decode: unsupported geometry q "
            f"{tuple(q.shape)} {q.dtype}, pages {tuple(k_pages.shape)} "
            f"{k_pages.dtype} (see paged_decode_supports)")
    b, h, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    if (block_tables.dtype != torch.int32 or lengths.dtype != torch.int32
            or block_tables.ndim != 2 or block_tables.shape[0] != b
            or tuple(lengths.shape) != (b,)
            or not block_tables.is_contiguous()
            or not lengths.is_contiguous()):
        raise ValueError(
            f"flash_paged_decode: block_tables {tuple(block_tables.shape)} "
            f"{block_tables.dtype} and lengths {tuple(lengths.shape)} "
            f"{lengths.dtype} must be contiguous int32 [B, n_max] and [B]")
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("flash_paged_decode: tensors must be "
                             "16-byte aligned")
    n_max = block_tables.shape[1]
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    n_chunks = -(-n_max * page // PAGED_CHUNK)
    part = torch.empty((b, h, n_chunks, d + 2), dtype=torch.float32,
                       device=q.device)
    _launch("paged_decode", "hvd_paged_decode", q.device,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), b, h, kvh, d, page, n_max, PAGED_CHUNK,
            float(scale), _DTYPE_CODE[q.dtype])
    LAUNCHES["paged_decode"] += 1
    return out
