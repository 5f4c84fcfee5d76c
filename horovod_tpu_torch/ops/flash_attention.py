"""Paged single-query decode attention: the wrapper of the CUDA kernel.

``flash_paged_decode`` launches ``csrc/paged_decode.cu``, the Hopper
counterpart of the Pallas kernel ``_paged_decode_kernel`` of
``horovod_tpu/ops/pallas/flash_attention.py``. It takes CUDA tensors only;
the plain PyTorch version of the same function is
``serving.kv_cache.paged_attention_reference``, which the dispatch in
``serving.kv_cache.paged_decode_attention`` uses for CPU tensors.

``LAUNCHES`` counts launches per kernel, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

LAUNCHES: Dict[str, int] = {"paged_decode": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    device. Raises on anything the kernel does not take."""
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
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hvd_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, kvh, d, page, n_max, float(scale), _DTYPE_CODE[q.dtype],
            stream)
    if err:
        msg = lib.hvd_cuda_error_string(err).decode()
        raise RuntimeError(f"paged_decode kernel launch failed: {msg} "
                           f"(cudaError {err})")
    LAUNCHES["paged_decode"] += 1
    return out


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures set (built on first
    use)."""
    from horovod_tpu_torch.ops import _build
    lib = _build.load("paged_decode")
    if lib.hvd_paged_decode.argtypes is None:
        lib.hvd_paged_decode.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.hvd_paged_decode.restype = ctypes.c_int
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
    return lib
