"""The stream-copy kernel and the bandwidth probe built on it.

The counterpart of ``bench.py``'s ``copy_kernel`` / ``pallas_copy`` and
of ``pallas_bandwidth_main`` (``bench.py --pallas-bandwidth``): how close a
hand-written streaming pass comes to the card's memory rate, beside the
framework's own elementwise pass. The bucket epilogue of the gradient sync
(decode, residual, optimizer update) is such a memory-bound pass.

:func:`stream_copy` launches ``csrc/stream_copy.cu`` on CUDA tensors and
takes its plain version, :func:`stream_copy_plain` (``out.copy_(x)``),
only for CPU tensors. ``LAUNCHES`` counts one launch per kernel call, so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from horovod_tpu_torch.ops._build import launch
from horovod_tpu_torch.utils.device import resolve_device

LAUNCHES: Dict[str, int] = {"stream_copy": 0}

# Bytes each CTA moves when the caller does not choose its tile.
DEFAULT_CTA_BYTES = 32 * 1024


def reset_launches() -> None:
    LAUNCHES["stream_copy"] = 0


def stream_copy_plain(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The plain version: ``out.copy_(x)``."""
    return out.copy_(x)


def _rows(x: torch.Tensor):
    """(rows, bytes per row) of the copy: the leading dim is the row."""
    rows = x.shape[0] if x.dim() else 1
    return rows, (x.numel() // rows) * x.element_size() if rows else 0


def stream_copy(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                rows_per_cta: Optional[int] = None) -> torch.Tensor:
    """``out = x`` (a new tensor when ``out`` is None), byte for byte.

    ``x`` and ``out`` must be contiguous, of one shape, dtype and device,
    and must not overlap. On CUDA tensors the kernel copies
    ``rows_per_cta`` rows of ``x`` per CTA (default: ~32 KiB of rows) or
    the call raises; on CPU tensors the plain version runs."""
    if not x.is_contiguous():
        raise ValueError("stream_copy: x must be contiguous")
    if out is None:
        out = torch.empty_like(x)
    if (out.shape != x.shape or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(
            f"stream_copy: out must be a contiguous tensor of x's shape, "
            f"dtype and device ({tuple(x.shape)}, {x.dtype}, {x.device}); "
            f"got ({tuple(out.shape)}, {out.dtype}, {out.device}, "
            f"contiguous={out.is_contiguous()})")
    if x.device.type == "cpu":
        return stream_copy_plain(x, out)
    if not x.is_cuda:
        raise ValueError(f"stream_copy takes CUDA or CPU tensors, not "
                         f"{x.device}")
    if x.numel() == 0:
        return out
    rows, row_bytes = _rows(x)
    if rows_per_cta is None:
        rows_per_cta = max(1, DEFAULT_CTA_BYTES // row_bytes)
    if rows_per_cta < 1:
        raise ValueError("stream_copy: rows_per_cta must be >= 1")
    launch("stream_copy", "hvd_stream_copy", x.device, x.data_ptr(),
           out.data_ptr(), rows, row_bytes, int(rows_per_cta))
    LAUNCHES["stream_copy"] += 1
    return out


def bandwidth_probe(device="cuda", rows: int = 131072, cols: int = 1024,
                    n_it: int = 8,
                    tiles: Sequence[int] = (1, 4, 16, 64)) -> List[dict]:
    """``bench.py --pallas-bandwidth`` on the card: a bf16 ``[rows, cols]``
    array of ones (256 MiB at the default, far beyond the L2), ``n_it``
    chained passes timed by CUDA events (no closing reduction timed), for
    torch's elementwise pass ``v * (v[0, 0] * 0.001 + 1)`` (a data-dependent
    scalar, as in bench.py), ``copy_``, and the stream-copy kernel at each
    ``tiles`` rows per CTA, ping-ponging between two buffers. Each row:
    ms per pass and GB/s, counting the bytes read plus the bytes written.
    Needs a card: a CPU device raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("bandwidth_probe measures a card: pass a CUDA "
                         "device")
    x = torch.ones((rows, cols), dtype=torch.bfloat16, device=dev)
    y = torch.empty_like(x)
    nbytes = 2 * x.numel() * x.element_size()

    def elementwise(v, _w):
        return v * (v[0, 0] * 0.001 + 1.0)

    def copy_(v, w):
        return w.copy_(v)

    def kernel(tile):
        return lambda v, w: stream_copy(v, w, rows_per_cta=tile)

    arms = [("torch_elementwise", elementwise), ("torch_copy_", copy_)]
    arms += [(f"stream_copy_rows{t}", kernel(t)) for t in tiles]
    out = []
    for name, fn in arms:
        def chain():
            v, w = x, y
            for _ in range(n_it):
                r = fn(v, w)
                v, w = r, (v if r is w else w)
            return v
        chain()                                     # warm-up
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain()
        end.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end) / n_it
        out.append({"impl": name, "ms": ms,
                    "gb_s": nbytes / (ms / 1e3) / 1e9})
    return out
