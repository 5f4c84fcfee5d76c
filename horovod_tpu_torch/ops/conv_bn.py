"""Fused 1x1 convolution + batch-norm statistics: the wrappers of the CUDA
kernels.

The counterpart of ``horovod_tpu/ops/pallas/conv_bn.py``. A 1x1
convolution of an NHWC tensor is a matrix product over its rows,
``Y[M, Cout] = X[M, Cin] . W[Cin, Cout]`` with M = N*H*W, and two kernels
compute it with batch norm folded in:

- ``conv_bn_fwd`` launches ``csrc/conv_bn_fwd.cu`` (for ``_fwd_kernel``):
  ``Y = relu(X inv + shift) . W`` with the optional normalize+ReLU
  prologue, and the per-channel ``sum(Y)`` and ``sum(Y^2)`` of the stored
  Y from the epilogue, on the route :func:`fwd_plan` picks before the
  launch: ``wgmma`` (bf16, K and N multiples of 8: a persistent wgmma GEMM
  fed by TMA) or ``mma`` (f32 and the rest: PR 3's mma.sync/FMA GEMM);
- ``conv_bn_bwd`` launches ``csrc/conv_bn_bwd.cu`` (for ``_bwd_kernel``):
  dX, dW, d_inv and d_shift from the cotangents of all three outputs, on
  the route :func:`bwd_plan` picks before the launch: ``fused`` (bf16, K
  and N multiples of 8, K x N small enough for a block's registers: one
  wgmma pass over M), ``split`` (other such bf16 shapes: dX and dW as two
  wgmma launches) or ``mma`` (f32 and the rest: PR 3's mma.sync/FMA
  GEMMs).

They take CUDA tensors only. Their plain PyTorch versions,
:func:`conv1x1_bn_stats_plain` and :func:`conv1x1_bn_bwd_plain`, compute
the same functions with the same single-pass formulas; the
``autograd.Function`` behind :func:`conv1x1_bn_stats` uses them for CPU
tensors, and nothing else does. A CUDA tensor the kernels' gate
(:func:`supports`) refuses raises; it never goes to the plain version.

``LAUNCHES`` counts one launch per call of each wrapper, so a run can show
that its main path went through the kernels; ``FWD_ROUTES`` and
``BWD_ROUTES`` count each one's launches per route.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from horovod_tpu_torch.ops._build import DTYPE_CODE, check_cuda, launch

LAUNCHES: Dict[str, int] = {"conv_bn_fwd": 0, "conv_bn_bwd": 0}
FWD_ROUTES: Dict[str, int] = {"wgmma": 0, "mma": 0}
BWD_ROUTES: Dict[str, int] = {"fused": 0, "split": 0, "mma": 0}
_FWD_ROUTE_CODE = {"mma": 0, "wgmma": 1}
_ROUTE_CODE = {"mma": 0, "fused": 1, "split": 2}

# Row tile of PR 3's kernels, the mma routes (kBM in csrc/conv_bn_common.cuh):
# one partial row of column sums per tile of 128 rows.
_ROW_TILE = 128
# The dW product splits M so that K x N tiles times splits fill about two
# waves of an H100's 132 SMs. A constant, not the card's count: the split
# fixes the order of dW's sums.
_DW_BLOCKS = 2 * 132
# The wgmma routes (csrc/conv_bn_bwd.cu): 64 x 64 bf16 boxes of 8 KiB, at
# most 4 stages in a block's 232,448 bytes of shared memory, 1 KiB to align
# them and 56 bytes of barriers. The fused route runs at most _FUSED_CTAS
# blocks (one per SM of an H100, a constant: the count of dW partials
# fixes the order of their sums), each with four warpgroups: K at most 4
# boxes (one g tile each), K x N at most 8 boxes (4 with the prologue,
# whose d_inv/d_shift sums take the registers of a second dW tile).
_BOX, _BOX_BYTES, _SMEM, _SMEM_FIXED, _MAX_STAGES = 64, 8192, 232448, 1080, 4
_FUSED_CTAS = 132
_WALK_WGS = 4
# The split route's dW walk: slices of up to 8 boxes, at most 4 along N,
# split over M into enough blocks for about one wave of 132 SMs.
_SPLIT_BOXES, _SPLIT_NTS, _SPLIT_BLOCKS = 8, 4, 132


class FwdPlan(NamedTuple):
    """How :func:`conv_bn_fwd` runs a shape: the route, the output tile
    (``tile_m`` x ``tile_n``) and the rows of the s1/s2 partials, one per
    row tile."""
    route: str
    tile_m: int
    tile_n: int
    part_rows: int


class BwdPlan(NamedTuple):
    """How :func:`conv_bn_bwd` runs a shape: the route, the number of dW
    partials (``splits``), the walk's slice in 64-wide boxes (``kts`` x
    ``nts``) and ring ``stages`` (wgmma routes), and the rows of the
    d_inv/d_shift partials."""
    route: str
    splits: int
    kts: int
    nts: int
    stages: int
    part_x_rows: int


def reset_launches() -> None:
    for d in (LAUNCHES, FWD_ROUTES, BWD_ROUTES):
        for k in d:
            d[k] = 0


def supports(cin: int, cout: int, dtype: torch.dtype) -> bool:
    """Gate of the Hopper kernels: bf16 or f32 and any channel counts up
    to 8M (the column tiles of a launch). Unlike the TPU kernel there is
    no on-chip budget to respect (W and dW are not held resident), so
    every 1x1 convolution of the ResNets passes, the stage-4 1024 -> 2048
    projection included."""
    return (dtype in DTYPE_CODE and 0 < cin <= 8 * 1024 * 1024
            and 0 < cout <= 8 * 1024 * 1024)


def _dw_splits(m: int, k: int, n: int) -> int:
    tiles = math.ceil(k / _ROW_TILE) * math.ceil(n / _ROW_TILE)
    return max(1, min(math.ceil(_DW_BLOCKS / tiles), math.ceil(m / 256)))


def _walk_stages(kts: int, nts: int, prologue: bool, with_w: bool) -> int:
    """Ring stages of the walk that fit shared memory (walk_smem_bytes in
    csrc/conv_bn_bwd.cu): per stage dy_eff and y (nts boxes each), x and,
    with the prologue, relu(pre) (kts boxes each); with g, W (kts x nts)
    and the dX staging (kts) once."""
    stage = (2 * nts + (2 if prologue else 1) * kts) * _BOX_BYTES
    once = (kts * nts + kts) * _BOX_BYTES if with_w else 0
    free = _SMEM - _SMEM_FIXED - once
    return min(_MAX_STAGES, free // stage)


def fwd_plan(m: int, k: int, n: int, dtype: torch.dtype,
             prologue: bool) -> FwdPlan:
    """The forward's route for ``[m, k] x [k, n]`` in ``dtype``, decided
    from the shape alone (never from the card, never by catching a
    failure): ``wgmma`` for bf16 with K and N multiples of 8 (16-byte TMA
    strides), its tile as wide as N up to 256 columns (128 x 256, 256 x
    128 or 256 x 64: four warpgroups of 64 rows), so that x is read and
    normalized once where N fits one tile; ``mma`` for f32 and ragged
    bf16. The prologue runs on either route and does not change the
    plan."""
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
        tile_n = 64 if n <= 64 else 128 if n <= 128 else 256
        tile_m = 128 if tile_n == 256 else 256
        return FwdPlan("wgmma", tile_m, tile_n, math.ceil(m / tile_m))
    return FwdPlan("mma", _ROW_TILE, _ROW_TILE, math.ceil(m / _ROW_TILE))


def bwd_plan(m: int, k: int, n: int, dtype: torch.dtype,
             prologue: bool) -> BwdPlan:
    """The backward's route for ``[m, k] x [k, n]`` in ``dtype``, decided
    from the shape alone (never from the card, never by catching a
    failure): ``fused`` where the whole of K x N fits one block, ``split``
    for the other bf16 shapes whose K and N are multiples of 8 (16-byte
    TMA strides), ``mma`` for f32 and ragged bf16."""
    kt, nt = math.ceil(k / _BOX), math.ceil(n / _BOX)
    tiles = math.ceil(m / _BOX)
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
        if (kt <= _WALK_WGS and kt * nt <= (4 if prologue else 8)
                and _walk_stages(kt, nt, prologue, True) >= 2):
            splits = min(_FUSED_CTAS, tiles)
            return BwdPlan("fused", splits, kt, nt,
                           _walk_stages(kt, nt, prologue, True), splits)
        # the slice that loads the fewest boxes a row tile over all slices:
        # dy and y once per K slice, x once per N slice
        kts, nts = min(
            ((a, b) for a in range(1, min(kt, _SPLIT_BOXES) + 1)
             for b in range(1, min(nt, _SPLIT_NTS) + 1)
             if a * b <= _SPLIT_BOXES
             and _walk_stages(a, b, prologue, False) >= 2),
            key=lambda ab: (math.ceil(kt / ab[0]) * 2 * nt
                            + math.ceil(nt / ab[1]) * kt, -ab[0] * ab[1]))
        slices = math.ceil(kt / kts) * math.ceil(nt / nts)
        # at most one wave: a block past it would run alone after it
        splits = max(1, min(_SPLIT_BLOCKS // slices, math.ceil(tiles / 4)))
        return BwdPlan("split", splits, kts, nts,
                       _walk_stages(kts, nts, prologue, False),
                       math.ceil(m / _ROW_TILE))
    return BwdPlan("mma", _dw_splits(m, k, n), 0, 0, 0,
                   math.ceil(m / _ROW_TILE))


def _gate(fn: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if (x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]
            or x.dtype != w.dtype or not supports(*w.shape, x.dtype)
            or not x.is_contiguous() or not w.is_contiguous()):
        raise ValueError(
            f"{fn}: unsupported operands x {tuple(x.shape)} {x.dtype}, "
            f"w {tuple(w.shape)} {w.dtype} (contiguous [M, K] and [K, N] in "
            f"one dtype; see supports)")


def _prologue_ptrs(inv, shift):
    if inv is None:
        return None, None
    return inv.data_ptr(), shift.data_ptr()


def conv_bn_fwd(x: torch.Tensor, w: torch.Tensor,
                inv: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel on the card: x ``[M, K]``, w ``[K, N]`` in x's
    dtype, inv/shift ``[K]`` f32 or None -> (y ``[M, N]`` in x's dtype,
    sum(y) ``[N]`` f32, sum(y^2) ``[N]`` f32)."""
    ts = (x, w) if inv is None else (x, w, inv, shift)
    check_cuda("conv_bn_fwd", ts, "conv1x1_bn_stats_plain")
    _gate("conv_bn_fwd", x, w)
    m, k = x.shape
    n = w.shape[1]
    plan = fwd_plan(m, k, n, x.dtype, inv is not None)
    # the wgmma route reads W as it is; PR 3's kernel takes W^T
    wk = w if plan.route == "wgmma" else w.t().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    s1, s2 = torch.empty(n, **f32), torch.empty(n, **f32)
    part = torch.empty((2, plan.part_rows, n), **f32)
    launch("conv_bn_fwd", "hvd_conv_bn_fwd", x.device, x.data_ptr(),
           wk.data_ptr(), *_prologue_ptrs(inv, shift), y.data_ptr(),
           s1.data_ptr(), s2.data_ptr(), part.data_ptr(), m, k, n,
           int(inv is not None), _FWD_ROUTE_CODE[plan.route], plan.tile_n,
           DTYPE_CODE[x.dtype])
    LAUNCHES["conv_bn_fwd"] += 1
    FWD_ROUTES[plan.route] += 1
    return y, s1, s2


def conv_bn_bwd(x: torch.Tensor, w: torch.Tensor,
                inv: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                y: torch.Tensor, dy: torch.Tensor, ds1: torch.Tensor,
                ds2: torch.Tensor):
    """The backward kernels on the card: from the forward's inputs, its
    stored y and the cotangents dy ``[M, N]`` (y's dtype), ds1/ds2 ``[N]``
    f32 -> (dx ``[M, K]`` in x's dtype, dw ``[K, N]`` in w's dtype,
    d_inv, d_shift ``[K]`` f32, or None without the prologue)."""
    prologue = inv is not None
    ts = (x, w, y, dy, ds1, ds2) + ((inv, shift) if prologue else ())
    check_cuda("conv_bn_bwd", ts, "conv1x1_bn_bwd_plain")
    _gate("conv_bn_bwd", x, w)
    m, k = x.shape
    n = w.shape[1]
    if (y.shape != (m, n) or dy.shape != (m, n) or y.dtype != x.dtype
            or dy.dtype != x.dtype or ds1.shape != (n,)
            or ds2.shape != (n,) or not dy.is_contiguous()
            or not y.is_contiguous() or not ds1.is_contiguous()
            or not ds2.is_contiguous()):
        raise ValueError(
            f"conv_bn_bwd: y {tuple(y.shape)} {y.dtype}, dy "
            f"{tuple(dy.shape)} {dy.dtype}, ds1/ds2 {tuple(ds1.shape)} must "
            f"be contiguous [M, N] in x's dtype and [N] f32")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((m, k), dtype=x.dtype, device=x.device)
    dw = torch.empty((k, n), dtype=w.dtype, device=x.device)
    plan = bwd_plan(m, k, n, x.dtype, prologue)
    part_w = torch.empty((plan.splits, k, n), **f32)
    if prologue:
        dinv, dshift = torch.empty(k, **f32), torch.empty(k, **f32)
        part_x = torch.empty((2, plan.part_x_rows, k), **f32)
        outs = (dinv.data_ptr(), dshift.data_ptr(), part_x.data_ptr())
    else:
        dinv = dshift = None
        outs = (None, None, None)
    launch("conv_bn_bwd", "hvd_conv_bn_bwd", x.device, x.data_ptr(),
           w.data_ptr(), *_prologue_ptrs(inv, shift), y.data_ptr(),
           dy.data_ptr(), ds1.data_ptr(), ds2.data_ptr(), dx.data_ptr(),
           dw.data_ptr(), *outs, part_w.data_ptr(), m, k, n,
           _ROUTE_CODE[plan.route], plan.splits, plan.kts, plan.nts,
           plan.stages, int(prologue), DTYPE_CODE[x.dtype])
    LAUNCHES["conv_bn_bwd"] += 1
    BWD_ROUTES[plan.route] += 1
    return dx, dw, dinv, dshift


# ---------------------------------------------------------------------------
# plain versions (the kernels' spec; the CPU path)
# ---------------------------------------------------------------------------

def conv1x1_bn_stats_plain(x: torch.Tensor, w: torch.Tensor,
                           inv: Optional[torch.Tensor] = None,
                           shift: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain version of the forward kernel, same contract as
    :func:`conv_bn_fwd`: the prologue in f32 rounded to x's dtype, an f32
    product rounded to x's dtype, the sums of the rounded y in f32."""
    a = x if inv is None else torch.relu(x.float() * inv + shift).to(x.dtype)
    y = (a.float() @ w.float()).to(x.dtype)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def conv1x1_bn_bwd_plain(x, w, inv, shift, y, dy, ds1, ds2):
    """Plain version of the backward kernels, same contract as
    :func:`conv_bn_bwd`, with the TPU kernel's single-pass formulas
    (not autograd of the forward): dy_eff = dy + ds1 + 2 ds2 y in f32,
    rounded to x's dtype for both products."""
    dyc = (dy.float() + ds1 + 2.0 * ds2 * y.float()).to(x.dtype).float()
    g = dyc @ w.float().t()
    if inv is not None:
        xf = x.float()
        pre = xf * inv + shift
        gm = torch.where(pre > 0, g, torch.zeros_like(g))
        dx = gm * inv
        a = torch.relu(pre).to(x.dtype)
        dinv, dshift = (gm * xf).sum(0), gm.sum(0)
    else:
        dx, a, dinv, dshift = g, x, None, None
    dw = a.float().t() @ dyc
    return dx.to(x.dtype), dw.to(w.dtype), dinv, dshift


# ---------------------------------------------------------------------------
# the differentiable entry
# ---------------------------------------------------------------------------

class _ConvBN(torch.autograd.Function):
    """(y, sum y, sum y^2) of a 1x1 conv as a GEMM over [M, K] rows: the
    forward kernel and the backward kernels on the card, their plain
    versions on the CPU (the JAX package's ``custom_vjp``). An unused
    output's cotangent arrives as None and counts as zeros."""

    @staticmethod
    def forward(ctx, x, w, inv, shift):
        ctx.set_materialize_grads(False)
        fn = conv_bn_fwd if x.is_cuda else conv1x1_bn_stats_plain
        y, s1, s2 = fn(x, w, inv, shift)
        ctx.save_for_backward(x, w, inv, shift, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, inv, shift, y = ctx.saved_tensors
        n = w.shape[1]
        f32 = dict(dtype=torch.float32, device=x.device)
        dy = (torch.zeros_like(y) if dy is None
              else dy.to(y.dtype).contiguous())
        ds1 = torch.zeros(n, **f32) if ds1 is None else ds1.float()
        ds2 = torch.zeros(n, **f32) if ds2 is None else ds2.float()
        fn = conv_bn_bwd if x.is_cuda else conv1x1_bn_bwd_plain
        return fn(x, w, inv, shift, y, dy, ds1.contiguous(),
                  ds2.contiguous())


def conv1x1_bn_stats(x: torch.Tensor, w: torch.Tensor,
                     inv: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None, *,
                     strides: Tuple[int, int] = (1, 1)
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused ``y = conv1x1(relu(x * inv + shift), w)`` of NHWC ``x``
    returning ``(y, sum(y), sum(y^2))``, the per-channel sums taken in f32
    over N*H*W of the dtype-rounded y. ``w`` is ``[Cin, Cout]`` or HWIO
    ``[1, 1, Cin, Cout]`` and is cast to x's dtype; ``inv``/``shift`` of
    shape ``(Cin,)`` enable the normalize+ReLU prologue (computed in f32).
    A strided 1x1 conv subsamples the rows first, outside the autograd
    Function, so autograd scatters dx back to the strided positions.
    Differentiable in all four inputs. The tensors' device decides the
    path: the CUDA kernels (or a ValueError when :func:`supports` refuses)
    or, on the CPU, their plain versions."""
    if x.ndim != 4:
        raise ValueError(f"conv1x1_bn_stats: x must be NHWC, got shape "
                         f"{tuple(x.shape)}")
    if w.ndim == 4:
        if tuple(w.shape[:2]) != (1, 1):
            raise ValueError(f"conv1x1_bn_stats: a 1x1 HWIO kernel is "
                             f"[1, 1, Cin, Cout], got {tuple(w.shape)}")
        w = w.reshape(w.shape[2], w.shape[3])
    cin, cout = w.shape
    if x.shape[-1] != cin:
        raise ValueError(f"conv1x1_bn_stats: x has {x.shape[-1]} channels, "
                         f"w expects {cin}")
    if (inv is None) != (shift is None):
        raise ValueError("conv1x1_bn_stats: pass inv and shift together")
    if x.is_cuda and not supports(cin, cout, x.dtype):
        raise ValueError(f"conv1x1_bn_stats: the kernels do not take "
                         f"{cin} -> {cout} in {x.dtype} (see supports)")
    if tuple(strides) != (1, 1):
        x = x[:, ::strides[0], ::strides[1], :]
    n, h, wd = x.shape[:3]
    x2 = x.reshape(n * h * wd, cin).contiguous()
    if inv is not None:
        inv, shift = inv.float().contiguous(), shift.float().contiguous()
    y2, s1, s2 = _ConvBN.apply(x2, w.to(x.dtype).contiguous(), inv, shift)
    return y2.reshape(n, h, wd, cout), s1, s2
