"""The port's fused 1x1-conv + batch-norm op against the JAX package, on
the CPU.

The same numpy inputs go through ``horovod_tpu.ops.pallas.conv_bn.
conv1x1_bn_stats(..., interpret=True)`` (the Pallas kernels, interpreted)
and the port's ``conv1x1_bn_stats``, whose ``autograd.Function`` takes
the kernels' plain versions for CPU tensors. Tolerances are the JAX
tests' own (``tests/test_fused_conv_bn.py``): y 2e-5; s1 rtol 2e-4 /
atol 2e-3; s2 rtol 2e-4 / atol 2e-2; gradients rtol 2e-4 / atol 2e-3 —
f32 sums taken in other orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops.pallas import conv_bn as jconv_bn
from horovod_tpu_torch.ops import conv_bn

Y_TOL = dict(rtol=2e-5, atol=2e-5)
S1_TOL = dict(rtol=2e-4, atol=2e-3)
S2_TOL = dict(rtol=2e-4, atol=2e-2)
GRAD_TOL = dict(rtol=2e-4, atol=2e-3)

CASES = [
    (2, 8, 8, 16, 32, (1, 1), False),
    (2, 8, 8, 16, 32, (1, 1), True),      # prologue
    (3, 7, 7, 130, 70, (1, 1), True),     # M, K, N not multiples of a tile
    (2, 8, 8, 16, 32, (2, 2), True),      # strided (projection conv)
    (1, 8, 8, 32, 576, (1, 1), False),    # N = 576: columns past a tile
]


def _inputs(seed, n, h, w, k, c, prologue):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, k).astype(np.float32)
    wt = (rng.randn(k, c) * 0.1).astype(np.float32)
    inv = (rng.rand(k) + 0.5).astype(np.float32) if prologue else None
    shift = (rng.randn(k) * 0.1).astype(np.float32) if prologue else None
    return x, wt, inv, shift


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("n,h,w,k,c,stride,prologue", CASES)
def test_forward_matches_jax_kernel(n, h, w, k, c, stride, prologue):
    x, wt, inv, shift = _inputs(0, n, h, w, k, c, prologue)
    jy, js1, js2 = jconv_bn.conv1x1_bn_stats(
        _j(x), _j(wt), _j(inv), _j(shift), strides=stride, interpret=True)
    conv_bn.reset_launches()
    y, s1, s2 = conv_bn.conv1x1_bn_stats(_t(x), _t(wt), _t(inv), _t(shift),
                                         strides=stride)
    assert conv_bn.LAUNCHES == {"conv_bn_fwd": 0, "conv_bn_bwd": 0}
    assert y.shape == jy.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **Y_TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), **S1_TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **S2_TOL)


@pytest.mark.parametrize("n,h,w,k,c,stride,prologue", CASES)
def test_gradients_match_jax_kernel(n, h, w, k, c, stride, prologue):
    """d(x), d(w), d(inv), d(shift) of the JAX tests' loss
    sum(y^2)/2 + s1.c1 + s2.c2 against jax.grad through the interpreted
    Pallas custom VJP."""
    x, wt, inv, shift = _inputs(1, n, h, w, k, c, True)
    rng = np.random.RandomState(2)
    c1 = rng.randn(c).astype(np.float32)
    c2 = (rng.randn(c) * 0.01).astype(np.float32)
    if not prologue:
        inv = shift = None

    def jloss(x, wt, *bn):
        y, s1, s2 = jconv_bn.conv1x1_bn_stats(x, wt, *bn, strides=stride,
                                              interpret=True)
        return jnp.sum(y * y) * 0.5 + jnp.sum(s1 * c1) + jnp.sum(s2 * c2)

    args = [x, wt] + ([inv, shift] if prologue else [])
    jgrads = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, s1, s2 = conv_bn.conv1x1_bn_stats(*ts[:2], *(ts[2:] or [None, None]),
                                         strides=stride)
    loss = ((y * y).sum() * 0.5 + (s1 * torch.from_numpy(c1)).sum()
            + (s2 * torch.from_numpy(c2)).sum())
    grads = torch.autograd.grad(loss, ts)
    for g, jg, name in zip(grads, jgrads, "x w inv shift".split()):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("m,k,n", [(128, 16, 32), (147, 130, 70)])
def test_plain_backward_equals_autograd_of_plain_forward(m, k, n, prologue):
    """The single-pass formulas of conv1x1_bn_bwd_plain against autograd
    through conv1x1_bn_stats_plain, f32 (1e-5: the same products summed in
    other orders)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, n) * 0.1).astype(np.float32))
    inv = torch.from_numpy((rng.rand(k) + 0.5).astype(np.float32))
    shift = torch.from_numpy((rng.randn(k) * 0.5).astype(np.float32))
    dy = torch.from_numpy(rng.randn(m, n).astype(np.float32))
    ds1 = torch.from_numpy(rng.randn(n).astype(np.float32))
    ds2 = torch.from_numpy((rng.randn(n) * 0.01).astype(np.float32))
    bn = (inv, shift) if prologue else (None, None)
    leaves = [t.clone().requires_grad_(True)
              for t in (x, w) + (bn if prologue else ())]
    y, s1, s2 = conv_bn.conv1x1_bn_stats_plain(
        *leaves[:2], *(leaves[2:] or [None, None]))
    want = torch.autograd.grad((y, s1, s2), leaves, (dy, ds1, ds2))
    y_det = conv_bn.conv1x1_bn_stats_plain(x, w, *bn)[0]
    got = conv_bn.conv1x1_bn_bwd_plain(x, w, *bn, y_det, dy, ds1, ds2)
    if not prologue:
        assert got[2] is None and got[3] is None
    for g, wnt, name in zip(got, want, "dx dw dinv dshift".split()):
        torch.testing.assert_close(g, wnt, rtol=1e-5, atol=1e-5, msg=name)


def test_unused_outputs_count_as_zero_cotangents():
    """Only y reaches the loss: the Function gets None for ds1 and ds2 and
    must give autograd-of-plain's gradients (which see zeros there)."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 4, 4, 8).astype(np.float32))
    w = torch.from_numpy((rng.randn(8, 12) * 0.3).astype(np.float32))
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y, _, _ = conv_bn.conv1x1_bn_stats(xa, wa)
    y.sum().backward()
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yb = conv_bn.conv1x1_bn_stats_plain(xb.reshape(-1, 8), wb)[0]
    yb.sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-6, atol=1e-6)


def test_hwio_weight_bf16_and_errors():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 4, 4, 8).astype(np.float32))
    w = torch.from_numpy((rng.randn(8, 6) * 0.3).astype(np.float32))
    y2, a2, b2 = conv_bn.conv1x1_bn_stats(x, w)
    y4, a4, b4 = conv_bn.conv1x1_bn_stats(x, w.reshape(1, 1, 8, 6))
    assert torch.equal(y2, y4) and torch.equal(a2, a4)
    # bf16: the product is rounded to bf16, the sums are f32 over the
    # rounded values
    yb, s1b, s2b = conv_bn.conv1x1_bn_stats(x.bfloat16(), w)
    assert yb.dtype == torch.bfloat16 and s1b.dtype == torch.float32
    torch.testing.assert_close(s1b, yb.float().sum((0, 1, 2)))
    with pytest.raises(ValueError, match="1x1"):
        conv_bn.conv1x1_bn_stats(x, torch.zeros(3, 3, 8, 6))
    with pytest.raises(ValueError, match="channels"):
        conv_bn.conv1x1_bn_stats(x, torch.zeros(4, 6))
    with pytest.raises(ValueError, match="together"):
        conv_bn.conv1x1_bn_stats(x, w, torch.ones(8))


def test_gate_and_cuda_only_wrappers():
    """The Hopper gate takes every ResNet 1x1 conv (the TPU gate refused
    the 1024 -> 2048 projection) in bf16 and f32; the kernel wrappers
    refuse CPU tensors."""
    for cin, cout in ((64, 256), (2048, 512), (1024, 2048), (130, 70)):
        for dt in (torch.bfloat16, torch.float32):
            assert conv_bn.supports(cin, cout, dt)
    assert not jconv_bn.supports(1024, 2048)
    assert not conv_bn.supports(64, 64, torch.float16)
    assert not conv_bn.supports(0, 64, torch.float32)
    x, w = torch.zeros(4, 8), torch.zeros(8, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        conv_bn.conv_bn_fwd(x, w)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        conv_bn.conv_bn_bwd(x, w, None, None, x, x, torch.zeros(8),
                            torch.zeros(8))


# ---------------------------------------------------------------------------
# the backward's spec at every distinct ResNet-50 1x1 conv, and its routing
# ---------------------------------------------------------------------------

# (K, N, prologue, stride) of each distinct 1x1 conv of ResNet-50 (stages
# 1-4: conv1 of block 0, the projection, conv1, conv3).
RESNET50_1X1 = [
    (64, 64, False, 1), (64, 256, False, 1), (256, 64, False, 1),
    (64, 256, True, 1),
    (256, 128, False, 1), (256, 512, False, 2), (512, 128, False, 1),
    (128, 512, True, 1),
    (512, 256, False, 1), (512, 1024, False, 2), (1024, 256, False, 1),
    (256, 1024, True, 1),
    (1024, 512, False, 1), (1024, 2048, False, 2), (2048, 512, False, 1),
    (512, 2048, True, 1),
]


RESNET50_CASES = dict(
    argvalues=[(k, c, p, s, (2, 5, 5)) for k, c, p, s in RESNET50_1X1] + [
        (64, 256, True, 1, (3, 7, 7)), (130, 72, True, 2, (3, 7, 7))],
    ids=[f"{k}x{c}{'p' if p else ''}s{s}" for k, c, p, s in RESNET50_1X1]
    + ["64x256p_m147", "130x72p_s2_m48"])


@pytest.mark.parametrize("k,c,prologue,stride,images", **RESNET50_CASES)
def test_plain_forward_matches_jax_kernel_at_resnet50_shapes(
        k, c, prologue, stride, images):
    """``conv1x1_bn_stats`` on the CPU (the CUDA forward's spec, its plain
    version) against the Pallas forward kernel, interpreted, at every
    distinct (K, N, prologue, stride) of ResNet-50's 1x1 convs at 2 x 5 x
    5 images (M = 50, or 18 after the stride); the last two at 3 x 7 x 7
    (M = 147, or 48 after the stride: off every 64- and 128-row tile, so
    the sums must skip the rows the kernel pads). Y_TOL, S1_TOL, S2_TOL:
    f32 sums in other orders."""
    n, h, w = images
    x, wt, inv, shift = _inputs(5, n, h, w, k, c, prologue)
    jy, js1, js2 = jconv_bn.conv1x1_bn_stats(
        _j(x), _j(wt), _j(inv), _j(shift), strides=(stride, stride),
        interpret=True)
    y, s1, s2 = conv_bn.conv1x1_bn_stats(_t(x), _t(wt), _t(inv), _t(shift),
                                         strides=(stride, stride))
    assert y.shape == jy.shape == (n, -(-h // stride), -(-w // stride), c)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **Y_TOL,
                               err_msg="y")
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), **S1_TOL,
                               err_msg="s1")
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **S2_TOL,
                               err_msg="s2")


@pytest.mark.parametrize("k,c,prologue,stride,images", **RESNET50_CASES)
def test_plain_backward_matches_jax_kernel_at_resnet50_shapes(
        k, c, prologue, stride, images):
    """``conv1x1_bn_bwd_plain`` (the CUDA backward's spec) against the
    Pallas backward kernel, interpreted, reached through jax.vjp of the JAX
    op with the same cotangents, at every distinct (K, N, prologue,
    stride) of ResNet-50's 1x1 convs at 2 x 5 x 5 images (M = 50, or 18
    after the stride); the last two at 3 x 7 x 7 (M = 147, or 48 after the
    stride: not a multiple of a 64- or 128-row tile). GRAD_TOL: f32 sums
    in other orders. dx at the rows a strided conv skips is exactly
    zero."""
    n, h, w = images
    x, wt, inv, shift = _inputs(7, n, h, w, k, c, prologue)
    rng = np.random.RandomState(k + c)
    ho, wo = -(-h // stride), -(-w // stride)
    dy = rng.randn(n, ho, wo, c).astype(np.float32)
    ds1 = rng.randn(c).astype(np.float32)
    ds2 = (rng.randn(c) * 0.01).astype(np.float32)
    bn = [inv, shift] if prologue else []

    def f(x_, wt_, *bn_):
        return jconv_bn.conv1x1_bn_stats(x_, wt_, *(bn_ or (None, None)),
                                         strides=(stride, stride),
                                         interpret=True)

    (jy, _, _), vjp = jax.vjp(f, *[jnp.asarray(a) for a in [x, wt] + bn])
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(ds1), jnp.asarray(ds2)))
    xs = x[:, ::stride, ::stride, :].reshape(-1, k)
    y = np.array(jy).reshape(-1, c)
    got = conv_bn.conv1x1_bn_bwd_plain(
        torch.from_numpy(xs), torch.from_numpy(wt), _t(inv), _t(shift),
        torch.from_numpy(y), torch.from_numpy(dy.reshape(-1, c)),
        torch.from_numpy(ds1), torch.from_numpy(ds2))
    jdx = np.asarray(jgrads[0])
    np.testing.assert_allclose(
        got[0].numpy(), jdx[:, ::stride, ::stride, :].reshape(-1, k),
        **GRAD_TOL, err_msg="dx")
    if stride > 1:
        mask = np.ones(jdx.shape, bool)
        mask[:, ::stride, ::stride, :] = False
        assert not jdx[mask].any()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jgrads[1]),
                               **GRAD_TOL, err_msg="dw")
    if prologue:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(jgrads[2]),
                                   **GRAD_TOL, err_msg="dinv")
        np.testing.assert_allclose(got[3].numpy(), np.asarray(jgrads[3]),
                                   **GRAD_TOL, err_msg="dshift")
    else:
        assert got[2] is None and got[3] is None


# Rows M the kernel sees for each distinct ResNet-50 1x1 conv at 128
# images of 224^2 (after a strided projection subsamples them): 128 x 56^2
# in stage 1 and in stage 2's first conv1, a quarter of that per stage on.
RESNET50_ROWS = {
    (64, 64): 401408, (64, 256): 401408, (256, 64): 401408,
    (256, 128): 401408, (256, 512): 100352, (512, 128): 100352,
    (128, 512): 100352, (512, 256): 100352, (512, 1024): 25088,
    (1024, 256): 25088, (256, 1024): 25088, (1024, 512): 25088,
    (1024, 2048): 6272, (2048, 512): 6272, (512, 2048): 6272}


def test_bwd_plan_routes_every_resnet50_shape_to_wgmma():
    """The backward's plan at every distinct ResNet-50 1x1 conv (bf16, 128
    images): stage 1 and stage 2's first conv1 take the fused route (one
    pass over M: W and dW held by a block), the rest the split route; none
    takes the mma route. Partials: a constant 132 for the fused route, at
    most one wave of 132 blocks for the split route, never more than the
    row tiles; the ring of stages fits a block's 232,448 bytes with 2 to 4
    stages."""
    fused = {(64, 64), (64, 256), (256, 64), (256, 128)}
    for k, c, prologue, stride in RESNET50_1X1:
        m = RESNET50_ROWS[(k, c)]
        plan = conv_bn.bwd_plan(m, k, c, torch.bfloat16, prologue)
        assert plan.route == ("fused" if (k, c) in fused else "split"), \
            (k, c)
        tiles = -(-m // 64)
        assert 1 <= plan.splits <= tiles
        assert 2 <= plan.stages <= 4
        stage = (2 * plan.nts + (2 if prologue else 1) * plan.kts) * 8192
        once = (plan.kts * plan.nts + plan.kts) * 8192 \
            if plan.route == "fused" else 0
        assert 1080 + once + plan.stages * stage <= 232448
        if plan.route == "fused":
            assert plan.splits == 132 and plan.part_x_rows == plan.splits
            assert (plan.kts, plan.nts) == (-(-k // 64), -(-c // 64))
        else:
            slices = -(-k // 64 // plan.kts) * -(-c // 64 // plan.nts)
            assert plan.kts * plan.nts <= 8 and plan.nts <= 4
            assert plan.splits * slices <= max(132, slices)
            assert plan.part_x_rows == -(-m // 128)


def test_bwd_plan_depends_on_the_shape_only(monkeypatch):
    """The plan (and so the number and order of the partial sums, and the
    bits of dW, d_inv and d_shift) never asks the card: with every query
    of the CUDA runtime failing it gives the same plans."""
    shapes = [(401408, 64, 256, True), (100352, 512, 128, False),
              (6272, 1024, 2048, False), (147, 130, 70, True)]
    before = [conv_bn.bwd_plan(m, k, n, torch.bfloat16, p)
              for m, k, n, p in shapes]

    def no_card(*args, **kw):
        raise AssertionError("the plan asked the card")

    for name in ("get_device_properties", "device_count", "is_available",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    after = [conv_bn.bwd_plan(m, k, n, torch.bfloat16, p)
             for m, k, n, p in shapes]
    assert after == before


@pytest.mark.parametrize("m,k,n,dtype,prologue,route", [
    (147, 130, 70, torch.bfloat16, True, "mma"),     # K, N not % 8
    (461, 72, 44, torch.bfloat16, False, "mma"),     # N % 8 != 0
    (401408, 64, 256, torch.float32, True, "mma"),   # f32: FMA kernels
    (401408, 64, 256, torch.bfloat16, True, "fused"),
    (461, 72, 40, torch.bfloat16, True, "fused"),    # K, N % 8 == 0
    (461, 128, 256, torch.bfloat16, True, "split"),  # 8 boxes > 4 with it
    (461, 128, 256, torch.bfloat16, False, "split"),  # 1 stage would fit
    (461, 128, 128, torch.bfloat16, False, "fused"),
    (461, 320, 64, torch.bfloat16, False, "split"),  # 5 boxes of K
])
def test_bwd_plan_routes_ragged_and_f32_shapes(m, k, n, dtype, prologue,
                                               route):
    """Ragged bf16 (K or N not a multiple of 8: TMA needs 16-byte strides)
    and every f32 shape stay on the mma route, with PR 3's dW splits and
    one d_inv/d_shift partial row per 128 rows; the wgmma routes take
    what fits them."""
    plan = conv_bn.bwd_plan(m, k, n, dtype, prologue)
    assert plan.route == route
    if route == "mma":
        assert plan.splits == conv_bn._dw_splits(m, k, n)
        assert plan.part_x_rows == -(-m // 128)


# ---------------------------------------------------------------------------
# the forward's routing
# ---------------------------------------------------------------------------

def test_fwd_plan_routes_every_resnet50_shape_to_wgmma():
    """The forward's plan at every distinct ResNet-50 1x1 conv (bf16, 128
    images): the wgmma route, its tile as wide as N up to 256 columns (so
    that where N fits one tile x is read once), four warpgroups of 64 rows,
    and one s1/s2 partial row per row tile."""
    for k, c, prologue, stride in RESNET50_1X1:
        m = RESNET50_ROWS[(k, c)]
        plan = conv_bn.fwd_plan(m, k, c, torch.bfloat16, prologue)
        assert plan.route == "wgmma", (k, c)
        assert plan.tile_n == min(256, max(64, c)), (k, c)
        assert plan.tile_m == (128 if plan.tile_n == 256 else 256)
        assert plan.part_rows == -(-m // plan.tile_m)


def test_fwd_plan_depends_on_the_shape_only(monkeypatch):
    """The forward's plan (and so the number and order of its partial sums,
    and the bits of s1 and s2) never asks the card: with every query of the
    CUDA runtime failing it gives the same plans."""
    shapes = [(401408, 64, 256, True), (401408, 256, 64, False),
              (100352, 256, 128, False), (6272, 1024, 2048, False),
              (147, 130, 70, True)]
    before = [conv_bn.fwd_plan(m, k, n, dt, p) for m, k, n, p in shapes
              for dt in (torch.bfloat16, torch.float32)]

    def no_card(*args, **kw):
        raise AssertionError("the plan asked the card")

    for name in ("get_device_properties", "device_count", "is_available",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    after = [conv_bn.fwd_plan(m, k, n, dt, p) for m, k, n, p in shapes
             for dt in (torch.bfloat16, torch.float32)]
    assert after == before


@pytest.mark.parametrize("m,k,n,dtype,prologue,route,tile_n", [
    (147, 130, 70, torch.bfloat16, True, "mma", 128),    # K, N not % 8
    (461, 72, 44, torch.bfloat16, False, "mma", 128),    # N % 8 != 0
    (461, 36, 64, torch.bfloat16, True, "mma", 128),     # K % 8 != 0
    (401408, 64, 256, torch.float32, True, "mma", 128),  # f32: FMAs
    (461, 72, 40, torch.bfloat16, True, "wgmma", 64),    # K, N % 8 == 0
    (461, 64, 72, torch.bfloat16, False, "wgmma", 128),
    (6273, 72, 576, torch.bfloat16, True, "wgmma", 256),
])
def test_fwd_plan_routes_ragged_and_f32_shapes(m, k, n, dtype, prologue,
                                               route, tile_n):
    """Ragged bf16 (K or N not a multiple of 8: TMA needs 16-byte strides)
    and every f32 shape stay on PR 3's mma route with one partial row per
    128 rows; bf16 with K and N multiples of 8 takes the wgmma route at any
    M, K and N."""
    plan = conv_bn.fwd_plan(m, k, n, dtype, prologue)
    assert (plan.route, plan.tile_n) == (route, tile_n)
    assert plan.part_rows == -(-m // plan.tile_m)
    if route == "mma":
        assert (plan.tile_m, plan.part_rows) == (128, -(-m // 128))


def test_forward_routes_count_nothing_on_the_cpu():
    """On the CPU the op takes the plain forward: no launch and no route is
    counted, and reset_launches zeroes the forward's routes too."""
    conv_bn.FWD_ROUTES["wgmma"] += 3
    conv_bn.reset_launches()
    x = torch.randn(2, 4, 4, 16, dtype=torch.bfloat16)
    conv_bn.conv1x1_bn_stats(x, torch.randn(16, 64), torch.ones(16),
                             torch.zeros(16))
    assert conv_bn.FWD_ROUTES == {"wgmma": 0, "mma": 0}
    assert conv_bn.LAUNCHES == {"conv_bn_fwd": 0, "conv_bn_bwd": 0}
