"""The port's CUDA kernels and its training step on a card.

Every test here is marked ``cuda`` and skips when
``torch.cuda.is_available()`` is False, which it is on the CPU machines
that run the suite. The module imports neither jax nor the JAX package,
so on a machine with an H100 (and no JAX) it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Each kernel is held against its plain PyTorch version on the same card;
tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as htt
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import sequence as sp
from horovod_tpu_torch.utils import tree as tree_util

CFG_KW = dict(vocab_size=256, d_model=64, n_heads=4, head_dim=16,
              n_layers=2, d_ff=128, max_seq=256, dtype=torch.float32,
              dp_axis="dp", remat=False)


def _cfg():
    return htt.TransformerConfig(**CFG_KW)


def _sgd(leaves):
    return torch.optim.SGD(leaves, lr=0.01, momentum=0.9)


def _batches(n, b=4, s=32, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG_KW["vocab_size"], (b, s)),
             rng.integers(0, CFG_KW["vocab_size"], (b, s))) for _ in range(n)]


def rand_qkv(rng, b, sq, sk, h, d):
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]



def _cuda_case(rng, b, sq, sk, h, d, dtype):
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(a).to(dev).to(dtype)
               for a in rand_qkv(rng, b, sq, sk, h, d))
    do = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(
        np.float32)).to(dev).to(dtype)
    return q, k, v, do


def _assert_rel_close(a, ref, rel, what):
    """max |a - ref| <= rel * max(1, max |ref|)."""
    err = float((a - ref).abs().max())
    lim = rel * max(1.0, float(ref.abs().max()))
    assert err <= lim, f"{what}: max abs err {err} > {lim}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,rel", [
    (torch.float32, 64, 1e-4),        # FMA kernels
    (torch.bfloat16, 64, 1e-2),       # tensor-core kernels
    (torch.bfloat16, 16, 1e-2),       # tensor cores, zero-padded columns
    (torch.bfloat16, 96, 1e-4),       # FMA kernels (D > 64)
])
@pytest.mark.parametrize("sq,sk,qoff,koff,causal", [
    (256, 256, 0, 0, True),           # the training geometry
    (200, 328, 0, 0, False),          # ragged S on both sides
    (1000, 1000, 0, 0, True),         # ragged S, causal
    (128, 128, 0, 128, True),         # fully masked K block
    (128, 128, 256, 128, True),       # K block behind Q
])
def test_cuda_kernels_match_plain_versions(dtype, d, rel, sq, sk, qoff,
                                          koff, causal):
    """Each kernel against its plain version on the card (skips without
    one): o, m, l of the forward; dq, dk, dv of the backward pair. Errors
    relative to the largest reference value: the FMA kernels sum in f32 in
    another order than cuBLAS (1e-4); the tensor-core kernels round P and
    dS to bf16 before their products (1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(10)
    q, k, v, do = _cuda_case(rng, 2, sq, sk, 3, d, dtype)
    scale = d ** -0.5
    before = dict(fa.LAUNCHES)
    o, m, l = fa.flash_block_attend(q, k, v, qoff, koff, causal, scale)
    ro, rm, rl = sp._block_attend(q.float(), k.float(), v.float(), qoff,
                                  koff, causal, scale)
    lse = rm + torch.log(rl.clamp_min(1e-30))
    dD = torch.from_numpy(rng.standard_normal(lse.shape).astype(
        np.float32)).cuda()
    got = fa.flash_bwd_block(q, k, v, do, lse, dD, qoff, koff, causal, scale)
    torch.cuda.synchronize()
    want = sp._bwd_block_plain(q, k, v, do, lse, dD, qoff, koff, causal,
                               scale)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.LAUNCHES[name] == before[name] + 1
    for a, ref, what in zip((o, m, l) + tuple(got), (ro, rm, rl) + want,
                            ("o", "m", "l", "dq", "dk", "dv")):
        assert bool(torch.isfinite(a).all()), what
        _assert_rel_close(a, ref, rel, what)
    if qoff < koff:
        assert bool((m == sp.NEG_INF).all()) and bool((l == 0).all())
        assert bool((o == 0).all())


@pytest.mark.cuda
def test_cuda_flash_attention_grads_match_cpu():
    """The autograd.Function on the card against the same Function on the
    CPU, in f32 (1e-4: sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(11)
    cpu = [t.requires_grad_(True) for t in _t(*rand_qkv(rng, 2, 96, 96, 2,
                                                        32))]
    gpu = [t.detach().cuda().requires_grad_(True) for t in cpu]
    for ts in (cpu, gpu):
        torch.sin(fa.flash_attention(*ts, True)).sum().backward()
    for c, g in zip(cpu, gpu):
        torch.testing.assert_close(g.grad.cpu(), c.grad, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu():
    """One NCCL world of one on the card against the CPU trainer: losses
    and parameters after two steps (1e-4: sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    np_params = tree_util.tree_map(lambda t: t.numpy(), htt.init_params(
        _cfg(), torch.Generator().manual_seed(0), device="cpu"))
    runs = {}
    for dev in ("cpu", "cuda"):
        htt.init(device=dev)
        try:
            init_fn, step = htt.make_transformer_train_step(
                _cfg(), _sgd, device=dev)
            state = init_fn(htt.params_from_numpy(np_params, device=dev))
            losses = []
            for tokens, labels in _batches(2):
                state, loss = step(state, tokens, labels)
                losses.append(float(loss))
            runs[dev] = (losses, [t.detach().cpu() for t in
                                  tree_util.tree_leaves(state.params)])
        finally:
            htt.shutdown()
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the fused 1x1-conv + batch-norm kernels
# ---------------------------------------------------------------------------

CONV_CASES = [(147, 130, 70), (64, 32, 576), (401, 64, 256), (1000, 256, 64)]


def _conv_case(m, k, n, prologue, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=g, device="cuda") * k ** -0.5).to(dtype)
    inv = shift = None
    if prologue:
        inv = torch.rand((k,), generator=g, device="cuda") + 0.5
        shift = torch.randn((k,), generator=g, device="cuda") * 0.1
    dy = torch.randn((m, n), generator=g, device="cuda").to(dtype)
    ds1 = torch.randn((n,), generator=g, device="cuda") * 1e-2
    ds2 = torch.randn((n,), generator=g, device="cuda") * 1e-3
    return x, w, inv, shift, dy, ds1, ds2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("m,k,n", CONV_CASES)
def test_cuda_conv_bn_kernels_match_plain_versions(m, k, n, prologue, dtype,
                                                   rel):
    """Both conv+BN kernels against their plain versions on the card
    (ragged K and N included). Errors relative to the largest reference
    value: f32 sums in another order (1e-4); bf16 outputs rounded once to
    bf16 after them (1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from horovod_tpu_torch.ops import conv_bn as cb
    x, w, inv, shift, dy, ds1, ds2 = _conv_case(m, k, n, prologue, dtype)
    before = dict(cb.LAUNCHES)
    got = cb.conv_bn_fwd(x, w, inv, shift)
    gotb = cb.conv_bn_bwd(x, w, inv, shift, got[0], dy, ds1, ds2)
    torch.cuda.synchronize()
    assert cb.LAUNCHES == {kn: v + 1 for kn, v in before.items()}
    want = cb.conv1x1_bn_stats_plain(x, w, inv, shift)
    wantb = cb.conv1x1_bn_bwd_plain(x, w, inv, shift, got[0], dy, ds1, ds2)
    for a, ref, what in zip(got + gotb, want + wantb,
                            "y s1 s2 dx dw dinv dshift".split()):
        if ref is None:
            assert a is None, what
            continue
        assert a.dtype == ref.dtype and a.shape == ref.shape, what
        assert bool(torch.isfinite(a).all()), what
        _assert_rel_close(a.float(), ref.float(), rel, what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("cotangent", ["dy", "ds1", "ds2"])
def test_cuda_conv_bn_bwd_each_cotangent(cotangent, dtype, rel):
    """The backward kernel is linear in dy, ds1 and ds2: each alone, scaled
    so that its term of dy_eff = dy + ds1 + 2 ds2 y is as large as dy's,
    against the plain version (at training's scales ds1 and ds2 hide under
    dy's term within the bf16 tolerance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from horovod_tpu_torch.ops import conv_bn as cb
    x, w, inv, shift, dy, ds1, ds2 = _conv_case(401, 64, 256, True, dtype)
    zn = torch.zeros_like(ds1)
    cots = {"dy": (dy, zn, zn),
            "ds1": (torch.zeros_like(dy), ds1 * 100.0, zn),
            "ds2": (torch.zeros_like(dy), zn, ds2 * 500.0)}[cotangent]
    y = cb.conv_bn_fwd(x, w, inv, shift)[0]
    got = cb.conv_bn_bwd(x, w, inv, shift, y, *cots)
    want = cb.conv1x1_bn_bwd_plain(x, w, inv, shift, y, *cots)
    for a, ref, what in zip(got, want, "dx dw dinv dshift".split()):
        assert float(ref.float().abs().max()) > 1.0, what
        _assert_rel_close(a.float(), ref.float(), rel, what)


@pytest.mark.cuda
def test_cuda_fused_block_refuses_unsupported_dtype():
    """On the card a 1x1 conv the kernels' gate refuses (float16) raises;
    the fused block never routes it to a plain composition."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.models import resnet
    model = htt.ResNet(stage_sizes=[1], block_cls=resnet.BottleneckBlock,
                       num_classes=10, num_filters=8, dtype=torch.float16,
                       fused_conv_bn=True, device="cuda", seed=1)
    x = torch.zeros((2, 32, 32, 3), device="cuda")
    with pytest.raises(ValueError, match="do not take"):
        model(x, train=True)


@pytest.mark.cuda
@pytest.mark.parametrize("stride,prologue", [((1, 1), False),
                                             ((1, 1), True),
                                             ((2, 2), True)])
def test_cuda_conv1x1_bn_stats_grads_match_cpu(stride, prologue):
    """The public NHWC op with its autograd.Function on the card against
    the same op on the CPU (plain versions), f32, strided rows included:
    y, the sums and every gradient (1e-4 relative to the largest value)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.ops import conv_bn as cb
    rng = np.random.default_rng(12)
    arrays = [rng.standard_normal((3, 7, 7, 130)).astype(np.float32),
              (rng.standard_normal((130, 70)) * 0.1).astype(np.float32)]
    if prologue:
        arrays += [(rng.random(130) + 0.5).astype(np.float32),
                   (rng.standard_normal(130) * 0.1).astype(np.float32)]
    c1, c2 = _t(rng.standard_normal(70).astype(np.float32),
                (rng.standard_normal(70) * 0.01).astype(np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        ts = [t.to(dev).requires_grad_(True) for t in _t(*arrays)]
        y, s1, s2 = cb.conv1x1_bn_stats(ts[0], ts[1], *(ts[2:] or [None,
                                                                   None]),
                                        strides=stride)
        loss = ((y * y).sum() * 0.5 + (s1 * c1.to(dev)).sum()
                + (s2 * c2.to(dev)).sum())
        grads = torch.autograd.grad(loss, ts)
        outs[dev] = [t.detach().cpu() for t in (y, s1, s2) + grads]
    for a, ref in zip(outs["cuda"], outs["cpu"]):
        _assert_rel_close(a, ref, 1e-4, "conv1x1_bn_stats")


@pytest.mark.cuda
def test_cuda_conv_bn_sums_are_deterministic():
    """Two runs give bitwise-equal s1, s2, dW, d_inv and d_shift: partial
    rows and split-M partials are added in a fixed order (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.ops import conv_bn as cb
    x, w, inv, shift, dy, ds1, ds2 = _conv_case(50000, 64, 256, True,
                                                torch.bfloat16, seed=3)
    runs = []
    for _ in range(2):
        y, s1, s2 = cb.conv_bn_fwd(x, w, inv, shift)
        _, dw, dinv, dshift = cb.conv_bn_bwd(x, w, inv, shift, y, dy, ds1,
                                             ds2)
        runs.append((s1, s2, dw, dinv, dshift))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_resnet_train_step_matches_cpu():
    """A small f32 fused ResNet trained by data_parallel_train_step and
    DistributedOptimizer for two steps in an NCCL world of one against the
    gloo CPU world: losses and parameters (1e-4: convolutions and sums in
    other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.nn.functional as F
    from horovod_tpu_torch.models import resnet
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(13)
    batches = [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, (4,))) for _ in range(2)]
    runs = {}
    for dev in ("cpu", "cuda"):
        htt.init(device=dev)
        try:
            model = htt.ResNet(stage_sizes=[1, 1],
                               block_cls=resnet.BottleneckBlock,
                               num_classes=10, num_filters=8,
                               dtype=torch.float32, fused_conv_bn=True,
                               device=dev, seed=1)
            opt = htt.DistributedOptimizer(torch.optim.SGD(
                model.parameters(), lr=0.01, momentum=0.9))
            init_fn, step, put_batch = htt.data_parallel_train_step(
                lambda m, x, y: F.cross_entropy(m(x, train=True), y), opt,
                device=dev)
            state = init_fn(model)
            losses = []
            for b in batches:
                state, loss = step(state, *put_batch(b))
                losses.append(float(loss))
            runs[dev] = (losses, [p.detach().cpu()
                                  for p in model.parameters()])
        finally:
            htt.shutdown()
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        _assert_rel_close(a, b, 1e-4, "parameter")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.uint8])
@pytest.mark.parametrize("shape,rows_per_cta", [
    ((4096, 1024), None),             # the probe's rows, fewer of them
    ((1000, 37), 3),                  # rows not a multiple of 16 bytes
    ((777, 129), 64),                 # ragged last CTA
    ((3, 5, 7), 1),
    ((1,), 1),
])
def test_cuda_stream_copy_bit_equal(dtype, shape, rows_per_cta):
    """The stream-copy kernel equals its plain version (out.copy_(x)) bit
    for bit, and counts one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.ops import stream_copy as sc
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                      generator=g)
    if dtype != torch.uint8:
        x = torch.randn(shape, device="cuda", generator=g).to(dtype)
    want = sc.stream_copy_plain(x, torch.empty_like(x))
    sc.reset_launches()
    got = sc.stream_copy(x, rows_per_cta=rows_per_cta)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["stream_copy"] == 1
    bits = torch.int16 if dtype == torch.bfloat16 else (
        torch.int32 if dtype == torch.float32 else torch.uint8)
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("src_off,dst_off", [(1, 1), (3, 7), (0, 8),
                                             (16, 5), (5, 0)])
def test_cuda_stream_copy_misaligned(src_off, dst_off):
    """Views that start 1..15 bytes off a 16-byte boundary: co-aligned
    pairs take the scalar head, the vector body and a tail; others copy
    byte by byte. The bytes around the destination stay untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.ops import stream_copy as sc
    g = torch.Generator(device="cuda").manual_seed(8)
    base = torch.randint(0, 256, (1 << 18,), dtype=torch.uint8,
                         device="cuda", generator=g)
    dst = torch.zeros(1 << 18, dtype=torch.uint8, device="cuda")
    n = 100000
    xs = base[src_off:src_off + n].view(1000, 100)
    ds = dst[dst_off:dst_off + n].view(1000, 100)
    sc.stream_copy(xs, ds, rows_per_cta=7)
    torch.cuda.synchronize()
    assert torch.equal(ds, xs)
    assert not dst[:dst_off].any() and not dst[dst_off + n:].any()


@pytest.mark.cuda
def test_cuda_stream_copy_raises_rather_than_falling_back(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: with the
    build failing it raises, and the plain version is never taken."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.ops import stream_copy as sc

    def no_build(*args):
        raise RuntimeError("kernel build failed")

    def no_plain(*args):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(sc, "launch", no_build)
    monkeypatch.setattr(sc, "stream_copy_plain", no_plain)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        sc.stream_copy(torch.ones(4, 4, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["none", "bf16", "fp8_e4m3"])
def test_cuda_bucketed_sync_on_a_world_of_one(tier):
    """DistributedOptimizer with small buckets in an NCCL world of one:
    every bucket launched from the hooks on the side stream, the synced
    gradients equal to the gradients through the wire tier, and with fp8
    the gradient equal to the decode plus the residual."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.config import knobs
    knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", tier)
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", 4096)
    htt.init()
    try:
        g = torch.Generator(device="cuda").manual_seed(9)
        ps = [torch.randn(300 + i, device="cuda", generator=g,
                          requires_grad=True) for i in range(6)]
        opt = htt.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1))
        sum((p * p).sum() for p in ps).backward()
        want = [2 * p.detach() for p in ps]
        assert all(hook for _, hook in opt.launch_log)
        opt.synchronize()
        torch.cuda.synchronize()
        assert len(opt.launch_log) == len(opt.buckets) > 1
        for i, (p, w) in enumerate(zip(ps, want)):
            if tier == "none":
                assert torch.equal(p.grad, w)
            elif tier == "bf16":
                assert torch.equal(p.grad, w.bfloat16().float())
            else:
                r = opt.wire_state.residual[i]
                _assert_rel_close(p.grad + r, w, 1e-6, "decode + residual")
    finally:
        htt.shutdown()
        knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
        knobs.clear_override("HOROVOD_GRADIENT_BUCKET_BYTES")


@pytest.mark.cuda
def test_cuda_fused_local_step_matches_unfused(monkeypatch):
    """``dp_axis=None``: every leaf is local, so the fused step's one
    bucket has no collective to wait on; its pack runs on the side stream,
    held back here by a sleep queued there before each launch. The
    epilogue must still read the packed gradients: three steps against the
    unfused step, losses and parameters within 1e-5 (EpilogueSGD's
    ``p - lr * m`` and torch.optim.SGD's ``p + (-lr) * m`` round in the
    last bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel import distributed as D
    torch.backends.cuda.matmul.allow_tf32 = False
    real = D._GradSync.launch

    def held_back(self, *args, **kw):
        torch.cuda._sleep(50_000_000)      # tens of ms on the side stream
        return real(self, *args, **kw)

    monkeypatch.setattr(D._GradSync, "launch", held_back)
    cfg = htt.TransformerConfig(**{**CFG_KW, "dp_axis": None})
    np_params = tree_util.tree_map(lambda t: t.numpy(), htt.init_params(
        cfg, torch.Generator().manual_seed(2), device="cpu"))
    runs = []
    for fused in (False, True):
        if fused:
            da = htt.distributed_apply(htt.EpilogueSGD(0.01, momentum=0.9),
                                       sync_axes=tfm.grad_sync_axes(cfg))
            init_fn, step = htt.make_transformer_train_step_fused(
                cfg, da, device="cuda")
        else:
            init_fn, step = htt.make_transformer_train_step(cfg, _sgd,
                                                            device="cuda")
        state = init_fn(htt.params_from_numpy(np_params, device="cuda"))
        losses = []
        for tokens, labels in _batches(3):
            state, loss = step(state, tokens, labels)
            losses.append(float(loss))
        runs.append((losses, [t.detach().cpu() for t in
                              tree_util.tree_leaves(state.params)]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    for a, b in zip(runs[1][1], runs[0][1]):
        _assert_rel_close(a, b, 1e-5, "parameter after 3 steps")
