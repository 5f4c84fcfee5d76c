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
    (torch.bfloat16, 40, 1e-2),       # tensor cores, padding inside a k16
    (torch.bfloat16, 96, 1e-4),       # FMA kernels (D > 64)
])
@pytest.mark.parametrize("b,h,sq,sk,qoff,koff,causal", [
    (2, 3, 256, 256, 0, 0, True),     # the training geometry
    (2, 3, 200, 328, 0, 0, False),    # ragged S on both sides
    (2, 3, 1000, 1000, 0, 0, True),   # ragged S, causal
    (2, 3, 128, 128, 0, 128, True),   # fully masked K block
    (2, 3, 128, 128, 256, 128, True), # K block behind Q
    (2, 3, 129, 129, 0, 0, True),     # one row past a 128-row block
    (2, 3, 129, 1000, 0, 0, False),   # ragged, Sq != Sk
    (2, 3, 1000, 129, 0, 0, True),
    (2, 3, 256, 256, 96, 32, True),   # offsets off the 64/128 tiles
    (2, 3, 256, 256, 32, 96, True),   # ... with rows that see no key
    (8, 16, 256, 256, 0, 0, True),    # B * H = 128
])
def test_cuda_kernels_match_plain_versions(dtype, d, rel, b, h, sq, sk, qoff,
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
    q, k, v, do = _cuda_case(rng, b, sq, sk, h, d, dtype)
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
    blind = qoff + torch.arange(sq, device=q.device) < koff  # see no key
    if causal and bool(blind.any()):
        assert bool((m[..., blind] == sp.NEG_INF).all())
        assert bool((l[..., blind] == 0).all())
        assert bool((o[:, blind] == 0).all()) and bool((got[0][:, blind] == 0
                                                        ).all())


def _bwd_inputs(rng, b, sq, sk, h, d, dtype, qoff, koff, causal):
    """Inputs of the backward pair, with lse from the plain forward."""
    q, k, v, do = _cuda_case(rng, b, sq, sk, h, d, dtype)
    _, rm, rl = sp._block_attend(q.float(), k.float(), v.float(), qoff, koff,
                                 causal, d ** -0.5)
    lse = rm + torch.log(rl.clamp_min(1e-30))
    dD = torch.from_numpy(rng.standard_normal(lse.shape).astype(
        np.float32)).cuda()
    return q, k, v, do, lse, dD


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 40),
                                     (torch.float32, 64)])
def test_cuda_flash_bwd_is_bitwise_repeatable(dtype, d):
    """Two launches of each backward kernel on the same inputs give
    bitwise-equal dq, dk and dv: every sum stays inside one block, in a
    fixed order (no float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(12)
    args = _bwd_inputs(rng, 2, 1000, 1000, 4, d, dtype, 0, 0, True)
    runs = [fa.flash_bwd_block(*args, 0, 0, True, d ** -0.5)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b, what in zip(*runs, ("dq", "dk", "dv")):
        assert torch.equal(a, b), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk,qoff,koff", [(256, 256, 32, 96),
                                             (200, 200, 0, 100),
                                             (129, 129, 0, 64)])
def test_cuda_flash_bwd_masked_rows_and_keys_are_exact_zeros(
        dtype, sq, sk, qoff, koff):
    """Causal, K block partly after Q: a q row that sees no key gets
    dq == 0 exactly, and a key that no q row sees gets dk == dv == 0
    exactly (nothing of them is computed as a small number)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(14)
    d = 64
    args = _bwd_inputs(rng, 2, sq, sk, 3, d, dtype, qoff, koff, True)
    dq, dk, dv = fa.flash_bwd_block(*args, qoff, koff, True, d ** -0.5)
    torch.cuda.synchronize()
    blind_rows = qoff + np.arange(sq) < koff           # see no key
    unseen_keys = koff + np.arange(sk) > qoff + sq - 1  # seen by no row
    assert blind_rows.any() and unseen_keys.any()
    assert bool((dq[:, torch.from_numpy(blind_rows).cuda()] == 0).all())
    for g, what in ((dk, "dk"), (dv, "dv")):
        assert bool((g[:, torch.from_numpy(unseen_keys).cuda()] == 0).all()), \
            what
    seen = torch.from_numpy(~unseen_keys).cuda()
    assert bool((dv[:, seen] != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_fwd_many_tiles(causal):
    """The forward over 32 K tiles a block (S = 4096, 128-key tiles): the
    4-stage K/V ring of the tensor-core route wraps seven times. o, m, l
    against the plain version, 1e-2 relative to the largest reference
    value (p enters its product rounded to bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(15)
    q, k, v, _ = _cuda_case(rng, 1, 4096, 4096, 4, 64, torch.bfloat16)
    got = fa.flash_block_attend(q, k, v, 0, 0, causal, 0.125)
    torch.cuda.synchronize()
    want = sp._block_attend(q.float(), k.float(), v.float(), 0, 0, causal,
                            0.125)
    for a, ref, what in zip(got, want, "oml"):
        assert bool(torch.isfinite(a).all()), what
        _assert_rel_close(a, ref, 1e-2, what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 40),
                                     (torch.float32, 64)])
def test_cuda_flash_fwd_is_bitwise_repeatable(dtype, d):
    """Two launches of the forward on the same inputs give bitwise-equal
    o, m and l: every sum stays inside one block, in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(16)
    q, k, v, _ = _cuda_case(rng, 2, 1000, 1000, 4, d, dtype)
    runs = [fa.flash_block_attend(q, k, v, 0, 0, True, d ** -0.5)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b, what in zip(*runs, "oml"):
        assert torch.equal(a, b), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk,qoff,koff", [(256, 256, 32, 96),
                                             (200, 200, 0, 100),
                                             (129, 129, 0, 64)])
def test_cuda_flash_fwd_masked_rows_are_exact_zeros(dtype, sq, sk, qoff,
                                                    koff):
    """Causal, K block partly after Q: a q row that sees no key gives
    m = -1e30, l = 0 and o = 0 exactly; every other row has l > 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(17)
    q, k, v, _ = _cuda_case(rng, 2, sq, sk, 3, 64, dtype)
    o, m, l = fa.flash_block_attend(q, k, v, qoff, koff, True, 0.125)
    torch.cuda.synchronize()
    blind = torch.from_numpy(qoff + np.arange(sq) < koff).cuda()
    assert bool(blind.any()) and not bool(blind.all())
    assert bool((m[..., blind] == sp.NEG_INF).all())
    assert bool((l[..., blind] == 0).all())
    assert bool((o[:, blind] == 0).all())
    assert bool((l[..., ~blind] > 0).all())


# ---------------------------------------------------------------------------
# the paged-decode kernel
# ---------------------------------------------------------------------------

def _paged_inputs(g, b, h, kvh, d, page, n_max, lengths, dtype):
    """Pool of b * n_max + 1 pages, a random block table, the lengths;
    and the table with every entry at or past a sequence's length set to
    a page index far out of the pool."""
    dev = torch.device("cuda")
    n_pages = b * n_max
    shape = (n_pages + 1, page, kvh, d)
    kp = torch.randn(shape, generator=g, device=dev).to(dtype)
    vp = torch.randn(shape, generator=g, device=dev).to(dtype)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    bt = torch.randperm(n_pages, generator=g, device=dev).reshape(
        b, n_max).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    used = (torch.arange(n_max, device=dev)[None, :] * page
            < ln.clamp(0, n_max * page)[:, None])
    far = torch.where(used, bt, torch.full_like(bt, 1 << 30))
    return q, kp, vp, bt, far, ln


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (8, 1)])   # G 1, 4, 8
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_paged_decode_matches_plain_version(dtype, tol, h, kvh, page,
                                                 d):
    """The kernel against ``paged_attention_reference`` (tolerance as in
    chip_smoke.py: bf16 2e-2, f32 1e-5) at lengths 0, 1, page - 1, page,
    chunk - 1, chunk, chunk + 1, n_max * page and past it (clamped), with
    the block-table entries past each length pointing far out of the pool,
    which would fault if they were read. One launch counted per call; the
    empty slot exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.serving import kv_cache as kvc
    chunk = fa.PAGED_CHUNK
    n_max = -(-(chunk + 1) // page) + 2
    n_ctx = n_max * page
    lengths = [0, 1, page - 1, page, chunk - 1, chunk, chunk + 1, n_ctx,
               n_ctx + 37]
    g = torch.Generator(device="cuda").manual_seed(d + page + h)
    q, kp, vp, bt, far, ln = _paged_inputs(g, len(lengths), h, kvh, d, page,
                                           n_max, lengths, dtype)
    before = fa.LAUNCHES["paged_decode"]
    out = fa.flash_paged_decode(q, kp, vp, far, ln, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["paged_decode"] == before + 1
    ref = kvc.paged_attention_reference(q, kp, vp, bt, ln, d ** -0.5)
    assert bool((out[0] == 0).all())
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kvh", [16, 4])
def test_cuda_paged_decode_timed_geometry(dtype, tol, kvh):
    """chip_smoke.py's timed geometry: B=8, H=16, D=64, page 128, n_max
    16, lengths [1, 2048, 300, 0, 1024, 1537, 128, 777] (slot 3 empty)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.serving import kv_cache as kvc
    lengths = [1, 2048, 300, 0, 1024, 1537, 128, 777]
    g = torch.Generator(device="cuda").manual_seed(kvh)
    q, kp, vp, bt, far, ln = _paged_inputs(g, 8, 16, kvh, 64, 128, 16,
                                           lengths, dtype)
    out = fa.flash_paged_decode(q, kp, vp, far, ln, 0.125)
    torch.cuda.synchronize()
    ref = kvc.paged_attention_reference(q, kp, vp, bt, ln, 0.125)
    assert bool((out[3] == 0).all())
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_paged_decode_is_bitwise_repeatable(dtype):
    """Two calls on the same inputs give bitwise-equal outputs: the chunks
    of a sequence merge in chunk order, with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    lengths = [2048, 777, 0, 1537]
    g = torch.Generator(device="cuda").manual_seed(3)
    q, kp, vp, bt, _, ln = _paged_inputs(g, 4, 16, 4, 64, 128, 16, lengths,
                                         dtype)
    runs = [fa.flash_paged_decode(q, kp, vp, bt, ln, 0.125)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


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


# Every distinct (K, N, prologue) of ResNet-50's 1x1 convs: stages 1 and
# 2's first block take the fused wgmma route, the rest the split one.
RESNET50_KN = [(64, 64, False), (64, 256, False), (256, 64, False),
               (64, 256, True), (256, 128, False), (256, 512, False),
               (512, 128, False), (128, 512, True), (512, 256, False),
               (512, 1024, False), (1024, 256, False), (256, 1024, True),
               (1024, 512, False), (1024, 2048, False), (2048, 512, False),
               (512, 2048, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,prologue", RESNET50_KN)
def test_cuda_conv_bn_bwd_wgmma_routes_each_cotangent(k, n, prologue):
    """The wgmma backward at every ResNet-50 (K, N) at a reduced M (461
    rows: 7 tiles of 64 and a ragged one), bf16: each cotangent alone
    (scaled so that its term of dy_eff is as large as dy's) and the three
    together against the plain version (1e-2 of the largest value: bf16
    outputs after f32 sums in another order), two runs bit-equal, one
    launch counted on the route bwd_plan names and none on another."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from horovod_tpu_torch.ops import conv_bn as cb
    m = 461
    x, w, inv, shift, dy, ds1, ds2 = _conv_case(m, k, n, prologue,
                                                torch.bfloat16, seed=k + n)
    route = cb.bwd_plan(m, k, n, torch.bfloat16, prologue).route
    assert route == ("fused" if (k, n) in ((64, 64), (64, 256), (256, 64),
                                           (256, 128)) else "split")
    y = cb.conv_bn_fwd(x, w, inv, shift)[0]
    zdy, zn = torch.zeros_like(dy), torch.zeros_like(ds1)
    cots = {"dy": (dy, zn, zn), "ds1": (zdy, ds1 * 100.0, zn),
            "ds2": (zdy, zn, ds2 * 500.0), "all": (dy, ds1, ds2)}
    for cot, args in cots.items():
        cb.reset_launches()
        got = cb.conv_bn_bwd(x, w, inv, shift, y, *args)
        torch.cuda.synchronize()
        assert cb.BWD_ROUTES == {r: int(r == route) for r in cb.BWD_ROUTES}
        want = cb.conv1x1_bn_bwd_plain(x, w, inv, shift, y, *args)
        for a, ref, what in zip(got, want, "dx dw dinv dshift".split()):
            if ref is None:
                assert a is None, what
                continue
            assert a.dtype == ref.dtype and a.shape == ref.shape, what
            _assert_rel_close(a.float(), ref.float(), 1e-2, f"{cot} {what}")
    again = cb.conv_bn_bwd(x, w, inv, shift, y, dy, ds1, ds2)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert a is None or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,prologue,route", [
    (461, 72, 40, True, "fused"),      # K, N multiples of 8, not of 64
    (461, 8, 8, False, "fused"),
    (1, 64, 64, True, "fused"),        # one row
    (5000, 64, 256, True, "fused"),    # many tiles a block
    (130, 520, 200, True, "split"),    # ragged boxes in every slice
    (147, 130, 70, True, "mma"),       # K, N not multiples of 8
])
def test_cuda_conv_bn_bwd_routes_at_edges(m, k, n, prologue, route):
    """Ragged shapes on each route, bf16, against the plain version (the
    three cotangents together, 1e-2 of the largest value)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from horovod_tpu_torch.ops import conv_bn as cb
    x, w, inv, shift, dy, ds1, ds2 = _conv_case(m, k, n, prologue,
                                                torch.bfloat16, seed=m)
    assert cb.bwd_plan(m, k, n, torch.bfloat16, prologue).route == route
    y = cb.conv_bn_fwd(x, w, inv, shift)[0]
    cb.reset_launches()
    got = cb.conv_bn_bwd(x, w, inv, shift, y, dy, ds1, ds2)
    torch.cuda.synchronize()
    assert cb.BWD_ROUTES[route] == 1 and sum(cb.BWD_ROUTES.values()) == 1
    want = cb.conv1x1_bn_bwd_plain(x, w, inv, shift, y, dy, ds1, ds2)
    for a, ref, what in zip(got, want, "dx dw dinv dshift".split()):
        if ref is not None:
            _assert_rel_close(a.float(), ref.float(), 1e-2, what)


def _check_fwd(cb, x, w, inv, shift, what):
    """The forward on the card against its plain version (1e-2 of each
    output's largest value: y rounded once to bf16 after f32 sums in
    another order, s1 and s2 f32 sums in another order); two runs
    bit-equal."""
    got = cb.conv_bn_fwd(x, w, inv, shift)
    again = cb.conv_bn_fwd(x, w, inv, shift)
    torch.cuda.synchronize()
    want = cb.conv1x1_bn_stats_plain(x, w, inv, shift)
    for a, ref, nm in zip(got, want, ("y", "s1", "s2")):
        assert a.dtype == ref.dtype and a.shape == ref.shape, f"{what} {nm}"
        assert bool(torch.isfinite(a).all()), f"{what} {nm}"
        _assert_rel_close(a.float(), ref.float(), 1e-2, f"{what} {nm}")
    for a, b in zip(got, again):
        assert torch.equal(a, b), f"{what}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,prologue", RESNET50_KN)
def test_cuda_conv_bn_fwd_wgmma_route_at_resnet50_shapes(k, n, prologue):
    """The wgmma forward at every ResNet-50 (K, N) at a reduced M (461
    rows: off the 128- and 256-row tiles), bf16, against the plain
    version, two runs bit-equal, one launch counted on the wgmma route and
    none on the mma route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from horovod_tpu_torch.ops import conv_bn as cb
    m = 461
    x, w, inv, shift, *_ = _conv_case(m, k, n, prologue, torch.bfloat16,
                                      seed=k + n)
    assert cb.fwd_plan(m, k, n, torch.bfloat16, prologue).route == "wgmma"
    cb.reset_launches()
    cb.conv_bn_fwd(x, w, inv, shift)
    torch.cuda.synchronize()
    assert cb.FWD_ROUTES == {"wgmma": 1, "mma": 0}
    assert cb.LAUNCHES["conv_bn_fwd"] == 1
    _check_fwd(cb, x, w, inv, shift, f"{k}->{n}")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,prologue", [
    (461, 64, 256, True),      # M off the 128-row tile: masked-row sums
    (6273, 64, 256, True),     # the same over many tiles a block
    (6273, 128, 128, True),    # 256 x 128 tiles, M off them
    (6273, 64, 64, True),      # 256 x 64 tiles, M off them
    (461, 72, 256, True),      # K off the 64-wide box: guarded columns
    (461, 72, 40, True),       # N = 40: one partial box of W and of y
    (461, 64, 72, False),      # N = 72: 128-wide tile, 56 columns past N
    (461, 64, 576, True),      # N = 576: a last tile 64 of 256 wide
    (461, 512, 2048, True),    # N = 2048: 8 column tiles
    (461, 2048, 512, False),   # K = 2048: 32 K chunks a tile
    (1, 64, 64, True),         # one row
    (461, 8, 8, False),        # one box narrower than 16 bytes a row
])
def test_cuda_conv_bn_fwd_wgmma_route_at_edges(m, k, n, prologue):
    """Ragged shapes on the wgmma forward against the plain version, two
    runs bit-equal. With the prologue the rows past M that TMA fills with
    zeros would be relu(shift) . W: the sums must count them zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from horovod_tpu_torch.ops import conv_bn as cb
    x, w, inv, shift, *_ = _conv_case(m, k, n, prologue, torch.bfloat16,
                                      seed=m + k + n)
    assert cb.fwd_plan(m, k, n, torch.bfloat16, prologue).route == "wgmma"
    if prologue:
        shift = shift.abs() + 0.5    # relu(shift) . W far from zero
    _check_fwd(cb, x, w, inv, shift, f"M={m} {k}->{n}")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype", [(147, 130, 70, torch.bfloat16),
                                         (461, 64, 256, torch.float32)])
def test_cuda_conv_bn_fwd_mma_route_counts(m, k, n, dtype):
    """Ragged bf16 and f32 shapes take PR 3's mma forward, counted on its
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from horovod_tpu_torch.ops import conv_bn as cb
    x, w, inv, shift, *_ = _conv_case(m, k, n, True, dtype, seed=m)
    cb.reset_launches()
    got = cb.conv_bn_fwd(x, w, inv, shift)
    torch.cuda.synchronize()
    assert cb.FWD_ROUTES == {"wgmma": 0, "mma": 1}
    want = cb.conv1x1_bn_stats_plain(x, w, inv, shift)
    rel = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for a, ref, nm in zip(got, want, ("y", "s1", "s2")):
        _assert_rel_close(a.float(), ref.float(), rel, nm)


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
    ((16384, 1024), 1), ((16384, 1024), 4),   # the probe's tiles, more
    ((16384, 1024), 16), ((16384, 1024), 64),  # chunks than blocks
    ((300, 10000), 2),                # chunks of 20,000 to 80,000 bytes,
    ((4097, 1000), 5),                # ragged last chunk
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


@pytest.fixture(scope="module")
def wgmma_probe(tmp_path_factory):
    """tests/cuda/wgmma_rs_probe.cu built with the kernels' nvcc flags
    against csrc/sm90_common.cuh, loaded."""
    import ctypes
    import subprocess
    from pathlib import Path
    from horovod_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    src = Path(__file__).resolve().parent / "cuda" / "wgmma_rs_probe.cu"
    lib_path = tmp_path_factory.mktemp("probe") / "libwgmma_rs_probe.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.hvd_wgmma_rs_probe.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                       + [ctypes.c_int, ctypes.c_float,
                                          ctypes.c_void_p])
    return lib


def _wgmma_rs_probe(lib, mode, n_tiles, seed=0):
    """Runs the probe in ``mode`` over ``n_tiles`` tiles and the same
    chain in PyTorch. Returns (out, ref), f32 [192, 64]."""
    import math
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x, y = (torch.randn(192, 64, generator=g, device=dev).bfloat16()
            for _ in range(2))
    k, v = (torch.randn(64 * n_tiles, 64, generator=g, device=dev).bfloat16()
            for _ in range(2))
    scale2 = 0.125 * math.log2(math.e)
    s_full = x.float() @ k.float().T
    lse2 = torch.logsumexp(s_full * scale2 * math.log(2), dim=1) / math.log(2)
    dd = torch.randn(192, generator=g, device=dev)
    out = torch.full((192, 64), float("nan"), device=dev)
    err = lib.hvd_wgmma_rs_probe(mode, x.data_ptr(), y.data_ptr(),
                                 k.data_ptr(), v.data_ptr(), lse2.data_ptr(),
                                 dd.data_ptr(), out.data_ptr(), n_tiles,
                                 scale2, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"probe launch failed: cudaError {err}"
    # Warpgroup wg (rows 64 wg ..) multiplies tiles t < n_tiles - 2 + wg.
    wg = torch.arange(192, device=dev) // 64
    ref = torch.zeros(192, 64, device=dev)
    for t in range(n_tiles):
        kt = k[64 * t:64 * t + 64].float()
        vt = v[64 * t:64 * t + 64].float()
        ds = torch.exp2((x.float() @ kt.T) * scale2 - lse2[:, None]) * (
            y.float() @ vt.T - dd[:, None])
        ref += torch.where((wg >= t - n_tiles + 3)[:, None],
                           ds.bfloat16().float() @ kt, 0.0)
    torch.cuda.synchronize()
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [1, 2, 3, 32])
def test_cuda_wgmma_rs_probe_matches_torch(wgmma_probe, n_tiles):
    """The sm90_common.cuh helpers in the flash kernels' pattern: register
    A fragments (x, y, then the packed ds) built inside the iteration that
    multiplies them, products in a per-warpgroup branch, K-major and
    MN-major descriptors over one swizzled tile, over 1 to 32 tiles.
    Tolerance as the bf16 flash kernels: 1e-2 relative (ds enters its
    product rounded to bf16 in both)."""
    out, ref = _wgmma_rs_probe(wgmma_probe, 0, n_tiles)
    _assert_rel_close(out, ref, 1e-2, f"probe, {n_tiles} tiles")


@pytest.mark.cuda
def test_cuda_wgmma_rs_carried_a_fragment_is_miscompiled(wgmma_probe):
    """The same chain with the x and y fragments loaded once and carried
    across iterations gives wrong results from the second tile on: ptxas
    of CUDA 12.9 reuses their registers (see the probe's note). This
    holds the rule in sm90_common.cuh that no kernel carries a register A
    fragment across iterations; when it fails, the toolkit no longer
    miscompiles the pattern and the rule can be revisited."""
    out, ref = _wgmma_rs_probe(wgmma_probe, 1, 1)
    _assert_rel_close(out, ref, 1e-2, "carried fragments, 1 tile")
    out, ref = _wgmma_rs_probe(wgmma_probe, 1, 3)
    err = float((out - ref).abs().max())
    assert err > 1e-2 * max(1.0, float(ref.abs().max())), (
        "carried register A fragments now give right results")


# ---------------------------------------------------------------------------
# the collectives on NCCL: a world of one, and two cards where there are
# two. Data movement, integer sums and MIN/MAX are compared exactly; the
# f32 sums of two ranks too (a + b is the same in either order).
# ---------------------------------------------------------------------------

def _collectives_of_one(dev):
    """Every new collective in a world of one on ``dev``, each against its
    plain result; returns the names checked."""
    from horovod_tpu_torch.ops import collectives as C
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(6, 3, device=dev, generator=g)
    xi = torch.randint(-9, 9, (5, 2), device=dev, generator=g,
                       dtype=torch.int32)
    checks = {
        "allgather": (C.allgather(x), x),
        "alltoall": (C.alltoall(x), x),
        "alltoall_splits": (C.alltoall(x, splits=[6])[0], x),
        "reducescatter": (C.reducescatter(x, htt.Sum), x),
        "reducescatter_uneven_int": (C.reducescatter(xi, htt.Sum), xi),
        "reducescatter_max": (C.reducescatter(x, htt.Max), x),
        "ppermute": (C.ppermute(x, [(0, 0)]), x),
        "broadcast": (C.broadcast(x, 0), x),
        "allreduce_min": (C.allreduce(x, htt.Min), x),
        "bf16_allgather": (C.allgather(x.bfloat16()), x.bfloat16()),
    }
    dense, counts = htt.sparse_allreduce(x[:2], torch.tensor(
        [1, 1], device=dev), 4, average=False)
    want = torch.zeros(4, 3, device=dev)
    want[1] = x[0] + x[1]
    checks["sparse_allreduce"] = (dense, want)
    checks["sparse_counts"] = (counts, torch.tensor(
        [0, 2, 0, 0], dtype=torch.int32, device=dev))
    for name, (got, ref) in checks.items():
        assert got.device == ref.device and got.dtype == ref.dtype, name
        assert torch.equal(got, ref), name
    return sorted(checks)


@pytest.mark.cuda
def test_cuda_collectives_in_a_world_of_one():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.compression import WireCodec
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.runtime import get_context
    htt.init(mesh_shape=(1, 1), axis_names=("hvd_cross", "hvd_local"))
    try:
        assert get_context().backend == "nccl"
        names = _collectives_of_one(torch.device("cuda"))
        assert "alltoall_splits" in names
        x = torch.randn(7, 3, device="cuda")
        assert torch.equal(C.hierarchical_allreduce(x[:6]), x[:6])
        two = C.two_level_allreduce(x, htt.Average, ici_axes=("hvd_local",),
                                    dcn_axis="hvd_cross")
        assert torch.equal(two, x)
        fp8 = C.two_level_allreduce(x, htt.Sum, ici_axes=("hvd_local",),
                                    dcn_axis="hvd_cross",
                                    wire_codec=WireCodec("fp8_e4m3"))
        codec = WireCodec("fp8_e4m3")
        wire, scale = codec.encode(x, world=1)
        assert torch.equal(fp8, codec.decode(wire, scale, x.dtype))
    finally:
        htt.shutdown()


def _two_card_worker(rank, world, port, out):
    import os
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops import collectives as C
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    knobs.set_override("HOROVOD_DCN_VIRTUAL_SLICES", 2)
    htt.init()
    try:
        from horovod_tpu_torch.runtime import get_context
        dev = get_context().device
        rows = torch.full((rank + 1, 2), float(rank), device=dev)
        res = {"allgather": C.allgather(rows).cpu()}
        part = torch.arange(3 * (rank + 1), device=dev,
                            dtype=torch.float32).reshape(-1, 1) + 10 * rank
        splits = [1, 2] if rank == 0 else [4, 2]
        a2a, recv = C.alltoall(part, splits=splits)
        res["alltoall"], res["recv"] = a2a.cpu(), recv
        g = torch.Generator(device=dev).manual_seed(rank)
        x = torch.randn(7, 3, device=dev, generator=g)
        res["two_level"] = C.two_level_allreduce(
            x, htt.Sum, ici_axes=("hvd_local",)).cpu()
        res["flat"] = C.allreduce(x, htt.Sum).cpu()
        res["x"] = x.cpu()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        htt.shutdown()


@pytest.mark.cuda
def test_cuda_collectives_on_two_cards(tmp_path):
    """allgather of uneven rows, alltoall(splits=) and the two-level
    allreduce (hvd_dcn 2 x hvd_local 1) in an NCCL world of two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(_two_card_worker,
                                args=(2, port, str(tmp_path)), nprocs=2)
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    want_ag = torch.cat([torch.full((r + 1, 2), float(r)) for r in range(2)])
    parts = [torch.arange(3 * (r + 1), dtype=torch.float32).reshape(-1, 1)
             + 10 * r for r in range(2)]
    sends = [parts[0].split([1, 2]), parts[1].split([4, 2])]
    total = res[0]["x"] + res[1]["x"]
    for r in range(2):
        assert torch.equal(res[r]["allgather"], want_ag)
        assert torch.equal(res[r]["alltoall"],
                           torch.cat([sends[0][r], sends[1][r]]))
        assert res[r]["recv"].tolist() == [[1, 4], [2, 2]][r]
        assert torch.equal(res[r]["two_level"], total)
        assert torch.equal(res[r]["flat"], total)


@pytest.mark.cuda
def test_cuda_snapshot_after_fused_step_is_not_torn(monkeypatch):
    """The checkpoint's device->host copy of a fused fp8 step's state
    (parameters, momentum, error-feedback residual), issued right after
    the step returns, must see the epilogue's updates and the residual
    writes of the side stream (both held back here by a sleep queued on
    the side stream before each bucket launch), and must not see the next
    step's, which is queued right behind it: bitwise equal to clones
    queued on the same stream at the same point."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel import distributed as D
    from horovod_tpu_torch.resilience import async_checkpoint as ac
    real = D._GradSync.launch

    def held_back(self, *args, **kw):
        torch.cuda._sleep(50_000_000)      # tens of ms on the side stream
        return real(self, *args, **kw)

    monkeypatch.setattr(D._GradSync, "launch", held_back)
    knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    htt.init()
    try:
        cfg = _cfg()
        da = htt.distributed_apply(htt.EpilogueSGD(0.01, momentum=0.9),
                                   sync_axes=tfm.grad_sync_axes(cfg))
        init_fn, step = htt.make_transformer_train_step_fused(
            cfg, da, device="cuda")
        state = init_fn(htt.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda"))
        batches = _batches(3)
        state, _ = step(state, *batches[0])
        state, _ = step(state, *batches[1])
        def leaves(st):
            return [t for tree in (st.params, st.opt_state.opt.slots[0],
                                   st.opt_state.residual)
                    for t in tree_util.tree_leaves(tree)]

        host, events = ac._snapshot(state, True)
        ref = [t.clone() for t in leaves(state)]
        state, _ = step(state, *batches[2])          # queued behind the copy
        for _, end in events:
            end.synchronize()
        got = leaves(ac._unwrap(host))
        assert len(got) == len(ref) == 3 * len(
            tree_util.tree_leaves(state.params))
        for g, r in zip(got, ref):
            assert g.device.type == "cpu" and g.is_pinned()
            assert torch.equal(g, r.cpu())
    finally:
        htt.shutdown()
        knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")


@pytest.mark.cuda
def test_cuda_snapshot_buffers_are_reserved_once_and_reused(tmp_path):
    """``reserve`` makes the pinned buffer set a rank of a world of one
    saves into; the saves after it copy into those same buffers (no
    pinned allocation on the step path), and each writes the state as it
    was at its save, though the next update is queued right behind its
    copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.resilience import async_checkpoint as ac
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {"w": torch.randn(1024, 256, device="cuda", generator=gen),
             "b": torch.randn(256, device="cuda",
                              generator=gen).to(torch.bfloat16)}
    ck = ac.AsyncCheckpointer(str(tmp_path), interval=0, max_to_keep=0)
    want = {}
    try:
        ck.reserve(state)
        ptrs = sorted(b.data_ptr() for bufs in ck._pool._sets for b in bufs)
        assert len(ptrs) == len(state)
        for s in (1, 2, 3):
            want[s] = {k: v.cpu() for k, v in state.items()}
            ck.save(s, state)
            state["w"].add_(1.0)
            state["b"].mul_(2.0)
            ck.wait()
            assert sorted(b.data_ptr() for bufs in ck._pool._sets
                          for b in bufs) == ptrs
        for s, w in want.items():
            got = ac.restore_step(str(tmp_path), s)
            assert all(torch.equal(got[k], w[k]) for k in w)
    finally:
        ck.close()
