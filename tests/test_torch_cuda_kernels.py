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
