"""Flash attention of the PyTorch port against the JAX package.

The port's plain versions (``parallel.sequence._block_attend`` and
``_bwd_block_plain``: what the CPU runs and what the CUDA kernels are held
against on the card) are compared with the JAX Pallas kernels in
interpret mode and with the JAX jnp versions, on the same numpy inputs,
in f32. Tolerances: 1e-5 where the two sides sum the same terms in a
different order; the unnormalized output ``o`` and the gradients sum
64-256 products of unit-scale values, where f32 reorderings reach a few
1e-6 of values near 10, so they are held at rtol/atol 1e-5 too unless a
test says otherwise. The CUDA kernels themselves run only on a card:
their tests are in ``test_torch_cuda_kernels.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops.pallas import flash_attention as jfa
from horovod_tpu.parallel import sequence as jsp
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import sequence as sp

TOL = dict(rtol=1e-5, atol=1e-5)


def rand_qkv(rng, b, sq, sk, h, d):
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(*tensors):
    return [np.asarray(t) if not isinstance(t, torch.Tensor)
            else t.detach().numpy() for t in tensors]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(128, 128), (128, 256), (256, 128)])
def test_block_attend_matches_jax_kernel_and_jnp(causal, sq, sk):
    rng = np.random.default_rng(0)
    q, k, v = rand_qkv(rng, b=2, sq=sq, sk=sk, h=2, d=64)
    scale = 64 ** -0.5
    got = _np(*sp._block_attend(*_t(q, k, v), 0, 0, causal, scale))
    kern = _np(*jfa.flash_block_attend(q, k, v, 0, 0, causal=causal,
                                       scale=scale, interpret=True))
    ref = _np(*jsp._block_attend(*map(jnp.asarray, (q, k, v)), 0, 0,
                                 causal, scale))
    for g, kk, r, name in zip(got, kern, ref, ("o", "m", "l")):
        np.testing.assert_allclose(g, kk, **TOL, err_msg=f"{name} vs kernel")
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"{name} vs jnp")


@pytest.mark.parametrize("qoff,koff", [(0, 128), (128, 0), (256, 128)])
def test_block_attend_offsets_match_jax(qoff, koff):
    """Ring-step positioning: a K block after Q in the global sequence is
    fully masked under causal (m = -1e30 and l = 0 exactly); before it,
    fully visible."""
    rng = np.random.default_rng(1)
    q, k, v = rand_qkv(rng, b=1, sq=128, sk=128, h=1, d=64)
    got = _np(*sp._block_attend(*_t(q, k, v), qoff, koff, True, 0.125))
    kern = _np(*jfa.flash_block_attend(q, k, v, qoff, koff, causal=True,
                                       scale=0.125, interpret=True))
    ref = _np(*jsp._block_attend(*map(jnp.asarray, (q, k, v)), qoff, koff,
                                 True, 0.125))
    for g, kk, r, name in zip(got, kern, ref, ("o", "m", "l")):
        np.testing.assert_allclose(g, kk, **TOL, err_msg=f"{name} vs kernel")
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"{name} vs jnp")
    if qoff < koff:                                   # fully masked block
        o, m, l = got
        assert np.all(m == np.float32(sp.NEG_INF)) and np.all(l == 0)
        assert np.all(o == 0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,qoff,koff,d", [
    (200, 328, 0, 0, 64),    # ragged on both sides of 64/128-row tiles
    (256, 256, 96, 32, 64),  # offsets off the 64/128-row tiles
    (256, 256, 32, 96, 64),  # ... with rows that see no key
    (256, 256, 0, 0, 40),    # D not a multiple of 16
    (200, 328, 0, 0, 40),
])
def test_block_attend_edge_geometries_match_jax(causal, sq, sk, qoff, koff,
                                                d):
    """The plain forward (what the CUDA kernel is held to on the card) at
    the backward's edge geometries: against JAX's ``_block_attend`` in
    every case, and against the interpreted Pallas kernel where its blocks
    divide Sq and Sk (``_resolve_blocks``; 200 x 328 has no aligned
    block). Rows that see no key give m = -1e30, l = 0 and o = 0
    exactly."""
    rng = np.random.default_rng(2)
    q, k, v = rand_qkv(rng, b=1, sq=sq, sk=sk, h=2, d=d)
    scale = d ** -0.5
    tag = f"({sq},{sk},{qoff},{koff},d={d},causal={causal})"
    got = _np(*sp._block_attend(*_t(q, k, v), qoff, koff, causal, scale))
    ref = _np(*jsp._block_attend(*map(jnp.asarray, (q, k, v)), qoff, koff,
                                 causal, scale))
    for g, r, name in zip(got, ref, ("o", "m", "l")):
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"{name} vs jnp {tag}")
    blind = qoff + np.arange(sq) < koff
    if causal and blind.any():
        o, m, l = got
        assert np.all(m[..., blind] == np.float32(sp.NEG_INF))
        assert np.all(l[..., blind] == 0) and np.all(o[:, blind] == 0)
    if None in jfa._resolve_blocks(sq, sk, None, None):
        return
    kern = _np(*jfa.flash_block_attend(q, k, v, qoff, koff, causal=causal,
                                       scale=scale, interpret=True))
    for g, kk, name in zip(got, kern, ("o", "m", "l")):
        np.testing.assert_allclose(g, kk, **TOL,
                                   err_msg=f"{name} vs kernel {tag}")


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _check_bwd_block(causal, sq, sk, qoff, koff, random_lse=False):
    rng = np.random.default_rng(13)
    b, h, d = 1, 2, 64
    q, k, v = rand_qkv(rng, b, sq, sk, h, d)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    if random_lse:
        lse = (rng.standard_normal((b, h, sq)) + 3.0).astype(np.float32)
    dD = rng.standard_normal((b, h, sq)).astype(np.float32)
    scale = d ** -0.5
    if not random_lse:
        # The global row stats the backward gets: lse of the plain forward
        # (-1e30 for a row that sees no key), so P <= 1.
        _, m, l = sp._block_attend(*_t(q, k, v), qoff, koff, causal, scale)
        lse = (m + torch.log(l.clamp_min(1e-30))).numpy()
    tag = f"({sq},{sk},{qoff},{koff},causal={causal},random_lse={random_lse})"
    got = _np(*sp._bwd_block_plain(*_t(q, k, v, do, lse, dD), qoff, koff,
                                   causal, scale))
    ref = _np(*jsp._bwd_block_jnp(*map(jnp.asarray, (q, k, v, do, lse, dD)),
                                  qoff, koff, causal, scale))
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"{name} vs jnp {tag}")
    if None in jfa._resolve_blocks(sq, sk, None, None):
        return
    kern = _np(*jfa.flash_bwd_block(q, k, v, do, lse, dD, qoff, koff,
                                    causal=causal, scale=scale,
                                    interpret=True))
    for g, kk, name in zip(got, kern, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, kk, **TOL,
                                   err_msg=f"{name} vs kernel {tag}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,qoff,koff", [
    (128, 128, 0, 0), (128, 128, 128, 0), (128, 128, 0, 128),
    (128, 128, 256, 128),
    (200, 328, 0, 0),        # ragged on both sides of 64/128-row tiles
    (129, 129, 0, 0),        # one row past a 128-row block
    (256, 256, 96, 32),      # offsets off the 64/128-row tiles
    (256, 256, 32, 96),      # ... with rows that see no key
])
def test_bwd_block_plain_matches_jax_kernels_and_jnp(causal, sq, sk, qoff,
                                                     koff):
    """The plain backward (what the CUDA kernels are held to on the card)
    against JAX's ``_bwd_block_jnp`` in every case, and against the
    interpreted Pallas kernels where their blocks divide Sq and Sk
    (``_resolve_blocks``; 200 x 328 and 129 have no aligned block)."""
    _check_bwd_block(causal, sq, sk, qoff, koff)


@pytest.mark.parametrize("qoff,koff", [(0, 0), (128, 0), (0, 128),
                                       (256, 128)])
def test_bwd_block_plain_matches_jax_with_random_lse(qoff, koff):
    """The same comparison with lse drawn at random + 3, independent of the
    forward, so P reaches e^3 > 1: the plain backward must not assume the
    row stats came from its own forward. 128 x 128, causal."""
    _check_bwd_block(True, 128, 128, qoff, koff, random_lse=True)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_values_and_grads_match_jax(causal):
    """The autograd.Function on CPU tensors (plain forward, plain backward)
    against jax.grad of the JAX custom-VJP in interpret mode. Geometry of
    the JAX package's own test: Sq=128 against Sk=256."""
    rng = np.random.default_rng(7)
    q, k, v = rand_qkv(rng, b=1, sq=128, sk=256, h=2, d=64)
    scale = 64 ** -0.5

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, scale, interpret=True)
        return jnp.sum(jnp.sin(o))

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    j_out = jfa.flash_attention(jq, jk, jv, causal, scale, interpret=True)
    j_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    fa.reset_launches()
    out = fa.flash_attention(tq, tk, tv, causal, scale)
    torch.sin(out).sum().backward()
    assert all(n == 0 for n in fa.LAUNCHES.values())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    for t, g, name in zip((tq, tk, tv), j_grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL,
                                   err_msg=f"d{name}")


def test_local_attention_keeps_dtype_and_matches_dense():
    rng = np.random.default_rng(8)
    q, k, v = _t(*rand_qkv(rng, b=2, sq=40, sk=40, h=3, d=16))
    out = sp.local_attention(q, k, v, causal=True)
    assert out.dtype == q.dtype and out.shape == q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.25
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(), -1e30)
    ref = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    torch.testing.assert_close(out, ref, **TOL)
    bf = sp.local_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert bf.dtype == torch.bfloat16


def test_sequence_parallel_attention_is_not_ported():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="slice 4"):
        sp.ring_attention(q, q, q, "sp")
    with pytest.raises(NotImplementedError, match="slice 4"):
        sp.ulysses_attention(q, q, q, "sp")


# ---------------------------------------------------------------------------
# gate and dispatch
# ---------------------------------------------------------------------------

def test_flash_gate():
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)  # noqa: E731
    assert fa.supports(z(2, 128, 4, 64), z(2, 256, 4, 64), z(2, 256, 4, 64))
    assert fa.supports(z(2, 1000, 4, 64, dt=torch.bfloat16),
                       z(2, 1000, 4, 64, dt=torch.bfloat16),
                       z(2, 1000, 4, 64, dt=torch.bfloat16))
    assert fa.supports(z(1, 1, 1, 8), z(1, 3, 1, 8), z(1, 3, 1, 8))
    assert fa.supports(z(1, 5, 2, 128), z(1, 7, 2, 128), z(1, 7, 2, 128))
    assert fa.supports(z(1, 16, 4, 16), z(1, 16, 4, 16), z(1, 16, 4, 16))
    q = z(2, 64, 4, 64)
    assert not fa.supports(z(2, 64, 4, 12), z(2, 64, 4, 12), z(2, 64, 4, 12))
    assert not fa.supports(z(2, 64, 4, 136), z(2, 64, 4, 136),
                           z(2, 64, 4, 136))
    assert not fa.supports(q, q.bfloat16(), q)                   # dtypes
    assert not fa.supports(q.half(), q.half(), q.half())
    assert not fa.supports(q, z(2, 64, 2, 64), z(2, 64, 2, 64))  # heads
    assert not fa.supports(q, q, z(2, 32, 4, 64))                # k != v
    assert not fa.supports(q, z(2, 4, 64, 64).transpose(1, 2), q)
    assert not fa.supports(z(2, 0, 4, 64), q, q)
    assert not fa.supports(z(64, 4, 64), q, q)


def test_cpu_tensors_take_the_plain_versions_and_never_launch():
    rng = np.random.default_rng(9)
    q, k, v = _t(*rand_qkv(rng, b=1, sq=32, sk=32, h=2, d=16))
    lse, dD = torch.zeros(1, 2, 32), torch.zeros(1, 2, 32)
    fa.reset_launches()
    sp.local_attention(q, k, v)
    assert all(n == 0 for n in fa.LAUNCHES.values())
    with pytest.raises(ValueError, match="sequence._block_attend"):
        fa.flash_block_attend(q, k, v, 0, 0, True, 0.25)
    with pytest.raises(ValueError, match="sequence._bwd_block_plain"):
        fa.flash_bwd_block(q, k, v, q, lse, dD, 0, 0, True, 0.25)
    assert all(n == 0 for n in fa.LAUNCHES.values())
