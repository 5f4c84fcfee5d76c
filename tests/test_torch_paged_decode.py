"""Paged decode attention of the PyTorch port against the JAX package.

The port's plain version (``kv_cache.paged_attention_reference``, what
the CPU runs and what the CUDA kernel is held against on the card) is
compared with the JAX Pallas kernel in interpret mode and with the JAX
reference, on the same numpy inputs, in f32 at rtol 1e-4 / atol 1e-5.
The CUDA kernel itself runs only on a card (marked ``cuda``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.ops.pallas import flash_attention as jfa
from horovod_tpu.serving import kv_cache as jkvc
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.serving import kv_cache as kvc

RTOL, ATOL = 1e-4, 1e-5


def _rand_paged(rng, b, h, kvh, d, page, n_max, n_pages):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages + 1, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, page, kvh, d)).astype(np.float32)
    bt = rng.permutation(n_pages)[:b * n_max].reshape(b, n_max).astype(
        np.int32)
    lengths = rng.integers(1, page * n_max + 1, b).astype(np.int32)
    return q, kp, vp, bt, lengths


def _port(q, kp, vp, bt, ln, scale):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, kp, vp, bt, ln)]
    return kvc.paged_attention_reference(*t, scale).numpy()


def _jax_ref(q, kp, vp, bt, ln, scale):
    return np.asarray(jkvc.paged_attention_reference(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, ln)), scale))


@pytest.mark.parametrize("b,h,kvh,d,page,n_max", [
    (2, 4, 4, 128, 128, 3),       # lane-aligned page, MHA
    (3, 4, 2, 64, 128, 2),        # GQA grouping, short head dim
    (1, 2, 2, 128, 256, 2),       # multi-lane page
    (4, 8, 2, 64, 128, 3),        # GQA, four query heads per KV head
])
def test_reference_matches_jax_kernel_interpret(b, h, kvh, d, page, n_max):
    rng = np.random.default_rng(0)
    args = _rand_paged(rng, b, h, kvh, d, page, n_max, b * n_max + 2)
    scale = d ** -0.5
    out = _port(*args, scale)
    kern = np.asarray(jfa.flash_paged_decode(
        *(jnp.asarray(a) for a in args), scale, interpret=True))
    np.testing.assert_allclose(out, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, _jax_ref(*args, scale),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("page,kvh", [(16, 4), (16, 2), (48, 4)])
def test_reference_matches_jax_reference_non_128_page(page, kvh):
    """Pages the TPU kernel refuses (16, 48) against the JAX reference."""
    rng = np.random.default_rng(1)
    b, h, d, n_max = 3, 4, 32, 4
    args = _rand_paged(rng, b, h, kvh, d, page, n_max, b * n_max + 2)
    np.testing.assert_allclose(_port(*args, d ** -0.5),
                               _jax_ref(*args, d ** -0.5),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kvh", [1, 2])                 # GQA 8 and 4
def test_long_sequences_over_many_chunks_match_jax_reference(kvh):
    """Sequences that span many of the kernel's 128-position chunks on
    16-position pages (n_max 40: 640 positions), lengths at and around the
    chunk edges, GQA of 8 and 4 query heads per KV head, against the JAX
    reference (the TPU kernel refuses 16-position pages)."""
    rng = np.random.default_rng(7)
    b, h, d, page, n_max = 6, 8, 32, 16, 40
    q, kp, vp, bt, _ = _rand_paged(rng, b, h, kvh, d, page, n_max,
                                   b * n_max + 2)
    lengths = np.asarray([640, 639, 129, 128, 127, 300], np.int32)
    np.testing.assert_allclose(_port(q, kp, vp, bt, lengths, d ** -0.5),
                               _jax_ref(q, kp, vp, bt, lengths, d ** -0.5),
                               rtol=RTOL, atol=ATOL)


def test_long_sequences_gqa8_match_jax_kernel_interpret():
    """Four 128-position pages a sequence (four of the kernel's chunks),
    GQA of 8 query heads per KV head, against the interpreted Pallas
    kernel and the JAX reference."""
    rng = np.random.default_rng(8)
    b, h, kvh, d, page, n_max = 3, 8, 1, 64, 128, 4
    q, kp, vp, bt, _ = _rand_paged(rng, b, h, kvh, d, page, n_max,
                                   b * n_max + 2)
    lengths = np.asarray([512, 257, 385], np.int32)
    args = (q, kp, vp, bt, lengths)
    out = _port(*args, d ** -0.5)
    kern = np.asarray(jfa.flash_paged_decode(
        *(jnp.asarray(a) for a in args), d ** -0.5, interpret=True))
    np.testing.assert_allclose(out, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, _jax_ref(*args, d ** -0.5),
                               rtol=RTOL, atol=ATOL)


def test_empty_slot_gives_exact_zeros():
    rng = np.random.default_rng(2)
    q, kp, vp, bt, _ = _rand_paged(rng, 2, 2, 2, 128, 128, 2, 6)
    lengths = np.asarray([5, 0], np.int32)
    out = _port(q, kp, vp, bt, lengths, 0.1)
    assert np.all(out[1] == 0.0)
    kern = np.asarray(jfa.flash_paged_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, lengths)), 0.1,
        interpret=True))
    np.testing.assert_allclose(out, kern, rtol=RTOL, atol=ATOL)


def test_lengths_past_the_table_are_clamped_like_jax():
    """A length beyond n_max*page attends over the whole table, as the
    JAX reference's mask does."""
    rng = np.random.default_rng(3)
    q, kp, vp, bt, _ = _rand_paged(rng, 2, 4, 4, 16, 16, 2, 6)
    lengths = np.asarray([40, 32], np.int32)
    np.testing.assert_allclose(_port(q, kp, vp, bt, lengths, 0.25),
                               _jax_ref(q, kp, vp, bt, lengths, 0.25),
                               rtol=RTOL, atol=ATOL)


def test_reference_matches_dense_attention():
    rng = np.random.default_rng(4)
    b, h, d, page, n_max = 3, 4, 32, 16, 4
    q, kp, vp, bt, lengths = _rand_paged(rng, b, h, h, d, page, n_max,
                                         b * n_max + 2)
    out = _port(q, kp, vp, bt, lengths, d ** -0.5)
    for i in range(b):
        k = kp[bt[i]].reshape(-1, h, d)[:lengths[i]]
        v = vp[bt[i]].reshape(-1, h, d)[:lengths[i]]
        s = np.einsum("hd,shd->hs", q[i], k) * d ** -0.5
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        np.testing.assert_allclose(out[i], np.einsum("hs,shd->hd", p, v),
                                   rtol=1e-5, atol=1e-5)


def test_hopper_gate():
    q = torch.zeros(2, 4, 64)
    for page in (16, 128):                   # every engine geometry passes
        assert fa.paged_decode_supports(q, torch.zeros(8, page, 4, 64))
    assert fa.paged_decode_supports(q, torch.zeros(8, 128, 2, 64))   # GQA
    assert fa.paged_decode_supports(torch.zeros(2, 4, 16),
                                    torch.zeros(8, 16, 4, 16))
    assert fa.paged_decode_supports(torch.zeros(2, 4, 96),
                                    torch.zeros(8, 16, 4, 96))
    assert fa.paged_decode_supports(
        q.bfloat16(), torch.zeros(8, 128, 4, 64, dtype=torch.bfloat16))
    assert not fa.paged_decode_supports(q, torch.zeros(8, 128, 3, 64))
    assert not fa.paged_decode_supports(torch.zeros(2, 4, 12),
                                        torch.zeros(8, 16, 4, 12))
    assert not fa.paged_decode_supports(torch.zeros(2, 4, 264),
                                        torch.zeros(8, 16, 4, 264))
    assert not fa.paged_decode_supports(q.bfloat16(),
                                        torch.zeros(8, 128, 4, 64))
    assert not fa.paged_decode_supports(
        q.half(), torch.zeros(8, 128, 4, 64, dtype=torch.half))
    assert not fa.paged_decode_supports(
        q, torch.zeros(8, 128, 4, 64), torch.zeros(8, 128, 4, 32))
    assert not fa.paged_decode_supports(
        q, torch.zeros(8, 4, 128, 64).transpose(1, 2))   # not contiguous


def test_dispatch_on_cpu_takes_the_plain_version_without_launching():
    rng = np.random.default_rng(5)
    args = _rand_paged(rng, 2, 4, 4, 16, 16, 2, 6)
    t = [torch.from_numpy(a) for a in args]
    fa.reset_launches()
    out = kvc.paged_decode_attention(*t, 0.25)
    assert fa.LAUNCHES["paged_decode"] == 0
    np.testing.assert_array_equal(
        out.numpy(), kvc.paged_attention_reference(*t, 0.25).numpy())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_paged_decode(*t, 0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kvh,page", [(4, 128), (2, 16)])
def test_cuda_kernel_matches_plain_version(dtype, tol, kvh, page):
    """The kernel against its plain version on the card (skips without
    one): ragged lengths, an empty slot, GQA."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(6)
    b, h, d, n_max = 5, 8, 64, 4
    q, kp, vp, bt, lengths = _rand_paged(rng, b, h, kvh, d, page, n_max,
                                         b * n_max + 2)
    lengths[1] = 0
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev) for a in (q, kp, vp)]
    t = [x.to(dtype) for x in t]
    bt_t, ln_t = (torch.from_numpy(a).to(dev) for a in (bt, lengths))
    before = fa.LAUNCHES["paged_decode"]
    out = fa.flash_paged_decode(*t, bt_t, ln_t, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["paged_decode"] == before + 1
    ref = kvc.paged_attention_reference(*t, bt_t, ln_t, d ** -0.5)
    assert torch.all(out[1] == 0)
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the build (nvcc is absent here: a stand-in compiler checks the plumbing)
# ---------------------------------------------------------------------------

def _fake_nvcc(tmp_path, body):
    exe = tmp_path / "nvcc"
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(0o755)
    return str(exe)


def test_build_runs_one_nvcc_per_source_into_the_build_dir(tmp_path,
                                                           monkeypatch):
    from horovod_tpu_torch.ops import _build
    # the stand-in writes the file after -o and logs its arguments
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                'echo built > "$2"; echo ptxas ok\n')
    monkeypatch.setattr(_build, "nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    names = {"paged_decode", "flash_fwd", "flash_bwd", "conv_bn_fwd",
             "conv_bn_bwd", "stream_copy"}
    assert set(_build.SOURCES) == names
    seconds = _build.build_all()
    assert set(seconds) == names and all(t > 0 for t in seconds.values())
    for name in names:
        lib = _build.library_path(name)
        assert lib.parent == tmp_path / "build"
        assert lib.read_text() == "built\n"
        assert _build.build_logs[name].strip() == "ptxas ok"
    assert len({_build.library_path(n) for n in names}) == len(names)
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert _build.build_all() == {n: 0.0 for n in names}   # built once


def test_build_failure_and_missing_nvcc_raise(tmp_path, monkeypatch):
    from horovod_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(
        tmp_path, "echo 'error: bad kernel'; exit 2\n"))
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_all()
    assert not _build.library_path("paged_decode").exists()
    monkeypatch.undo()
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
