"""The port's wire codec and compressors against the JAX package's
(``horovod_tpu/compression.py``), on the CPU.

The same numpy buckets go through ``WireCodec.encode``/``decode`` of both
packages. The wire buffers must be equal bit for bit, the fp8 scales equal
as f32, and the decoded buffers equal: both cast f32 to the wire dtype
with round-to-nearest-even on values the scale keeps in range, and both
decode with the same f32 multiplies. The JAX tests' headroom and underflow
properties (``tests/test_wire_compression.py`` l.55-96) are checked at
W = 4 on the port.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu import compression as jcompr
import horovod_tpu_torch as htt
from horovod_tpu_torch import compression as compr
from horovod_tpu_torch.compression import Compression, WireCodec
from horovod_tpu_torch.config import knobs

TIERS = ("bf16", "fp16", "fp8_e4m3", "fp8_e5m2")
_NP_WIRE = {"bf16": ml_dtypes.bfloat16, "fp16": np.float16,
            "fp8_e4m3": ml_dtypes.float8_e4m3fn,
            "fp8_e5m2": ml_dtypes.float8_e5m2}


@pytest.fixture()
def override():
    touched = []

    def set_(name, value):
        knobs.set_override(name, value)
        touched.append(name)

    yield set_
    for name in touched:
        knobs.clear_override(name)


def _bits(wire) -> np.ndarray:
    """The raw bits of a torch or JAX wire buffer, as unsigned ints."""
    if isinstance(wire, torch.Tensor):
        u = torch.uint8 if wire.element_size() == 1 else torch.int16
        return wire.view(u).numpy().view(
            np.uint8 if wire.element_size() == 1 else np.uint16)
    a = np.asarray(wire)
    return a.view(np.uint8 if a.itemsize == 1 else np.uint16)


def _bucket(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "wide":            # magnitudes over 20 decades
        return (rng.standard_normal(n)
                * 10.0 ** rng.uniform(-12, 8, n)).astype(np.float32)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    if kind == "huge":
        return np.full(n, 1e30, np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["normal", "wide", "zeros", "huge"])
def test_encode_decode_bits_match_jax(tier, world, kind):
    x = _bucket(kind, 1031, seed=world)
    jc, pc = jcompr.WireCodec(tier), WireCodec(tier)
    assert (pc.wire_bits, pc.wire_itemsize, pc.scaled, pc.low_bit) == (
        jc.wire_bits, jc.wire_itemsize, jc.scaled, jc.low_bit)
    jw, js = jc.encode(jnp.asarray(x), world=world)
    pw, ps = pc.encode(torch.from_numpy(x), world=world)
    assert pw.dtype.itemsize == jw.dtype.itemsize and pw.shape == jw.shape
    if not (kind == "huge" and tier in ("bf16", "fp16")):
        np.testing.assert_array_equal(_bits(pw), _bits(jw))
    else:
        # unscaled 16-bit tiers: 1e30 overflows fp16 to inf on both; bf16
        # keeps it; the bits agree as floats
        np.testing.assert_array_equal(pw.float().numpy(),
                                      np.asarray(jw, np.float32))
    assert (js is None) == (ps is None) == (not pc.scaled)
    if ps is not None:
        assert ps.dtype == torch.float32 and ps.shape == ()
        assert np.float32(ps.item()) == np.float32(js)
    post = 1.0 / world if world > 1 else None
    jd = np.asarray(jc.decode(jw, js, jnp.float32, postscale=post))
    pd = pc.decode(pw, ps, torch.float32, postscale=post).numpy()
    np.testing.assert_array_equal(pd, jd)
    if kind == "zeros":
        assert not pd.any() and (ps is None or ps.item() == 1.0)


@pytest.mark.parametrize("tier", ["fp8_e4m3", "fp8_e5m2"])
def test_torch_fp8_cast_equals_ml_dtypes_in_range(tier):
    """torch's f32 -> fp8 cast against ml_dtypes' (what JAX uses) on every
    in-range magnitude class, ties included."""
    info = ml_dtypes.finfo(_NP_WIRE[tier])
    rng = np.random.default_rng(3)
    grid = np.concatenate([
        rng.uniform(-float(info.max), float(info.max), 20000),
        rng.standard_normal(20000) * float(info.tiny),
        # exact halfway points between neighbouring fp8 values
        (np.arange(256, dtype=np.uint8).view(_NP_WIRE[tier])
         .astype(np.float32)),
    ]).astype(np.float32)
    grid = grid[np.isfinite(grid) & (np.abs(grid) <= float(info.max))]
    mids = (grid[:-1] + grid[1:]) / 2
    vals = np.concatenate([grid, mids]).astype(np.float32)
    want = vals.astype(_NP_WIRE[tier]).view(np.uint8)
    got = torch.from_numpy(vals).to(WireCodec(tier).wire_dtype).view(
        torch.uint8).numpy()
    finite = np.isfinite(vals.astype(_NP_WIRE[tier]).astype(np.float32))
    np.testing.assert_array_equal(got[finite], want[finite])


def test_fp8_overflow_headroom_at_four_ranks():
    """A huge amax: the SUM of four ranks' quantized values still fits
    e4m3 (the scale carries the world), and decodes back within 20 %."""
    codec = WireCodec("fp8_e4m3")
    world = 4
    x = torch.full((16,), 1e30)
    wire, scale = codec.encode(x, world=world)
    summed = wire.float() * world                    # worst-case wire sum
    assert torch.isfinite(summed).all()
    assert float(summed.abs().max()) <= 448.0
    back = codec.decode((summed / world).to(torch.float8_e4m3fn), scale,
                        torch.float32)
    torch.testing.assert_close(back, x, rtol=0.2, atol=0)


def test_fp8_roundtrip_zero_bucket_and_underflow_into_residual():
    codec = WireCodec("fp8_e4m3")
    x = torch.from_numpy(np.random.RandomState(1).randn(256).astype(
        np.float32))
    wire, scale = codec.encode(x, world=4)
    assert wire.dtype == torch.float8_e4m3fn
    err = float((codec.decode(wire, scale, x.dtype) - x).abs().max())
    assert err < 0.2 * float(x.abs().max())
    z, zs = codec.encode(torch.zeros(32), world=4)
    assert zs.item() == 1.0 and not codec.decode(z, zs, torch.float32).any()
    x = torch.tensor([1000.0] + [1e-7] * 31)
    wire, scale = codec.encode(x, world=4)
    local = codec.decode(wire, scale, x.dtype)
    assert local[1] == 0.0                           # flushed
    torch.testing.assert_close(x[1:] - local[1:], torch.full((31,), 1e-7))


def test_non_float_and_narrow_buffers_pass_through():
    codec = WireCodec("bf16")
    for t in (torch.arange(5), torch.ones(4, dtype=torch.bfloat16),
              torch.ones(3, dtype=torch.float16)):
        wire, scale = codec.encode(t)
        assert wire is t and scale is None
    assert WireCodec("fp8_e4m3").compresses(torch.bfloat16)
    assert not WireCodec("fp8_e4m3").compresses(torch.int32)


def test_tier_resolution_and_knob_override(override):
    assert compr.WIRE_TIERS == jcompr.WIRE_TIERS
    assert compr.tier_for(None) == "none"
    assert compr.tier_for(Compression.none) == "none"
    assert compr.tier_for(Compression.fp16) == "bf16"
    assert compr.tier_for(Compression.fp16_ieee) == "fp16"
    assert compr.tier_for("fp8_e5m2") == "fp8_e5m2"
    assert compr.tier_for(WireCodec("fp16")) == "fp16"

    class Custom:
        def compress(self, t):
            return t, None

        def decompress(self, t, ctx):
            return t

    assert compr.tier_for(Custom()) == "none"
    with pytest.raises(ValueError, match="unknown wire-compression"):
        compr.tier_for("int4")
    with pytest.raises(TypeError, match="compression must be"):
        compr.tier_for(3)
    with pytest.raises(ValueError, match="unknown wire-compression"):
        WireCodec("none")
    assert compr.active_wire_tier(Compression.fp16) == "bf16"
    assert compr.wire_codec(None) is None
    override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    assert compr.active_wire_tier(Compression.none) == "fp8_e4m3"
    assert compr.active_wire_tier(Compression.fp16) == "fp8_e4m3"
    assert compr.wire_codec(None).tier == "fp8_e4m3"


def test_knob_from_the_environment(monkeypatch):
    monkeypatch.setenv("HOROVOD_GRADIENT_COMPRESSION", "bf16")
    assert compr.active_wire_tier(None) == "bf16"
    monkeypatch.setenv("HOROVOD_GRADIENT_COMPRESSION", "int4")
    with pytest.raises(ValueError, match="allowed choices"):
        compr.active_wire_tier(None)
    monkeypatch.setenv("HOROVOD_GRADIENT_BUCKET_BYTES", "8MB")
    assert knobs.get("HOROVOD_GRADIENT_BUCKET_BYTES") == 8 << 20


def test_as_compressor_and_per_leaf_compressors():
    assert compr.as_compressor("bf16") is Compression.fp16
    assert compr.as_compressor("fp16") is Compression.fp16_ieee
    assert compr.as_compressor("fp8_e4m3") is Compression.none
    assert compr.as_compressor(None) is Compression.none
    assert compr.as_compressor(WireCodec("bf16")) is Compression.fp16
    assert compr.as_compressor(Compression.fp16) is Compression.fp16
    x = torch.randn(6)
    for comp, wire in ((Compression.fp16, torch.bfloat16),
                       (Compression.fp16_ieee, torch.float16)):
        c, ctx = comp.compress(x)
        assert c.dtype == wire and ctx == torch.float32
        back = comp.decompress(c, ctx)
        assert back.dtype == torch.float32
        jc, jctx = (jcompr.Compression.fp16 if wire == torch.bfloat16
                    else jcompr.Compression.fp16_ieee).compress(
            jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(back.numpy(), np.asarray(
            jcompr.FP16Compressor.decompress(jc, jctx)))
    i = torch.arange(3)
    assert Compression.fp16.compress(i)[0] is i
    assert Compression.none.compress(x) == (x, None)


def test_error_feedback_policy(override):
    assert not compr.error_feedback_enabled(None)
    assert not compr.error_feedback_enabled(WireCodec("bf16"))
    assert compr.error_feedback_enabled(WireCodec("fp8_e4m3"))
    override("HOROVOD_GRADIENT_ERROR_FEEDBACK", "1")
    assert compr.error_feedback_enabled(WireCodec("bf16"))
    override("HOROVOD_GRADIENT_ERROR_FEEDBACK", "0")
    assert not compr.error_feedback_enabled(WireCodec("fp8_e4m3"))


@pytest.mark.parametrize("tier", TIERS)
def test_wire_sum_on_a_world_of_one(tier):
    """The wire SUM route (all_to_all_single of the bytes, f32 sum, one
    rounding, all_gather) on a gloo world of one gives the wire back, and
    the amax exchange of an fp8 encode runs over the world."""
    from horovod_tpu_torch.ops import collectives
    htt.init(device="cpu")
    try:
        codec = WireCodec(tier)
        x = torch.from_numpy(_bucket("normal", 37, 5))
        wire, scale = codec.encode(x, axes=("hvd",), world=1)
        work, out = collectives.wire_sum_async(wire)
        work.wait()
        np.testing.assert_array_equal(_bits(out), _bits(wire))
    finally:
        htt.shutdown()
