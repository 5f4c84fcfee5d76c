"""Gradient compression: the port's copy of ``horovod_tpu/compression.py``.

The reference's per-leaf surface (``Compression.none`` / ``.fp16`` /
``.fp16_ieee``, each a :class:`Compressor` with ``compress(tensor) ->
(tensor, ctx)`` and ``decompress(tensor, ctx)``), and the **bucket wire
codec** (:class:`WireCodec`) of the bucketed gradient sync
(``parallel/distributed.py``): each packed bucket is cast to a wire dtype
before its SUM and decoded after it, so the reduction moves 2x (bf16,
fp16) or 4x (fp8) fewer bytes. The fp8 tiers scale each bucket by one
amax shared by the ranks the SUM spans (a MAX allreduce of one f32 scalar
over the named axes' group), sized so that the SUM of ``world`` ranks'
quantized values cannot overflow the wire dtype. The tier is the ``HOROVOD_GRADIENT_COMPRESSION`` knob, or the tier
a ``compression=`` argument implies.

The wire dtypes are torch's: ``bfloat16``, ``float16``,
``float8_e4m3fn`` and ``float8_e5m2``; torch's f32 -> fp8 cast rounds to
nearest even as ``ml_dtypes``' does on in-range values, which the scale
guarantees (``tests/test_torch_compression.py`` holds the bits equal).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from horovod_tpu_torch.config import knobs


class Compressor:
    """Interface (ref compression.py:23)."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Pass-through (ref compression.py:31)."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


@functools.lru_cache(maxsize=None)
def _narrowable(dtype: torch.dtype, wire_bits: int) -> bool:
    """Whether tensors of ``dtype`` are narrowed to a ``wire_bits``-wide
    float on the wire: floating dtypes wider than the wire only."""
    return dtype.is_floating_point and torch.finfo(dtype).bits > wire_bits


class FP16Compressor(Compressor):
    """Cast floating tensors to a 16-bit dtype for the wire (bfloat16 by
    default, as in the JAX package; ``fp16_ieee`` for float16)."""

    wire_dtype = torch.bfloat16

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if _narrowable(tensor.dtype, 16):
            tensor = tensor.to(cls.wire_dtype)
        return tensor, ctx

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if tensor.dtype == ctx else tensor.to(ctx)


class _FP16IEEECompressor(FP16Compressor):
    wire_dtype = torch.float16


class Compression:
    """Namespace parity with ref compression.py:66-74."""

    none = NoneCompressor
    fp16 = FP16Compressor
    fp16_ieee = _FP16IEEECompressor


# ---------------------------------------------------------------------------
# bucket wire codec (HOROVOD_GRADIENT_COMPRESSION)
# ---------------------------------------------------------------------------

# Tier names, from lossless-ish to most aggressive.
WIRE_TIERS = ("none", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")

_TIER_DTYPES = {
    "bf16": (torch.bfloat16, False),
    "fp16": (torch.float16, False),
    "fp8_e4m3": (torch.float8_e4m3fn, True),
    "fp8_e5m2": (torch.float8_e5m2, True),
}


class WireCodec:
    """Bucket-level wire compression: ``encode`` the packed bucket to the
    wire dtype before the collective, ``decode`` the reduced wire buffer
    after it. Scaled (fp8) tiers compute one global amax scale per bucket.
    The wire collective must be a SUM; averaging folds into ``decode``'s
    postscale."""

    def __init__(self, tier: str):
        if tier not in _TIER_DTYPES:
            raise ValueError(
                f"unknown wire-compression tier {tier!r}; choose one of "
                f"{WIRE_TIERS}")
        self.tier = tier
        self.wire_dtype, self.scaled = _TIER_DTYPES[tier]
        info = torch.finfo(self.wire_dtype)
        self.wire_bits = info.bits
        self.wire_itemsize = self.wire_dtype.itemsize
        self._wire_max = float(info.max)    # amax headroom denominator
        self.low_bit = self.wire_bits < 16  # error feedback on by default

    def compresses(self, dtype: torch.dtype) -> bool:
        """Whether this codec narrows buffers of ``dtype`` on the wire."""
        return _narrowable(dtype, self.wire_bits)

    def encode(self, buf: torch.Tensor, axes=(), world: int = 1
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(wire buffer, scale) for one packed bucket. The amax of a scaled
        tier is MAX-reduced over the ranks of the mesh axes named in
        ``axes`` (this rank's group along them, as ``lax.pmax`` over those
        axes; ``hvd`` names every rank; pass ``()`` for the local math
        alone); ``world`` is the rank count the wire SUM spans. The scale
        is a 0-dim f32 tensor, or None."""
        if not self.compresses(buf.dtype):
            return buf, None
        if not self.scaled:
            return buf.to(self.wire_dtype), None
        amax = buf.abs().max().float().reshape(1)
        if axes:
            from horovod_tpu_torch.ops import collectives
            from horovod_tpu_torch.ops.reduce_ops import ReduceOp
            collectives.allreduce_(amax, ReduceOp.MAX, axis=tuple(axes))
        # |sum_r q_r| <= world * amax / scale must fit the wire dtype;
        # amax == 0 (or nonfinite) keeps scale 1, so zeros stay exact
        scale = amax * (float(max(int(world), 1)) / self._wire_max)
        scale = torch.where(torch.isfinite(scale) & (scale > 0.0), scale,
                            torch.ones_like(scale)).reshape(())
        wire = (buf / scale.to(buf.dtype)).to(self.wire_dtype)
        return wire, scale

    def decode(self, wire: torch.Tensor, scale: Optional[torch.Tensor],
               out_dtype: torch.dtype, postscale: Optional[float] = None
               ) -> torch.Tensor:
        """A (reduced or local) wire buffer back in ``out_dtype``;
        ``postscale`` folds the averaging (1/world) into the same pass."""
        out = wire.float() if wire.dtype != out_dtype else wire
        if scale is not None:
            out = out * scale.to(out.dtype)
        if postscale is not None:
            out = out * postscale
        return out.to(out_dtype)


def tier_for(compression) -> str:
    """A tier name for a tier string, a :class:`WireCodec`, one of the
    ``Compression.*`` classes, or None ('none')."""
    if compression is None:
        return "none"
    if isinstance(compression, WireCodec):
        return compression.tier
    if isinstance(compression, str):
        if compression not in WIRE_TIERS:
            raise ValueError(
                f"unknown wire-compression tier {compression!r}; choose "
                f"one of {WIRE_TIERS}")
        return compression
    if isinstance(compression, type) and issubclass(compression, Compressor):
        wire = getattr(compression, "wire_dtype", None)
        if wire == torch.float16:
            return "fp16"
        if wire == torch.bfloat16:
            return "bf16"
        return "none"
    if hasattr(compression, "compress") and hasattr(compression,
                                                    "decompress"):
        return "none"           # a custom compressor stays per leaf
    raise TypeError(
        f"compression must be a tier string ({'/'.join(WIRE_TIERS)}), a "
        f"Compression.* class, a compress/decompress object, or a "
        f"WireCodec; got {type(compression).__name__}")


# Per-leaf Compressor of each tier, for the paths that compress leaf by
# leaf. fp8 has no per-leaf form (it needs the bucket's shared scale).
_TIER_LEAF_COMPRESSOR = {
    "none": NoneCompressor,
    "bf16": FP16Compressor,
    "fp16": _FP16IEEECompressor,
    "fp8_e4m3": NoneCompressor,
    "fp8_e5m2": NoneCompressor,
}


def as_compressor(compression):
    """A per-leaf :class:`Compressor` for ``compression``: tier strings and
    codecs map through their tier; Compressor classes and duck-typed
    compress/decompress objects pass through."""
    if compression is None:
        return NoneCompressor
    if isinstance(compression, WireCodec):
        return _TIER_LEAF_COMPRESSOR[compression.tier]
    if isinstance(compression, str):
        return _TIER_LEAF_COMPRESSOR[tier_for(compression)]
    return compression


def active_wire_tier(compression=None) -> str:
    """The effective tier: ``HOROVOD_GRADIENT_COMPRESSION`` when set to
    anything but 'none', else the tier ``compression`` implies."""
    knob = str(knobs.get("HOROVOD_GRADIENT_COMPRESSION"))
    if knob and knob != "none":
        return knob
    return tier_for(compression)


def wire_codec(compression=None) -> Optional[WireCodec]:
    """:class:`WireCodec` of the effective tier, or None."""
    tier = active_wire_tier(compression)
    return WireCodec(tier) if tier != "none" else None


def error_feedback_enabled(codec: Optional[WireCodec]) -> bool:
    """``HOROVOD_GRADIENT_ERROR_FEEDBACK``: 'auto' (on for the low-bit fp8
    tiers), '1' (any lossy tier), '0' (never)."""
    if codec is None:
        return False
    mode = str(knobs.get("HOROVOD_GRADIENT_ERROR_FEEDBACK")).lower()
    if mode in ("0", "false", "off", "no"):
        return False
    if mode in ("1", "true", "on", "yes"):
        return True
    return codec.low_bit
