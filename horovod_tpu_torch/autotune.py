"""Bucket-size and DCN-schedule resolution of the gradient sync: the
port's part of ``horovod_tpu/autotune.py`` (``DEFAULT_BUCKET_BYTES``,
``resolve_bucket_bytes`` l.893, ``resolve_dcn_schedule`` and
``_dcn_tier_present`` l.674-712).

The JAX package resolves ``HOROVOD_GRADIENT_BUCKET_BYTES=auto`` from an
AOT sweep cache keyed by the gradient shapes and the world size. That
cache (and the online tuner) belongs to a later slice; here ``auto``
resolves to the default with the one-time warning the JAX package gives
on a cache miss.

``HOROVOD_DCN_SCHEDULE=auto`` is scored in the JAX package by a cost model
whose constants are a TPU's (100 GB/s ICI, 12.5 GB/s DCN, l.497-506). The
port carries none of them: ``auto`` resolves ``flat``, and says so once,
until NVLink and the network between hosts are measured on the card.
``flat`` and ``two_level`` give the same sums up to their order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Set, Tuple

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger

DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024

_auto_warned: Set[Tuple] = set()


def grad_signature(leaves: Sequence[Tuple[tuple, object]], world: int
                   ) -> Tuple:
    """The (gradient shapes and dtypes, world) key of the sweep cache."""
    return (tuple((tuple(s), str(d)) for s, d in leaves), int(world))


def resolve_bucket_bytes(leaves: Optional[Sequence[Tuple[tuple, object]]]
                         = None, world: Optional[int] = None) -> int:
    """The effective gradient bucket size in bytes (0 = one bucket).

    A number passes through. ``auto`` resolves to
    :data:`DEFAULT_BUCKET_BYTES` and warns once per (``leaves`` = [(shape,
    dtype)], ``world``) key that no sweep winner is cached."""
    raw = knobs.get("HOROVOD_GRADIENT_BUCKET_BYTES")
    if raw != "auto":
        return int(raw or 0)
    key = grad_signature(leaves or (), world or 0)
    if key not in _auto_warned:
        _auto_warned.add(key)
        get_logger("horovod_tpu_torch.autotune").warning(
            "HOROVOD_GRADIENT_BUCKET_BYTES=auto: no cached sweep winner for "
            "this model and world size (the sweep cache is not ported) — "
            "using the %d MiB default.", DEFAULT_BUCKET_BYTES >> 20)
    return DEFAULT_BUCKET_BYTES


_dcn_auto_logged: Set[bool] = set()


def resolve_dcn_schedule(payload_bytes: int, ici_world: int,
                         dcn_world: int) -> str:
    """The schedule of one sync whose axes cross the DCN tier: 'flat' when
    either tier has one rank, else HOROVOD_DCN_SCHEDULE, with 'auto'
    resolving 'flat' (see the module docstring)."""
    mode = str(knobs.get("HOROVOD_DCN_SCHEDULE"))
    if int(dcn_world) <= 1 or int(ici_world) <= 1:
        return "flat"
    if mode != "auto":
        return mode
    if not _dcn_auto_logged:
        _dcn_auto_logged.add(True)
        get_logger("horovod_tpu_torch.autotune").info(
            "HOROVOD_DCN_SCHEDULE=auto resolves 'flat': the ICI-vs-DCN "
            "cost model's constants are a TPU's and the card's links are "
            "not measured yet; set 'two_level' to force the tier.")
    return "flat"


def _dcn_tier_present() -> bool:
    """Whether this run has a DCN tier the schedule could steer: a
    virtual-slice or mesh knob, or an initialized topology with the
    ``hvd_dcn`` axis."""
    if int(knobs.get("HOROVOD_DCN_VIRTUAL_SLICES") or 0) > 1:
        return True
    if str(knobs.get("HOROVOD_DCN_MESH") or "").strip():
        return True
    from horovod_tpu_torch.runtime import context
    if not context.is_initialized():
        return False
    return context.get_context().topology.has_dcn
