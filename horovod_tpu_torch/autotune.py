"""Bucket-size resolution of the gradient sync: the port's part of
``horovod_tpu/autotune.py`` (``DEFAULT_BUCKET_BYTES``,
``resolve_bucket_bytes`` l.893).

The JAX package resolves ``HOROVOD_GRADIENT_BUCKET_BYTES=auto`` from an
AOT sweep cache keyed by the gradient shapes and the world size. That
cache (and the online tuner) belongs to a later slice; here ``auto``
resolves to the default with the one-time warning the JAX package gives
on a cache miss.
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
