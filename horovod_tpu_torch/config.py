"""Typed runtime-knob registry of the PyTorch port.

The same convention as ``horovod_tpu/config.py``: every knob is a
``HOROVOD_*`` environment variable with a typed default. The port
registers only the knobs its modules read, under the same names and
defaults, so one environment configures both packages. It keeps its own
copy because importing ``horovod_tpu`` pulls in JAX.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


def _parse_size(v) -> int:
    """Byte size with optional kb/mb/gb (or k/m/g) suffix: '8MB' -> 8388608."""
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    for suffix, mult in (("gb", 1 << 30), ("mb", 1 << 20), ("kb", 1 << 10),
                         ("g", 1 << 30), ("m", 1 << 20), ("k", 1 << 10),
                         ("b", 1)):
        if s.endswith(suffix):
            return int(float(s[:-len(suffix)]) * mult)
    return int(float(s))


def _parse_bucket_bytes(v):
    """Gradient bucket size: a byte size (suffixes allowed), or 'auto'
    (``autotune.resolve_bucket_bytes``)."""
    if str(v).strip().lower() == "auto":
        return "auto"
    return _parse_size(v)


@dataclasses.dataclass
class Knob:
    name: str
    default: Any
    type: Callable[[str], Any]
    help: str = ""
    choices: Optional[tuple] = None


class KnobRegistry:
    """Values resolve as: programmatic override > environment variable >
    default."""

    def __init__(self):
        self._knobs: Dict[str, Knob] = {}
        self._overrides: Dict[str, Any] = {}

    def register(self, name, default, type=str, help="", choices=None):
        if type is bool:
            type = _parse_bool
        self._knobs[name] = Knob(name, default, type, help, choices)
        return self._knobs[name]

    def get(self, name: str) -> Any:
        knob = self._knobs[name]
        if name in self._overrides:
            return self._overrides[name]
        raw = os.environ.get(name)
        if raw is None or raw == "":
            return knob.default
        val = knob.type(raw)
        if knob.choices is not None and val not in knob.choices:
            raise ValueError(
                f"{name}={val!r} not in allowed choices {knob.choices}")
        return val

    def set_override(self, name: str, value: Any) -> None:
        if name not in self._knobs:
            raise KeyError(f"unknown knob {name}")
        self._overrides[name] = value

    def clear_override(self, name: str) -> None:
        self._overrides.pop(name, None)


knobs = KnobRegistry()

knobs.register("HOROVOD_LOG_LEVEL", "warning", str,
               help="trace|debug|info|warning|error|fatal.")
knobs.register("HOROVOD_LOG_HIDE_TIMESTAMP", False, bool,
               help="Hide timestamps in log output.")

# Serving knobs (horovod_tpu_torch/serving/), read at engine build time
# unless noted.
knobs.register("HOROVOD_SERVE_SLOTS", 8, int,
               help="Decode batch slots of the serving engine; the "
                    "continuous-batching scheduler admits requests into "
                    "free slots at step boundaries.")
knobs.register("HOROVOD_SERVE_PAGE", 128, int,
               help="Tokens per KV-cache page (the PagedAttention "
                    "granularity). Any page size runs the CUDA "
                    "paged-decode kernel.")
knobs.register("HOROVOD_SERVE_MAX_SEQ", 2048, int,
               help="Per-request context ceiling (prompt + generated "
                    "tokens); sets the block-table width.")
knobs.register("HOROVOD_SERVE_PAGES", 0, int,
               help="Total pages in the KV pool; 0 = slots x "
                    "ceil(max_seq/page).")
knobs.register("HOROVOD_SERVE_PREFILL_CHUNK", 256, int,
               help="Prefill chunk ceiling in tokens; prompts prefill "
                    "in power-of-two buckets up to this cap.")
knobs.register("HOROVOD_SERVE_QUEUE_DEADLINE", 0.001, float,
               help="Seconds the scheduler waits for traffic when every "
                    "slot is idle.")
knobs.register("HOROVOD_SERVE_MAX_NEW_TOKENS", 128, int,
               help="Default generation cap per request.")
knobs.register("HOROVOD_SERVE_PREFIX_CACHE", False, bool,
               help="Shared-prefix KV page reuse with copy-on-write.")
knobs.register("HOROVOD_SERVE_DRAFT", "off", str,
               help="Speculative-decode drafter. Only 'off' is ported; "
                    "any other value raises.")
knobs.register("HOROVOD_SERVE_SPEC_K", 4, int,
               help="Draft tokens per speculative step (unused while "
                    "HOROVOD_SERVE_DRAFT=off).")

# Training knobs (ops/blockwise_ce.py, ops/fusion.py), read at each call.
# The flash kernels fix their tiles at compile time, so the JAX package's
# HOROVOD_FLASH_BLOCK_Q/_K have no counterpart here.
knobs.register("HOROVOD_CE_BLOCK_VOCAB", 1024, int,
               help="Vocab chunk width of the blockwise fused "
                    "cross-entropy (0 = unfused reference path, which "
                    "materializes the [.., V] logits).")
knobs.register("HOROVOD_BATCH_D2D_MEMCOPIES", True, bool,
               help="Pack same-dtype tensors into one buffer per fused "
                    "collective; 0 runs one collective per tensor.")

# Gradient-sync knobs (parallel/distributed.py, compression.py), read when
# a DistributedOptimizer or DistributedApply plans its buckets (the first
# step) and, for the tier, when it is built.
knobs.register("HOROVOD_GRADIENT_BUCKET_BYTES", 25 * 1024 * 1024,
               _parse_bucket_bytes,
               help="Split the gradient list into contiguous buckets of at "
                    "most this many bytes in reverse backward order; each "
                    "bucket's collective is launched from the gradient "
                    "hooks as soon as its gradients are complete, so it "
                    "overlaps the rest of the backward. 0 = one fused sync "
                    "per dtype after the backward. 'auto' = the 25 MiB "
                    "default with a warning (the sweep cache is not "
                    "ported).")
knobs.register("HOROVOD_GRADIENT_COMPRESSION", "none", str,
               choices=("none", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2"),
               help="Wire dtype of the bucketed gradient collectives "
                    "(compression.WireCodec): each packed bucket is cast to "
                    "it before the SUM and decoded after; fp8 tiers carry "
                    "one global-amax scale per bucket. Overrides the tier "
                    "implied by a compression= argument unless 'none'.")
knobs.register("HOROVOD_GRADIENT_ERROR_FEEDBACK", "auto", str,
               help="Error-feedback residual for lossy wire tiers: 'auto' "
                    "= on for fp8, off for bf16/fp16; '1' always; '0' "
                    "never. Costs one f32 copy of the gradients.")

# Topology knobs (runtime/topology.py), read by ``init``; the collective
# knobs are read at each call. The same names and defaults as the JAX
# package's.
knobs.register("HOROVOD_HIERARCHICAL_ALLREDUCE", False, bool,
               help="Two-level (cross, local) topology: init builds a "
                    "(hvd_cross, hvd_local) mesh with local = "
                    "LOCAL_WORLD_SIZE (or a balanced factor), the axes "
                    "of hierarchical_allreduce.")
knobs.register("HOROVOD_HIERARCHICAL_ALLGATHER", False, bool,
               help="allgather over several axes gathers axis by axis, "
                    "innermost first; the result equals the flat "
                    "gather's.")
knobs.register("HOROVOD_TORUS_ALLREDUCE", False, bool,
               help="Same topology as HOROVOD_HIERARCHICAL_ALLREDUCE: "
                    "reduce-scatter over local, allreduce over cross, "
                    "allgather over local (torus_allreduce).")
knobs.register("HOROVOD_DCN_MESH", "", str,
               help="Two-tier mesh shape 'dcn,local' or "
                    "'dcn,cross,local', outermost first; the leading dim "
                    "(>= 2) is the slow hvd_dcn tier that "
                    "two_level_allreduce and HOROVOD_DCN_SCHEDULE key "
                    "off. Wins over HOROVOD_DCN_VIRTUAL_SLICES.")
knobs.register("HOROVOD_DCN_VIRTUAL_SLICES", 0, int,
               help="Split the ranks into this many equal contiguous "
                    "groups and build the (hvd_dcn, ...) mesh over them; "
                    "0/1 = none. GPUs have no slices, so this (or "
                    "HOROVOD_DCN_MESH, or init(dcn=)) is the only way "
                    "the port gets a DCN tier.")
knobs.register("HOROVOD_DCN_SCHEDULE", "auto", str,
               choices=("flat", "two_level", "auto"),
               help="Gradient-sync schedule when the sync axes cross "
                    "hvd_dcn: 'flat' = one SUM over every axis, "
                    "'two_level' = reduce-scatter over the other axes, "
                    "SUM of the owned shard over hvd_dcn (the only stage "
                    "the wire codec narrows), all-gather back; 'auto' "
                    "resolves 'flat' in the port until NVLink and the "
                    "network are measured on the card "
                    "(autotune.resolve_dcn_schedule).")
knobs.register("HOROVOD_TPU_MESH_SHAPE", "", str,
               help="Comma-separated mesh shape, e.g. '4,2'; empty = 1D "
                    "over all ranks.")
knobs.register("HOROVOD_TPU_MESH_AXES", "", str,
               help="Comma-separated axis names matching "
                    "HOROVOD_TPU_MESH_SHAPE.")
