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
from typing import Any, Callable, Dict


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Knob:
    name: str
    default: Any
    type: Callable[[str], Any]
    help: str = ""


class KnobRegistry:
    """Values resolve as: environment variable > default."""

    def __init__(self):
        self._knobs: Dict[str, Knob] = {}

    def register(self, name, default, type=str, help=""):
        if type is bool:
            type = _parse_bool
        self._knobs[name] = Knob(name, default, type, help)
        return self._knobs[name]

    def get(self, name: str) -> Any:
        knob = self._knobs[name]
        raw = os.environ.get(name)
        if raw is None or raw == "":
            return knob.default
        return knob.type(raw)


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
