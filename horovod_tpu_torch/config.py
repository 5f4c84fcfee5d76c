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


def _parse_fusion_threshold(v):
    """Fusion threshold: a plain byte size, or the per-axis form
    'local:64MB,cross:8MB' for hierarchical meshes, where the fast local
    axis and the slow cross axis want different bin capacities. Returns an
    int (uniform) or a {'local': int, 'cross': int} dict."""
    s = str(v)
    if ":" not in s:
        return _parse_size(s)
    out = {}
    for part in s.split(","):
        kind, _, size = part.partition(":")
        kind = kind.strip().lower()
        if kind not in ("local", "cross"):
            raise ValueError(
                f"per-axis fusion threshold keys must be local/cross, "
                f"got {kind!r} in {s!r}")
        out[kind] = _parse_size(size)
    return out


def _parse_ckpt_interval(v):
    """Checkpoint cadence: a step count, or 'auto' (CheckFreq-style tuning
    against the measured mean step time, resilience/async_checkpoint).
    0 disables interval-driven saves (explicit ``save()`` still works)."""
    s = str(v).strip().lower()
    if s == "auto":
        return "auto"
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
    tunable: bool = False         # the online tuner may override it
    choices: Optional[tuple] = None


class KnobRegistry:
    """Values resolve as: programmatic override > environment variable >
    default."""

    def __init__(self):
        self._knobs: Dict[str, Knob] = {}
        self._overrides: Dict[str, Any] = {}

    def register(self, name, default, type=str, help="", tunable=False,
                 choices=None):
        if type is bool:
            type = _parse_bool
        self._knobs[name] = Knob(name, default, type, help, tunable, choices)
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

    def is_set(self, name: str) -> bool:
        """Whether an override or the environment gives ``name`` a
        value."""
        self._knobs[name]
        return name in self._overrides or bool(os.environ.get(name))

    def set_override(self, name: str, value: Any) -> None:
        if name not in self._knobs:
            raise KeyError(f"unknown knob {name}")
        self._overrides[name] = value

    def clear_override(self, name: str) -> None:
        self._overrides.pop(name, None)

    def clear_all_overrides(self) -> None:
        self._overrides.clear()

    def knobs(self) -> Dict[str, Knob]:
        return dict(self._knobs)

    def snapshot(self) -> Dict[str, Any]:
        """Every registered knob's resolved value."""
        return {k: self.get(k) for k in self._knobs}


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
               help="Speculative-decode drafter: 'off' (plain decode), "
                    "'ngram[:N]' (host-side n-gram lookup over the "
                    "request's own history, order N, default 3 — no "
                    "extra device work), or 'truncate:N' (self-draft "
                    "from the target's first N layers, sharing the KV "
                    "page pool; verify overwrites the draft's page "
                    "writes with identical values). Read at engine "
                    "build time.")
knobs.register("HOROVOD_SERVE_SPEC_K", 4, int,
               help="Draft tokens proposed per slot per speculative "
                    "step; ONE verify step scores all K+1 positions per "
                    "slot in a single decode-shaped step (batch slots x "
                    "(K+1)), committing 1..K+1 tokens under the greedy "
                    "accept-prefix rule. Read at engine build time; "
                    "ignored while HOROVOD_SERVE_DRAFT=off.")

# Fleet knobs (serving/fleet.py: replicas behind one router, the occupancy
# autoscaler, drain-safe lifecycle): the JAX package's names and defaults.
knobs.register("HOROVOD_FLEET_REPLICAS", 1, int,
               help="Initial serving replicas a ServingFleet boots "
                    "with (each its own ServeEngine + scheduler; the "
                    "kernels are built once per build directory, so "
                    "every replica after the first constructs warm with "
                    "builds==0). Clamped up to "
                    "HOROVOD_FLEET_MIN_REPLICAS.")
knobs.register("HOROVOD_FLEET_MIN_REPLICAS", 1, int,
               help="Autoscaler floor: scale-down never drains below "
                    "this many READY replicas, and a replica kill with "
                    "no survivors grows back to at least one before "
                    "re-admitting the dead replica's requests.")
knobs.register("HOROVOD_FLEET_MAX_REPLICAS", 4, int,
               help="Autoscaler ceiling: scale-up stops here no matter "
                    "the queue depth (the device-memory bound — each "
                    "replica holds a full KV page pool).")
knobs.register("HOROVOD_FLEET_SCALE_UP_DEPTH", 8, int,
               help="Queue-depth-per-ready-replica threshold of the "
                    "occupancy autoscaler (the hvd_serve_queue_depth "
                    "signal): when queued requests exceed this many "
                    "per READY replica, the fleet grows one replica in "
                    "the SAME scheduling cycle the pressure is "
                    "observed.")
knobs.register("HOROVOD_FLEET_SCALE_DOWN_IDLE", 64, int,
               help="Consecutive fully-idle fleet cycles (no queued, "
                    "prefilling, or decoding request anywhere) before "
                    "the autoscaler drains the newest replica. Drain "
                    "is admission-stop + run-to-completion — never a "
                    "drop.")
knobs.register("HOROVOD_FLEET_COOLDOWN", 16, int,
               help="Minimum fleet cycles between two autoscale "
                    "events (grow or drain) — the anti-flap guard; "
                    "chaos replica kills and operator drains are not "
                    "throttled by it.")
knobs.register("HOROVOD_FLEET_AFFINITY", True, bool,
               help="Prefix-affinity routing: a request whose prompt "
                    "prefix is resident in some replica's hash-chain "
                    "index routes there (shared pages only hit when "
                    "common-prefix requests land on the SAME replica). "
                    "Off, placement is pure "
                    "join-shortest-queue.")

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
                    "per dtype after the backward. 'auto' = the winner "
                    "cached for (gradient shapes, world size) in "
                    "HOROVOD_BUCKET_AUTO_CACHE by a measured sweep "
                    "(autotune.sweep_bucket_bytes); a miss takes the 25 "
                    "MiB default with a warning, and in a world of several "
                    "ranks rank 0's resolution is adopted by every rank "
                    "over the c10d store.")
knobs.register("HOROVOD_GRADIENT_COMPRESSION", "none", str,
               choices=("none", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2"),
               help="Wire dtype of the bucketed gradient collectives "
                    "(compression.WireCodec): each packed bucket is cast to "
                    "it before the SUM and decoded after; fp8 tiers carry "
                    "one global-amax scale per bucket. Overrides the tier "
                    "implied by a compression= argument unless 'none'.",
               tunable=True)
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
                    "of hierarchical_allreduce.",
               tunable=True)
knobs.register("HOROVOD_HIERARCHICAL_ALLGATHER", False, bool,
               help="allgather over several axes gathers axis by axis, "
                    "innermost first; the result equals the flat "
                    "gather's.",
               tunable=True)
knobs.register("HOROVOD_TORUS_ALLREDUCE", False, bool,
               help="Same topology as HOROVOD_HIERARCHICAL_ALLREDUCE: "
                    "reduce-scatter over local, allreduce over cross, "
                    "allgather over local (torus_allreduce).",
               tunable=True)
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
                    "(autotune.resolve_dcn_schedule).",
               tunable=True)
knobs.register("HOROVOD_TPU_MESH_SHAPE", "", str,
               help="Comma-separated mesh shape, e.g. '4,2'; empty = 1D "
                    "over all ranks.")
knobs.register("HOROVOD_TPU_MESH_AXES", "", str,
               help="Comma-separated axis names matching "
                    "HOROVOD_TPU_MESH_SHAPE.")
knobs.register("HOROVOD_TPU_MATMUL_PRECISION", "default", str,
               help="Precision of the f32 products and convolutions of "
                    "each train step the trainers build, under the JAX "
                    "package's names (precision.py): 'float32'/'highest' "
                    "(IEEE f32), 'tensorfloat32'/'high' (TF32), "
                    "'bfloat16' (bf16 inputs, f32 accumulation: the "
                    "port's own f32 products, the blockwise CE's, take "
                    "bf16 inputs; cuBLAS's other f32 products and cuDNN's "
                    "convolutions have no bf16 flag and take TF32), and "
                    "the dot-algorithm presets F32_F32_F32, TF32_TF32_F32 "
                    "and BF16_BF16_F32. Read when the step is built; a "
                    "name jax.default_matmul_precision refuses is refused "
                    "there. The step sets torch's CUDA flags on entry and "
                    "restores the caller's on exit, never "
                    "torch.set_float32_matmul_precision: CPU products stay "
                    "IEEE f32. The cuBLAS and cuDNN flags are process-wide "
                    "while a step runs: a serving fleet's threads in the "
                    "same process run their f32 products in TF32 "
                    "meanwhile (a warning says so when the step is built). 'default' changes nothing, which on the card "
                    "means torch's own defaults: f32 products in IEEE, "
                    "cuDNN convolutions in TF32. The hand-written kernels "
                    "(flash attention, conv+BN's f32 route) ignore the "
                    "knob, as Pallas kernels ignore JAX's.")

# Resilience knobs (resilience/: async off-step-path checkpointing,
# preemption-aware auto-resume, chaos drills), read when an
# AsyncCheckpointer or PreemptionHandler is built and by train_loop.
knobs.register("HOROVOD_CKPT_DIR", "", str,
               help="Checkpoint directory of resilience.AsyncCheckpointer: "
                    "crash-safe manifest-committed snapshots with newest-k "
                    "rotation. Read by parallel.trainer.train_loop; empty "
                    "disables loop-managed checkpointing.")
knobs.register("HOROVOD_CKPT_INTERVAL", "auto", _parse_ckpt_interval,
               help="Steps between async snapshots, or 'auto': tune the "
                    "save frequency against the measured mean step time "
                    "(StepStats' hvd_step_duration_seconds) so the "
                    "on-step-path cost (the device->host copy) stays under "
                    "HOROVOD_CKPT_OVERHEAD_BUDGET of step time. 0 disables "
                    "interval-driven saves.")
knobs.register("HOROVOD_CKPT_OVERHEAD_BUDGET", 0.05, float,
               help="Ceiling of the on-path checkpoint cost as a fraction "
                    "of step time under HOROVOD_CKPT_INTERVAL=auto.")
knobs.register("HOROVOD_CKPT_KEEP", 3, int,
               help="Newest-k rotation depth. Older committed snapshots "
                    "are deleted only after the new manifest is "
                    "committed.")
knobs.register("HOROVOD_CKPT_FORMAT", "auto", str,
               choices=("auto", "orbax", "pickle"),
               help="Serialization of the snapshots: 'pickle' (one shard "
                    "file per rank); 'auto' resolves to pickle. 'orbax' "
                    "is the JAX package's and raises ValueError here.")
knobs.register("HOROVOD_CKPT_COMMIT_TIMEOUT", 120.0, float,
               help="Multi-rank commit barrier: seconds rank 0 waits for "
                    "every rank's shard (and the others for rank 0's "
                    "commit record) over the c10d store before the "
                    "attempt is abandoned uncommitted.")
knobs.register("HOROVOD_PREEMPTION_FILE", "", str,
               help="Sentinel file watched by resilience.PreemptionHandler: "
                    "when it appears, training quiesces at an agreed step, "
                    "commits a final synchronous snapshot and returns the "
                    "resumable exit code 75. Files older than the handler "
                    "are ignored. SIGTERM/SIGINT trigger the same path.")
knobs.register("HOROVOD_PREEMPTION_POLL_SECONDS", 1.0, float,
               help="Poll interval of the preemption sentinel watcher.")
knobs.register("HOROVOD_PREEMPTION_QUIESCE_MARGIN", 2, int,
               help="Steps the first preempted rank adds to its current "
                    "step when it publishes the agreed stop step over the "
                    "c10d store.")
knobs.register("HOROVOD_CHAOS_SPEC", "", str,
               help="JSON fault-injection spec of resilience.chaos (tests "
                    "and drills only), e.g. '{\"kill\": {\"1:17\": 9}, "
                    "\"commit_deny\": [5], \"preempt_at\": 12}'. The "
                    "grammar is the JAX package's. Empty disables all "
                    "injection.")

# Fault-domain knobs (resilience/faults.py), read when a site's retry
# policy is first built.
knobs.register("HOROVOD_FAULT_RETRY_DEADLINE", 30.0, float,
               help="Default total retry budget in seconds per "
                    "control-plane call site (backoff included).")
knobs.register("HOROVOD_FAULT_RETRIES", 5, int,
               help="Default attempt ceiling per control-plane call.")
knobs.register("HOROVOD_FAULT_RETRY_BASE", 0.1, float,
               help="Base backoff in seconds: attempt k waits base*2^k, "
                    "capped at HOROVOD_FAULT_RETRY_MAX_BACKOFF, minus a "
                    "deterministic jitter fraction.")
knobs.register("HOROVOD_FAULT_RETRY_MAX_BACKOFF", 5.0, float,
               help="Backoff ceiling in seconds of the default policy.")
knobs.register("HOROVOD_FAULT_RETRY_JITTER", 0.2, float,
               help="Deterministic jitter fraction [0,1) subtracted from "
                    "each backoff; 0 disables jitter.")
knobs.register("HOROVOD_FAULT_POLICIES", "", str,
               help="JSON per-site retry-policy overrides, e.g. "
                    "'{\"checkpoint_commit\": {\"deadline_s\": 120}}'.")
knobs.register("HOROVOD_FAULT_PROBE_SECONDS", 5.0, float,
               help="How often a shed optional site gets one probe "
                    "operation through (degraded mode heals on success).")
knobs.register("HOROVOD_FAULT_HEARTBEAT_SECONDS", 2.0, float,
               help="Cadence of a data-service worker's heartbeat to "
                    "its registry (data/compute_service.py).")
knobs.register("HOROVOD_FAULT_WORKER_DEADLINE", 10.0, float,
               help="Heartbeat age after which a data-service worker is "
                    "declared dead; also a consumer's socket timeout.")

# Tracing and goodput knobs (tracing/, goodput/), read at init and when
# the recorder is enabled.
knobs.register("HOROVOD_TRACE", False, bool,
               help="Enable the span recorder at init: trace.span(...) "
                    "records the train loop, checkpoint and preemption "
                    "spans into a per-process ring buffer. Off, span() "
                    "returns a shared no-op.")
knobs.register("HOROVOD_TRACE_BUFFER_SPANS", 16384, int,
               help="Capacity of the span ring buffer; the oldest spans "
                    "fall off.")
knobs.register("HOROVOD_TRACE_DIR", "", str,
               help="Directory of flight recordings; empty = '.hvdtrace' "
                    "under the working directory.")
knobs.register("HOROVOD_TRACE_PROFILE", "", str,
               help="Programmatic torch.profiler capture window of "
                    "train_loop: 'steps:N' (capture N steps starting at "
                    "step 2, skipping the first) or 'steps:N@S' (starting "
                    "at step S). The exported Chrome trace is parsed with "
                    "a stdlib-only reader, device ops are classified "
                    "collective (NCCL kernels) vs compute, and the observed "
                    "overlap ratio, exposed-collective seconds and "
                    "per-bucket (hvd_bucket<i>) device seconds are written "
                    "to profile_attribution.json under the trace dir's "
                    "'profile' folder and exported as the "
                    "hvd_overlap_observed_ratio and "
                    "hvd_step_exposed_collective_seconds gauges "
                    "(tracing/profile.py). One window per loop. Empty "
                    "disables.")
knobs.register("HOROVOD_GOODPUT", True, bool,
               help="Goodput accountant: every second of run wall time is "
                    "attributed to one phase (init, compile, step_compute, "
                    "exposed_collective, input_wait, checkpoint, restart, "
                    "degraded, idle); goodput_report() reads it.")
knobs.register("HOROVOD_GOODPUT_LEDGER", "", str,
               help="Path of the append-only per-run JSONL ledger "
                    "(goodput/ledger.py): one record per run at shutdown() "
                    "with the goodput phase breakdown, numerics summary, "
                    "wire and serving blocks and the knob fingerprint. "
                    "The history regression_report() reads. Empty "
                    "disables.")
knobs.register("HOROVOD_GOODPUT_REGRESSION_TOLERANCE", 0.05, float,
               help="Regression sentinel (goodput.ledger."
                    "regression_report): allowed fractional drop of "
                    "throughput vs the best prior BENCH round, and "
                    "absolute drop of goodput fraction vs the best "
                    "prior ledger record, before the verdict flips to "
                    "'regress' (0.05 = 5%).")
knobs.register("HOROVOD_NUMERICS", False, bool,
               help="Numerics-health telemetry (goodput/numerics.py): the "
                    "eager coordinator's allreduce bins give per-tensor "
                    "nonfinite counts and squared norms (a segmented "
                    "reduction over each fused buffer, a fixed number of "
                    "launches a bin) and train_loop the loss; streaming "
                    "detectors (loss spike, grad-norm explosion, nonfinite "
                    "localized to its tensor) fire flight recordings and "
                    "hvd_numerics_anomalies_total. Read when a bin's plan "
                    "is made (it keys the plan) and when train_loop "
                    "starts.")
knobs.register("HOROVOD_NUMERICS_CHECK_EVERY", 10, int,
               help="Numerics monitor cadence: buffered device scalars "
                    "are converted and run through the detectors every "
                    "this many observations, so the forced device->host "
                    "sync happens at the cadence, not per step.")
knobs.register("HOROVOD_NUMERICS_ACTION", "warn", str,
               choices=("warn", "degrade", "abort"),
               help="Response when a numerics detector fires (a flight "
                    "recording + counter always ship): 'warn' logs "
                    "only; 'degrade' sheds the optional 'numerics' "
                    "fault-domain site so /healthz flips to degraded "
                    "until a clean check heals it; 'abort' raises "
                    "NumericsAnomalyError into the training loop.")
knobs.register("HOROVOD_NUMERICS_SPIKE_SIGMA", 6.0, float,
               help="Loss-spike detector threshold: anomaly when a loss "
                    "lands this many trailing standard deviations above "
                    "its EWMA mean (after warmup).")
knobs.register("HOROVOD_NUMERICS_GRADNORM_FACTOR", 10.0, float,
               help="Grad-norm explosion threshold: anomaly when the "
                    "global gradient norm exceeds this multiple of its "
                    "trailing EWMA (after warmup).")
knobs.register("HOROVOD_VERIFY_STEP", "0", str,
               choices=("0", "1", "strict"),
               help="IR-tier step verification at train_loop start. Not "
                    "ported yet (ROADMAP A.15): train_loop raises on 1 or "
                    "strict.")
knobs.register("HOROVOD_ARTIFACT_STORE", "", str,
               help="Directory of the persistent compiled-artifact store: "
                    "the nvcc-built kernel libraries, the eager "
                    "coordinator's fused plans and the train step's and "
                    "serving engine's kernel manifests, shared by every "
                    "process pointed at it, so a resumed or respawned rank "
                    "or a joining replica runs no nvcc build on a warm "
                    "store. Entries publish with the crash-safe "
                    ".tmp-then-rename protocol; corrupt, truncated or "
                    "version-skewed entries log and fall back to a build. "
                    "Empty disables the store.")
knobs.register("HOROVOD_ARTIFACT_STORE_MAX_BYTES", 2 * 1024 * 1024 * 1024,
               _parse_size,
               help="Size budget of the compiled-artifact store: after each "
                    "publish, oldest-mtime entries are evicted (LRU — hits "
                    "re-touch mtime) until the store fits. Accepts kb/mb/gb "
                    "suffixes. 0 = unlimited.")

# Eager-API knobs (eager.py, stall_inspector.py), read at each handle's
# start and wait. The same names and defaults as the JAX package's.
knobs.register("HOROVOD_STALL_CHECK_TIME_SECONDS", 60, int,
               help="Warn when an async collective handle is outstanding "
                    "this long (ref stall_inspector.cc:26).")
knobs.register("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0, int,
               help="Abort the job after a stall persists this long; 0 "
                    "disables (ref stall_inspector.cc).")
knobs.register("HOROVOD_STALL_CHECK_DISABLE", False, bool,
               help="Disable the stall inspector.")
knobs.register("HOROVOD_ELASTIC", False, bool,
               help="Elastic mode: a collective that fails in an async "
                    "handle's wait() raises elastic.HorovodInternalError, "
                    "the error elastic.run recovers from, instead of its "
                    "own error (ref nccl_operations.h:55). The elastic "
                    "launcher sets it for its workers.")

# Control-plane knobs (ops/coordinator.py, ops/divergence.py,
# timeline.py, native/): the JAX package's names, defaults and parsers.
# The coordinator reads them at each enqueue and cycle.
knobs.register("HOROVOD_FUSION_THRESHOLD", 128 * 1024 * 1024,
               _parse_fusion_threshold,
               help="Bin capacity of the coordinator's fusion cycle in "
                    "bytes, counted as the JAX package counts them: a "
                    "tensor's rank-stacked size (world x one rank's). "
                    "Accepts size suffixes ('64MB') and, on hierarchical "
                    "meshes, the per-axis form 'local:64MB,cross:8MB'. In "
                    "a world of several ranks the queue also flushes when "
                    "its bytes reach this (floored at 4 KiB).",
               tunable=True)
knobs.register("HOROVOD_FUSION_THRESHOLD_CROSS", 0, _parse_size,
               help="Bin capacity for collectives whose traffic crosses "
                    "the slow outer mesh axis; 0 falls back to "
                    "HOROVOD_FUSION_THRESHOLD.",
               tunable=True)
knobs.register("HOROVOD_CYCLE_TIME", 1.0, float,
               help="Batching window in ms of the coordinator's cycle "
                    "thread (a world of one): the time it waits after the "
                    "first enqueue before it drains the queue.",
               tunable=True)
knobs.register("HOROVOD_CACHE_CAPACITY", 1024, int,
               help="Entries of the coordinator's LRU of fused plans (ref "
                    "global_state.h:89); an eviction frees the plan's "
                    "fusion buffers.")
knobs.register("HOROVOD_DISABLE_GROUP_FUSION", False, bool,
               help="Keep registered groups (grouped_allreduce_async) from "
                    "fusing with other tensors (ref controller.cc:214-238).")
knobs.register("HOROVOD_ENABLE_ASYNC_COMPLETION", True, bool,
               help="A coordinator handle resolves at dispatch, ordered on "
                    "the stream (wait() then waits for the bin's CUDA "
                    "event); 0 makes the cycle wait for the event before it "
                    "resolves the handles (ref gpu_operations.cc:93-115).")
knobs.register("HOROVOD_NUM_STREAMS", 1, int,
               help="CUDA streams the coordinator's bins go on, bin i on "
                    "stream i mod N. Bins are always issued from the "
                    "cycle's thread in plan order, so every rank issues its "
                    "collectives in one order.")
knobs.register("HOROVOD_METRICS_PORT", 0, int,
               help="Port for the background HTTP metrics server serving "
                    "Prometheus text-format /metrics and a /healthz that "
                    "reflects stall/elastic state; 0 disables. Bound on "
                    "every process; in a world of several processes rank "
                    "0 additionally serves cluster-wide sums aggregated "
                    "from the other ranks' snapshots over the c10d store.")
knobs.register("HOROVOD_METRICS_DUMP", "", str,
               help="Path for periodic JSON metrics-snapshot dumps (written "
                    "atomically every HOROVOD_METRICS_DUMP_INTERVAL seconds "
                    "and once more at shutdown); empty disables.")
knobs.register("HOROVOD_METRICS_DUMP_INTERVAL", 30.0, float,
               help="Seconds between JSON snapshot dumps (see "
                    "HOROVOD_METRICS_DUMP).")
knobs.register("HOROVOD_METRICS_AGG_INTERVAL", 5.0, float,
               help="A world of several processes: seconds between the "
                    "other ranks' metrics-snapshot publications to the "
                    "c10d store for rank 0's /metrics aggregation.")
knobs.register("HOROVOD_TIMELINE", "", str,
               help="Path of the Chrome-trace timeline that init starts "
                    "(and shutdown ends); 'DYNAMIC' waits for "
                    "start_timeline() (ref timeline.cc, "
                    "operations.cc:1073-1105).")
knobs.register("HOROVOD_TIMELINE_MARK_CYCLES", False, bool,
               help="Mark coordinator cycles in the timeline.")
knobs.register("HOROVOD_DIVERGENCE_CHECK_EVERY", 1, int,
               help="A world of several ranks: verify every K-th flush that "
                    "all ranks enqueued the identical collective sequence "
                    "(a digest exchange over the c10d store); 0 disables. "
                    "The base interval: after 3 clean checks in a row the "
                    "interval doubles, up to "
                    "HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL; an unseen "
                    "request or a requeued group snaps it back. Must be "
                    "the same on every rank (the cadence is part of the "
                    "digest).")
knobs.register("HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL", 64, int,
               help="Ceiling of the widened divergence-check interval; "
                    "must be the same on every rank.")
knobs.register("HOROVOD_DIVERGENCE_TIMEOUT", 300, int,
               help="Seconds a flush check waits for its peers before it "
                    "raises DivergenceError (stall warnings name the "
                    "lagging ranks every HOROVOD_STALL_CHECK_TIME_SECONDS).")
knobs.register("HOROVOD_TPU_NATIVE", True, bool,
               help="Use the native C++ core (csrc/core.cc: fusion planner, "
                    "timeline writer, segment pack), built with g++ at first "
                    "use; a failed build raises. 0 selects the Python "
                    "planner and writer.")
knobs.register("HOROVOD_AUTOTUNE", False, bool,
               help="The online Bayesian tuner (autotune.ParameterManager) "
                    "of the coordinator's tunable knobs: fusion threshold, "
                    "cycle time and the categorical knobs, scored after "
                    "each cycle. In a world of several ranks rank 0 tunes "
                    "and the others apply its values over the c10d store "
                    "(ref parameter_manager.cc).")
knobs.register("HOROVOD_AUTOTUNE_LOG", "", str,
               help="CSV log of autotune samples (ref "
                    "parameter_manager.cc:77-82).")
knobs.register("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", 3, int,
               help="Autotune warmup discard count (ref common.h:119-124).")
knobs.register("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", 10, int,
               help="Coordinator cycles per autotune scoring sample.")
knobs.register("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20, int,
               help="Max Bayesian-optimization samples before convergence.")
knobs.register("HOROVOD_AUTOTUNE_COMPRESSION", False, bool,
               help="Include the wire-compression tier "
                    "(HOROVOD_GRADIENT_COMPRESSION) as an ordinal dimension "
                    "of the tuner, over "
                    "autotune.COMPRESSION_TIER_CANDIDATES. Opt-in: the tier "
                    "changes the wire's numerics, not only its speed.")
knobs.register("HOROVOD_BUCKET_AUTO_CACHE", "", str,
               help="JSON cache of HOROVOD_GRADIENT_BUCKET_BYTES=auto "
                    "winners, keyed by (gradient shapes, world size). "
                    "Empty = ~/.cache/horovod_tpu_torch/bucket_auto.json.")

# Launcher and elastic knobs (runner/, elastic/): the JAX package's names
# and defaults.
knobs.register("HOROVOD_ELASTIC_GRACE_SECONDS", 30.0, float,
               help="Elastic launcher: how long surviving workers get to "
                    "reach their next commit and exit voluntarily after a "
                    "topology change before the launcher terminates them "
                    "(the analogue of the reference's "
                    "HOROVOD_GLOO_TIMEOUT_SECONDS worker drain window).")
knobs.register("HOROVOD_ELASTIC_RESIZE_MARGIN", 2, int,
               help="Live world resize (elastic/resize.py): steps between "
                    "the resize notice and the agreed quiesce step. The "
                    "first rank observing a host/slice loss publishes "
                    "stop_step = its current step + this margin write-once "
                    "on the c10d store; every rank quiesces there. Ranks "
                    "that did not propose poll the plan key at the "
                    "HOROVOD_PREEMPTION_POLL_SECONDS cadence, so the "
                    "margin must exceed poll_seconds/step_time.")
knobs.register("HOROVOD_ELASTIC_RESIZE_TIMEOUT", 60.0, float,
               help="Live world resize: seconds a rank waits on the store's "
                    "resize-plan agreement (and the snapshot barrier "
                    "inside the quiesce) before abandoning the attempt; "
                    "training then goes on on the OLD world.")
knobs.register("HOROVOD_AUTO_RESUME", 0, int,
               help="Max automatic restarts by the launcher when a run "
                    "exits with the resumable status (75, preemption "
                    "snapshot committed) or dies to a signal: the command "
                    "is relaunched with HVD_RESUME_ATTEMPT incremented "
                    "and restores from the latest committed checkpoint in "
                    "HOROVOD_CKPT_DIR. 0 disables (mirror: hvdrun-torch "
                    "--auto-resume).")
knobs.register("HOROVOD_MODEL_BUDGET_SECONDS", 10.0, float,
               help="hvdmodel-torch exploration budget: wall-clock seconds "
                    "the protocol model checker (hvdlint-torch --model, "
                    "HVD6xx) spends enumerating schedules, split evenly "
                    "across the scenarios of one invocation. A bigger "
                    "budget explores a strict superset of schedules, so "
                    "tier-1 tests use seconds and the -m slow tier "
                    "minutes.")
knobs.register("HOROVOD_MODEL_MAX_CRASHES", 1, int,
               help="hvdmodel-torch: ceiling on crash transitions injected "
                    "per explored schedule (each crash kills one "
                    "simulated process at a yield point, filesystem and "
                    "store effects preserved). Scenarios declare their own "
                    "crash budget; the effective value is the smaller of "
                    "the two. 0 disables crash injection entirely.")
knobs.register("HOROVOD_MODEL_SEED", 0, int,
               help="hvdmodel-torch exploration-order seed: nonzero "
                    "shuffles the order the DFS explores the alternative "
                    "transitions branched from each decision point, "
                    "diversifying the schedules a small budget reaches. "
                    "0 = deterministic default order. Counterexample "
                    "REPLAY ignores the seed: the recorded trace alone "
                    "determines the run (hvdmodel-torch --replay).")

# docs/knobs.md rows of knobs the port does not register, each with why:
# hvdlint-torch's HVD403 (a documented knob the registry lacks) skips
# exactly these.
UNREGISTERED_DOC_KNOBS = {
    "HOROVOD_COMPAT_DROPPABLE": "ROADMAP A.15.4 (handoff tier, HVD8xx)",
    "HOROVOD_COMPAT_ROLLBACK_DEPTH": "ROADMAP A.15.4 (handoff tier, HVD8xx)",
    "HOROVOD_COMPAT_STORE_KINDS": "ROADMAP A.15.4 (handoff tier, HVD8xx)",
    "HOROVOD_COST_HBM_GB": "ROADMAP A.15.4 (cost tier, HVD7xx)",
    "HOROVOD_COST_PAD_AMPLIFICATION": "ROADMAP A.15.4 (cost tier, HVD7xx)",
    "HOROVOD_COST_PAD_MIN_WASTE": "ROADMAP A.15.4 (cost tier, HVD7xx)",
    "HOROVOD_COST_REPLICATED_MIN_BYTES": "ROADMAP A.15.4 (cost tier, HVD7xx)",
    "HOROVOD_COST_RESTREAM_MIN_BYTES": "ROADMAP A.15.4 (cost tier, HVD7xx)",
    "HOROVOD_COST_RESTREAM_READS": "ROADMAP A.15.4 (cost tier, HVD7xx)",
    "HOROVOD_COST_ROOFLINE_TOL": "ROADMAP A.15.4 (cost tier, HVD7xx)",
    "HOROVOD_VERIFY_DONATION_MIN_BYTES":
        "ROADMAP A.15.3 (HVD504, donation: no eager counterpart)",
    "HOROVOD_VERIFY_RESHARD_MIN_BYTES":
        "ROADMAP A.15.3 (HVD502, GSPMD resharding: no eager counterpart)",
    "HOROVOD_FLASH_BLOCK_Q": "TPU only: the Pallas kernel's grid blocks",
    "HOROVOD_FLASH_BLOCK_K": "TPU only: the Pallas kernel's grid blocks",
    "HOROVOD_TPU_PALLAS": "TPU only: Pallas dispatch; the port's kernels "
                          "are CUDA, chosen by the tensor's device",
    "HOROVOD_TPU_DONATE_BUFFERS": "TPU only: XLA buffer donation",
}
