"""Prefill/decode serving engine for the flagship TransformerLM, in PyTorch.

The counterpart of ``horovod_tpu/serving/engine.py``: the same parameter
tree, RoPE and norms as the training model, around a paged KV cache
(:mod:`horovod_tpu_torch.serving.kv_cache`), with the same two step
bodies —

- **prefill**: one sequence, one chunk of its prompt padded to a bucket
  length (powers of two up to ``HOROVOD_SERVE_PREFILL_CHUNK``), K/V
  written into the sequence's pages, logits of the last real token out;
- **decode**: one token for every batch slot at once
  (``HOROVOD_SERVE_SLOTS``), each slot attending over its own pages
  through ``kv_cache.paged_decode_attention`` (the CUDA paged-decode
  kernel on the card, the plain version on the CPU).

PyTorch runs eagerly, so the engine compiles no step ahead of time: what
it builds are the kernel libraries its steps launch (``ops/_build.py``).
``builds`` counts the ``nvcc`` builds that ran while the engine was
constructed and served its first decode step: 0 on a warm build
directory or a warm artifact store, and always 0 on the CPU. With
``HOROVOD_ARTIFACT_STORE`` set, an engine on the card resolves those
libraries while it is constructed, and ``store_outcomes[label]`` (kind
``serve`` in the JAX engine, the kernel entries here) says how, under the
JAX engine's labels whose step launches a kernel: ``serve_decode``, and
with speculative decoding ``serve_verify_k<K>`` and ``serve_draft_l<N>``,
each the paged-decode kernel. ``hit``: the store wrote the library;
``miss``: ``nvcc`` built it (then published); ``local``: it was in the
build directory already; ``error``: it could not be resolved (the first
launch then builds or raises). The JAX engine's ``serve_prefill_<b>``
and ``serve_cow_copy`` have no entry: the port's prefill attention and
page copy are plain PyTorch. The layer ``lax.scan
becomes a Python loop over the stacked layer leaves, and the page pool is
updated in place.

Tensor parallelism (``cfg.tp_axis``): one engine per rank of the mesh's
``tp`` axis (``init(mesh_shape=..., axis_names=...)``), each holding its
shard of the parameters (``param_specs``) and a page pool of its
``n_heads / tp`` KV heads (the JAX engine's ``kv_spec = P(None, None,
None, tp, None)``). The step bodies run with ``tp`` bound: the
row-parallel projections psum over it and the logits are all-gathered,
so every rank picks the same greedy token. Every rank must run the same
scheduler on the same requests.

Speculative decoding (``HOROVOD_SERVE_DRAFT`` = ``ngram[:N]`` or
``truncate:N``, ``HOROVOD_SERVE_SPEC_K`` drafts a step): the verify step
is the decode body at ``slots * (K+1)`` rows, each slot's block-table row
repeated K+1 times with lengths ``len_s .. len_s + K``, and its row-wise
operations taken in row chunks of ``slots`` (below); the ``truncate:N``
draft is the decode body through the first N layers, writing those
layers' K/V into the shared pool in place (verify rewrites the same
positions). The verify rows are the decode rows bit for bit, on the CPU
and on CUDA. A GEMM library picks its algorithm by shape: on an H100 the
MLP's output product (K = d_ff) at M = ``slots * (K+1)`` is not bitwise
its M = ``slots`` result, and the other products (K = d_model) differ
now and then by one bf16 step where their f32 sums round apart; so does
the RMS norm's row mean (the reduction's layout follows the row count).
So the verify step runs every GEMM and every norm's mean in chunks of
``slots`` rows, each of the decode step's shape; the paged attention,
RoPE and the elementwise operations are row-independent.
:func:`load_for_serving` is the train-to-serve handoff: the parameters of
the newest committed training snapshot, checked against the serving
config.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import _build, collectives
from horovod_tpu_torch.parallel import tensor_parallel as tp_lib
from horovod_tpu_torch.serving import kv_cache as kvc
from horovod_tpu_torch.utils.device import resolve_device
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.serving")

# Leaves the step bodies cast to cfg.dtype at use; the norm scales stay f32.
_CAST_AT_USE = ("embed", "head", "wq", "wk", "wv", "wo", "w_in", "w_out")


def prefill_buckets(chunk_cap: Optional[int] = None) -> List[int]:
    """Prefill bucket lengths: powers of two from 32 up to
    HOROVOD_SERVE_PREFILL_CHUNK; every chunk is padded up to its bucket."""
    cap = int(chunk_cap or knobs.get("HOROVOD_SERVE_PREFILL_CHUNK"))
    out, b = [], 32
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


def _check_cfg(cfg: tfm.TransformerConfig) -> None:
    unsupported = [n for n, a in (("sp", cfg.sp_axis), ("ep", cfg.ep_axis),
                                  ("pp", cfg.pp_axis)) if a]
    if unsupported or cfg.num_experts:
        raise ValueError(
            "serving supports the dense TP/DP transformer only; got "
            f"axes {unsupported or 'none'}, num_experts="
            f"{cfg.num_experts}. Build a serving TransformerConfig with "
            "sp/ep/pp axes None (TP via tp_axis is supported).")


def _parse_draft(spec: str, n_layers: int) -> Tuple[str, int]:
    """HOROVOD_SERVE_DRAFT -> (mode, n): 'off', 'ngram[:N]' (host-side
    n-gram drafter, N = match order, default 3), or 'truncate:N'
    (self-drafting from the target's first N layers)."""
    s = str(spec or "off").strip().lower()
    if s in ("", "off", "0"):
        return "off", 0
    head, _, arg = s.partition(":")
    if head == "ngram":
        n = int(arg or 3)
        if n < 1:
            raise ValueError(
                f"HOROVOD_SERVE_DRAFT={spec!r}: n-gram order must be "
                f">= 1")
        return "ngram", n
    if head == "truncate":
        if not arg:
            raise ValueError(
                f"HOROVOD_SERVE_DRAFT={spec!r}: truncate needs a layer "
                f"count, e.g. 'truncate:2'")
        n = int(arg)
        if not (1 <= n < n_layers):
            raise ValueError(
                f"HOROVOD_SERVE_DRAFT={spec!r}: draft layer count must "
                f"be in [1, {n_layers - 1}] (the target has "
                f"{n_layers} layers; drafting with all of them is just "
                f"decoding twice)")
        return "truncate", n
    raise ValueError(
        f"HOROVOD_SERVE_DRAFT={spec!r}: expected 'off', 'ngram[:N]' "
        f"or 'truncate:N'")


def _rope_rows(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding with one position per row: x ``[N, H, D]``, pos
    ``[N]``. Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])``
    with angles computed in f32, as the JAX engine does."""
    d = x.shape[-1]
    freqs = 1.0 / (10000.0 ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = pos[:, None].float() * freqs[None, :]                # [N, D/2]
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                      dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def _by_rows(fn, x: torch.Tensor, rows: Optional[int]) -> torch.Tensor:
    """``fn(x)``, or ``fn`` over ``x`` in chunks of ``rows`` rows (the
    speculative verify step's chunks of the decode step's shape) when
    ``rows`` is set and ``x`` has more."""
    if rows is None or x.shape[0] <= rows:
        return fn(x)
    return torch.cat([fn(c) for c in x.split(rows)])


def _norm(x: torch.Tensor, scale: torch.Tensor,
          rows: Optional[int] = None) -> torch.Tensor:
    """``models.transformer._rmsnorm``, its row mean taken in chunks of
    ``rows`` rows when ``rows`` is set (``_by_rows``); the same operations
    in the same order otherwise."""
    x32 = x.float()
    sq = x32 * x32
    mean = _by_rows(lambda t: t.mean(dim=-1, keepdim=True), sq, rows)
    return (x32 * torch.rsqrt(mean + 1e-6) * scale).to(x.dtype)


def _qkv(cfg, lp, h, rows: Optional[int] = None):
    dt = cfg.dtype
    q, k, v = (_by_rows(lambda t, w=lp[name].to(dt):
                        tp_lib.column_parallel(t, w), h, rows)
               for name in ("wq", "wk", "wv"))
    hl = q.shape[-1] // cfg.head_dim
    shp = tuple(h.shape[:-1]) + (hl, cfg.head_dim)
    return q.reshape(shp), k.reshape(shp), v.reshape(shp)


def _mlp(cfg, lp, x, rows: Optional[int] = None):
    """The MLP block; ``rows`` runs its norm's mean and its products in
    chunks of that many rows (``_by_rows``)."""
    dt = cfg.dtype
    w_in, w_out = lp["w_in"].to(dt), lp["w_out"].to(dt)
    h = _norm(x, lp["mlp_norm"], rows)
    # jax.nn.gelu defaults to the tanh approximation; torch's to the erf form
    u = torch.nn.functional.gelu(
        _by_rows(lambda t: tp_lib.column_parallel(t, w_in), h, rows),
        approximate="tanh")
    return _by_rows(lambda t: tp_lib.row_parallel(t, w_out, cfg.tp_axis),
                    u, rows)


def _gather_logits(cfg, x, head):
    """[.., D] hidden -> full-vocab f32 logits (computed in cfg.dtype; the
    tp shards gathered)."""
    logits = (x @ head.to(cfg.dtype)).float()
    if cfg.tp_axis:
        logits = collectives.all_gather(logits, cfg.tp_axis, axis=-1)
    return logits


def _launches_kernels(device: torch.device) -> bool:
    """Whether an engine on ``device`` launches the CUDA kernels (the CPU
    runs their plain versions)."""
    return device.type == "cuda"


def _layer(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def _decode_body(cfg: tfm.TransformerConfig, params: Any,
                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                 block_tables: torch.Tensor, lengths: torch.Tensor,
                 tokens: torch.Tensor, *, n_layers: Optional[int] = None,
                 rows: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step over all slots: tokens ``[S]``, lengths ``[S]``
    (tokens already cached, the position this token lands at). Each layer
    writes the token's K/V into the pool (in place) and then attends with
    ``lengths + 1``. Empty slots carry length 0 and scratch-page block
    tables; their writes sink into the scratch page. Returns
    ``(next_tokens [S] int32, logits [S, V] f32)``.

    The same body at ``slots * (K+1)`` rows is the speculative verify
    step: each row's K/V lands in the pages before the layer attends, so
    row i of a slot sees exactly the drafts before it. ``n_layers``
    truncates the stack to layers ``0..n-1`` plus the shared final norm
    and head: the ``truncate:N`` draft, whose K/V writes to those layers
    of the shared pool verify later rewrites with the same values.
    ``rows`` runs the GEMMs and the norms' means in chunks of that many
    rows (``_by_rows``; the verify step passes ``slots``)."""
    scale = cfg.head_dim ** -0.5
    x = tp_lib.vocab_parallel_embed(
        tokens, params["embed"].to(cfg.dtype), cfg.tp_axis)    # [S, D]
    # Rows at or past the last block-table column would land in the
    # request's own last page; route them to the scratch page.
    n_ctx = block_tables.shape[1] * k_pages.shape[2]
    valid = lengths < n_ctx
    attend = lengths + 1
    for i in range(cfg.n_layers if n_layers is None else n_layers):
        lp = _layer(params, i)
        kp, vp = k_pages[i], v_pages[i]
        h = _norm(x, lp["attn_norm"], rows)
        q, k, v = _qkv(cfg, lp, h, rows)                        # [S, H, Dh]
        q = _rope_rows(q, lengths)
        k = _rope_rows(k, lengths)
        kvc.write_token_kv(kp, vp, k, v, block_tables, lengths, valid=valid)
        o = kvc.paged_decode_attention(q, kp, vp, block_tables, attend,
                                       scale)
        o = o.to(x.dtype).reshape(x.shape[0], -1)
        wo = lp["wo"].to(cfg.dtype)
        x = x + _by_rows(lambda t: tp_lib.row_parallel(t, wo, cfg.tp_axis),
                         o, rows).to(x.dtype)
        x = x + _mlp(cfg, lp, x, rows).to(x.dtype)
    x = _norm(x, params["final_norm"], rows)
    logits = _by_rows(lambda t: _gather_logits(cfg, t, params["head"]),
                      x, rows)                                  # [S, V] f32
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    return next_tokens, logits


def _prefill_body(cfg: tfm.TransformerConfig, params: Any,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  block_table: torch.Tensor, start: int, n_real: int,
                  tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One prefill chunk of ONE sequence: tokens ``[C]`` (bucket-padded),
    positions ``start .. start+n_real`` written to the pages, causal
    attention (plain torch) over the cached prefix + the chunk. Returns
    ``(next_token, logits [V] f32)`` of the last real token."""
    scale = cfg.head_dim ** -0.5
    c = tokens.shape[0]
    dev = tokens.device
    pos = int(start) + torch.arange(c, dtype=torch.int32, device=dev)
    x = tp_lib.vocab_parallel_embed(
        tokens, params["embed"].to(cfg.dtype), cfg.tp_axis)    # [C, D]
    page = k_pages.shape[2]
    n_ctx = block_table.shape[0] * page
    ctx = torch.arange(n_ctx, dtype=torch.int32, device=dev)
    visible = (ctx[None, :] <= pos[:, None])[:, None, :]       # [C, 1, S]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kp, vp = k_pages[i], v_pages[i]
        h = _norm(x, lp["attn_norm"])
        q, k, v = _qkv(cfg, lp, h)                              # [C, H, Dh]
        q = _rope_rows(q, pos)
        k = _rope_rows(k, pos)
        kvc.write_chunk_kv(kp, vp, k, v, block_table, start, n_real)
        kg = kvc.gather_pages(kp, block_table).float()
        vg = kvc.gather_pages(vp, block_table).float()
        s = torch.einsum("chd,shd->chs", q.float(), kg) * scale
        s = s.masked_fill(~visible, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.where(visible, torch.exp(s - m), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("chs,shd->chd", p / l, vg)
        o = o.to(x.dtype).reshape(c, -1)
        x = x + tp_lib.row_parallel(o, lp["wo"].to(cfg.dtype),
                                    cfg.tp_axis).to(x.dtype)
        x = x + _mlp(cfg, lp, x).to(x.dtype)
    x = _norm(x, params["final_norm"])
    last = x[max(int(n_real) - 1, 0)]                           # [D]
    logits = _gather_logits(cfg, last, params["head"])         # [V] f32
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    return next_token, logits


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class ServeEngine:
    """Paged-cache inference engine on one device (one rank of the tp
    axis under tensor parallelism, with the GLOBAL parameters given:
    each rank keeps its shard).

    Owns the page pools, the host-side allocator and block tables, and
    the two step bodies; the continuous-batching policy lives in
    ``serving.scheduler``. ``device`` defaults to ``"cuda"`` and raises
    when no GPU is present; ``device="cpu"`` runs the plain path.

    The weight leaves the bodies cast to ``cfg.dtype`` at use are cast
    once here instead (the same values), so a decode step does not
    re-read the f32 weights."""

    def __init__(self, cfg: tfm.TransformerConfig, params: Any, *,
                 device="cuda",
                 slots: Optional[int] = None,
                 page: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 draft: Optional[str] = None,
                 spec_k: Optional[int] = None):
        _check_cfg(cfg)
        builds_before = _build.builds_run
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = int(slots or knobs.get("HOROVOD_SERVE_SLOTS"))
        self.page = int(page or knobs.get("HOROVOD_SERVE_PAGE"))
        requested_ms = int(max_seq or knobs.get("HOROVOD_SERVE_MAX_SEQ"))
        self.max_seq = min(requested_ms, cfg.max_seq)
        self.ceiling_hint = (
            f"cfg.max_seq={cfg.max_seq} (the model's trained context)"
            if cfg.max_seq < requested_ms else "HOROVOD_SERVE_MAX_SEQ")
        self.n_max_pages = -(-self.max_seq // self.page)
        pool_pages = int(n_pages or knobs.get("HOROVOD_SERVE_PAGES")) \
            or self.slots * self.n_max_pages
        self.buckets = prefill_buckets(prefill_chunk)
        self.prefix_cache = bool(
            knobs.get("HOROVOD_SERVE_PREFIX_CACHE")
            if prefix_cache is None else prefix_cache)
        self.draft_spec = str(
            knobs.get("HOROVOD_SERVE_DRAFT") if draft is None else draft)
        self.draft_mode, self.draft_n = _parse_draft(
            self.draft_spec, cfg.n_layers)
        self.spec_k = (int(spec_k if spec_k is not None
                           else knobs.get("HOROVOD_SERVE_SPEC_K"))
                       if self.draft_mode != "off" else 0)
        if self.draft_mode != "off" and self.spec_k < 1:
            raise ValueError(
                f"HOROVOD_SERVE_DRAFT={self.draft_spec!r} needs "
                f"HOROVOD_SERVE_SPEC_K >= 1 drafts per step, got "
                f"{self.spec_k}")

        tp = cfg.tp_axis
        self.tp_size = (collectives.get_context().topology.axis_size(
            collectives.axis_of(tp)) if tp else 1)
        if cfg.n_heads % self.tp_size:
            raise ValueError(f"n_heads={cfg.n_heads} not divisible by tp="
                             f"{self.tp_size}")
        self.pool = kvc.PagePool(cfg.n_layers, pool_pages, self.page,
                                 cfg.n_heads // self.tp_size, cfg.head_dim,
                                 dtype=cfg.dtype, device=self.device)
        self.allocator = kvc.PageAllocator(pool_pages)
        self.tables = kvc.BlockTables(self.slots, self.n_max_pages,
                                      self.pool.scratch_page)
        self.slot_pages: List[Optional[List[int]]] = [None] * self.slots
        self.prefix = (kvc.PrefixIndex(self.page, self.allocator)
                       if self.prefix_cache else None)
        self.slot_skip: List[int] = [0] * self.slots
        self.cow_copies = 0
        self.params = self._place(params)
        self.k_pages, self.v_pages = self.pool.alloc_arrays()
        self.store_outcomes: Dict[str, str] = self._adopt_kernels()
        # nvcc builds since construction began, counted up to the end of
        # the first decode-shaped step
        self.builds = _build.builds_run - builds_before
        self._builds_from: Optional[int] = builds_before
        # f32 logits of the most recent prefill chunk, decode, draft or
        # verify step
        self.last_logits: Optional[torch.Tensor] = None
        _register_engine(self)
        logger.info(
            "serve engine up on %s: %d slots, %d+1 pages x %d tokens "
            "(%.1f MiB KV pool), prefill buckets %s", self.device,
            self.slots, pool_pages, self.page,
            self.pool.nbytes() / 2 ** 20, self.buckets)

    def _kernel_labels(self) -> Dict[str, str]:
        """The JAX engine's step labels whose port launches a kernel, each
        with its kernel."""
        labels = {"serve_decode": "paged_decode"}
        if self.spec_k:
            labels[f"serve_verify_k{self.spec_k}"] = "paged_decode"
            if self.draft_mode == "truncate":
                labels[f"serve_draft_l{self.draft_n}"] = "paged_decode"
        return labels

    def _adopt_kernels(self) -> Dict[str, str]:
        """Resolve the kernels of the engine's steps through the artifact
        store (module docstring); ``{label: outcome}``, empty when the
        store is off or the engine launches no kernel. Never raises."""
        from horovod_tpu_torch.store import artifact_store as _store
        if not _store.enabled() or not _launches_kernels(self.device):
            return {}
        how: Dict[str, str] = {}
        out = {}
        for label, kernel in self._kernel_labels().items():
            if kernel not in how:
                try:
                    how[kernel] = {"store": "hit", "built": "miss",
                                   "local": "local"}[_build.resolve(kernel)]
                except Exception as e:
                    logger.warning("serve: kernel %s not resolved (%s: %s)",
                                   kernel, type(e).__name__, e)
                    how[kernel] = "error"
            out[label] = how[kernel]
        return out

    def _place(self, params: Any) -> Any:
        def tensors(tree):
            if isinstance(tree, dict):
                return {k: tensors(v) for k, v in tree.items()}
            return torch.as_tensor(tree)

        def place(tree, name=""):
            if isinstance(tree, dict):
                return {k: place(v, k) for k, v in tree.items()}
            dt = self.cfg.dtype if name in _CAST_AT_USE else tree.dtype
            return tree.to(device=self.device, dtype=dt)

        params = tensors(params)
        if self.cfg.tp_axis:
            params = tfm.shard_params(self.cfg, params)
        return place(params)

    def _bound(self):
        """The tp axis bound around a step body (nothing without TP)."""
        return collectives.bind_axis(*(a for a in (self.cfg.tp_axis,) if a))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _count_builds(self) -> None:
        """Close the build count after the first decode-shaped step (the
        first to launch the paged-decode kernel)."""
        if self._builds_from is not None:
            self.builds = _build.builds_run - self._builds_from
            self._builds_from = None

    # -- slot API (driven by the scheduler at step boundaries) ---------------
    def reserve(self, n_tokens_worst_case: int,
                prompt: Optional[np.ndarray] = None) -> Optional[int]:
        """Free slot id with pages reserved for the worst case, or None
        (no slot / pool drained — admission waits). With the prefix cache
        on and ``prompt`` given, the resident prefix is adopted (shared
        pages increfed, a partial-block divergence copy-on-written) and
        only the tail is newly allocated; ``slot_skip[slot]`` then tells
        the scheduler how many prompt tokens to skip."""
        if n_tokens_worst_case > self.max_seq:
            raise ValueError(
                f"worst case of {n_tokens_worst_case} tokens exceeds "
                f"the serving context ceiling {self.max_seq} — clamp "
                f"max_new_tokens to max_seq - prompt length (or raise "
                f"{self.ceiling_hint})")
        n_pages = self.pool.pages_for(n_tokens_worst_case)
        try:
            slot = self.slot_pages.index(None)
        except ValueError:
            return None
        shared: List[int] = []
        skip = 0
        cow: Optional[Tuple[int, int]] = None
        if self.prefix is not None and prompt is not None:
            shared, skip, cow = self.prefix.match(prompt)
        n_tail = n_pages - len(shared)
        if not self.allocator.can_alloc(n_tail):
            if self.prefix is not None:
                self.prefix.evict(n_tail)
            if not self.allocator.can_alloc(n_tail):
                return None
        tail = self.allocator.alloc(n_tail)
        for p in shared:
            self.allocator.incref(p)
        if cow is not None:
            src, t = cow
            self.allocator.incref(src)
            kvc.copy_page(self.k_pages, self.v_pages, src, tail[0])
            self.allocator.decref(src)
            self.cow_copies += 1
            skip += t
        pages = shared + tail
        self.slot_pages[slot] = pages
        self.tables.assign(slot, pages)
        self.slot_skip[slot] = skip
        return slot

    def release(self, slot: int) -> None:
        """Eviction-on-finish: one reference dropped per page; the
        block-table row resets to the scratch page."""
        pages = self.slot_pages[slot]
        if pages is not None:
            self.allocator.free(pages)
        self.slot_pages[slot] = None
        self.slot_skip[slot] = 0
        self.tables.clear(slot)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @torch.inference_mode()
    def prefill_chunk(self, slot: int, prompt: np.ndarray,
                      start: int) -> Tuple[int, Optional[int]]:
        """Run ONE bucket-sized prefill chunk of ``prompt`` beginning at
        ``start``; returns (next_start, first_token), first_token None
        while chunks remain."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size > self.max_seq:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds the serving "
                f"context ceiling {self.max_seq} "
                f"({self.ceiling_hint})")
        n_real = min(prompt.size - start,
                     self.bucket_for(prompt.size - start))
        bucket = self.bucket_for(n_real)
        chunk = np.zeros((bucket,), np.int32)
        chunk[:n_real] = prompt[start:start + n_real]
        with self._bound():
            tok, self.last_logits = _prefill_body(
                self.cfg, self.params, self.k_pages, self.v_pages,
                self._tensor(self.tables.tables[slot]), start, n_real,
                self._tensor(chunk))
        start += n_real
        if start < prompt.size:
            return start, None
        self.tables.lengths[slot] = prompt.size
        if self.prefix is not None:
            self.prefix.register(prompt, self.slot_pages[slot] or [])
        return start, int(tok)

    def prefill(self, slot: int, prompt: np.ndarray) -> int:
        """Run the whole prompt through prefill chunks back-to-back;
        returns the first generated token."""
        start, token = 0, None
        while token is None:
            start, token = self.prefill_chunk(slot, prompt, start)
        return token

    @torch.inference_mode()
    def decode_step(self, tokens: np.ndarray,
                    active: Optional[np.ndarray] = None) -> np.ndarray:
        """One batched decode step: ``tokens[s]`` is slot s's input token.
        Slots outside ``active`` (empty, or mid-prefill) are presented
        with a scratch block table and length 0, so their write never
        lands in pages a concurrent prefill owns. Cached lengths of
        active slots advance by one."""
        if active is None:
            active = (np.array([p is not None for p in self.slot_pages])
                      & (self.tables.lengths > 0))
        bt_np = self.tables.tables
        ln_np = self.tables.lengths
        if not active.all():
            bt_np = bt_np.copy()
            ln_np = ln_np.copy()
            bt_np[~active] = self.pool.scratch_page
            ln_np[~active] = 0
        with self._bound():
            nxt, self.last_logits = _decode_body(
                self.cfg, self.params, self.k_pages, self.v_pages,
                self._tensor(bt_np), self._tensor(ln_np),
                self._tensor(np.asarray(tokens, np.int32)))
        self.tables.lengths[active] += 1
        out = nxt.cpu().numpy()
        self._count_builds()
        return out

    # -- speculative decode (draft K, verify all K in one step) --------------
    @torch.inference_mode()
    def propose_drafts(self, tokens: np.ndarray,
                       active: np.ndarray) -> np.ndarray:
        """K draft tokens per slot from the truncated-layer draft model
        (``HOROVOD_SERVE_DRAFT=truncate:N``): K decode-shaped steps
        through the target's first N layers. Their K/V writes land in the
        shared pool at the speculated positions; verify rewrites the same
        positions before anything attends over them, so no reader sees a
        draft-only value."""
        if self.draft_mode != "truncate":
            raise RuntimeError(
                "propose_drafts needs HOROVOD_SERVE_DRAFT=truncate:N "
                f"(engine built with {self.draft_spec!r})")
        k = self.spec_k
        drafts = np.zeros((self.slots, k), np.int32)
        bt_np = self.tables.tables.copy()
        ln_np = self.tables.lengths.copy()
        bt_np[~active] = self.pool.scratch_page
        ln_np[~active] = 0
        toks = np.asarray(tokens, np.int32).copy()
        toks[~active] = 0
        bt = self._tensor(bt_np)
        for i in range(k):
            with self._bound():
                nxt, self.last_logits = _decode_body(
                    self.cfg, self.params, self.k_pages, self.v_pages, bt,
                    self._tensor(ln_np), self._tensor(toks),
                    n_layers=self.draft_n)
            nxt = nxt.cpu().numpy()
            drafts[:, i] = nxt
            toks = np.where(active, nxt, 0).astype(np.int32)
            ln_np = ln_np + active.astype(np.int32)
        self._count_builds()
        return drafts

    @torch.inference_mode()
    def spec_step(self, tokens: np.ndarray, drafts: np.ndarray,
                  active: Optional[np.ndarray] = None) -> np.ndarray:
        """One batched speculative verify step: ``tokens[s]`` is slot s's
        last accepted token, ``drafts[s]`` its K proposed continuations.
        Runs the decode body once at ``slots * (K+1)`` rows: row (s, i)
        consumes draft i (row 0 the accepted token) at position
        ``len_s + i``, its GEMMs and norm means in chunks of ``slots``
        rows. Returns ``out [slots, K+1]``: out[s, i] is, bitwise, the
        token sequential decode emits after consuming rows 0..i.

        Lengths of active slots advance by K+1; the scheduler keeps the
        accepted prefix and calls :meth:`rollback` with the rejected
        count."""
        if not self.spec_k:
            raise RuntimeError(
                "spec_step needs HOROVOD_SERVE_DRAFT != 'off' "
                f"(engine built with {self.draft_spec!r})")
        k = self.spec_k
        if active is None:
            active = (np.array([p is not None for p in self.slot_pages])
                      & (self.tables.lengths > 0))
        rows = self.slots * (k + 1)
        bt = np.repeat(self.tables.tables, k + 1, axis=0)
        ln = (np.repeat(self.tables.lengths, k + 1)
              + np.tile(np.arange(k + 1, dtype=np.int32), self.slots))
        toks = np.concatenate(
            [np.asarray(tokens, np.int32).reshape(-1, 1),
             np.asarray(drafts, np.int32).reshape(self.slots, k)],
            axis=1).reshape(rows)
        row_active = np.repeat(active, k + 1)
        bt[~row_active] = self.pool.scratch_page
        ln[~row_active] = 0
        toks[~row_active] = 0
        with self._bound():
            nxt, self.last_logits = _decode_body(
                self.cfg, self.params, self.k_pages, self.v_pages,
                self._tensor(bt), self._tensor(ln.astype(np.int32)),
                self._tensor(toks), rows=self.slots)
        self.tables.lengths[active] += k + 1
        out = nxt.cpu().numpy().reshape(self.slots, k + 1)
        self._count_builds()
        return out

    def rollback(self, slot: int, n_rejected: int) -> None:
        """Accept-prefix rollback: drop the rejected speculative suffix of
        a slot, which is length bookkeeping only. Its page writes are
        masked by the shorter length and rewritten by the next verify
        before anything attends over them; the slot's worst-case pages
        stay reserved."""
        n = int(n_rejected)
        if not (0 <= n <= int(self.tables.lengths[slot])):
            raise ValueError(
                f"rollback of {n} tokens on slot {slot} with length "
                f"{int(self.tables.lengths[slot])}")
        self.tables.lengths[slot] -= n

    def occupancy(self) -> float:
        used = sum(1 for p in self.slot_pages if p is not None)
        return used / float(self.slots)

    def stats(self) -> Dict[str, Any]:
        free = self.allocator.free_pages
        return {
            "slots": self.slots,
            "occupied": sum(1 for p in self.slot_pages if p is not None),
            "page": self.page,
            "pages_total": self.pool.n_pages,
            "pages_free": free,
            "pages_shared": self.allocator.shared_pages,
            "pool": {
                "free": free,
                "shared": self.allocator.shared_pages,
                "utilization": round(
                    1.0 - free / float(self.pool.n_pages), 4),
            },
            "kv_pool_bytes": self.pool.nbytes(),
            "prefill_buckets": list(self.buckets),
            "prefix_cache": self.prefix_cache,
            "prefix_index": (self.prefix.stats()
                             if self.prefix is not None else None),
            "cow_copies": self.cow_copies,
            "draft": self.draft_spec,
            "spec_k": self.spec_k,
            "builds": self.builds,
            "store_outcomes": dict(self.store_outcomes),
            "tp": self.tp_size,
        }


# ---------------------------------------------------------------------------
# train -> serve handoff
# ---------------------------------------------------------------------------
#
# The messages are the JAX package's (``horovod_tpu/analysis/
# rules_compat.py``: tree_diff, structure_message, geometry_message), kept
# here in the same words.

def tree_diff(got: Dict[str, Tuple[Tuple[int, ...], str]],
              want: Dict[str, Tuple[Tuple[int, ...], str]]
              ) -> Dict[str, Any]:
    """Structural diff of two leaf maps ``{path: (shape, dtype)}``:
    ``missing`` (expected, absent), ``extra`` (present, unexpected),
    ``shape`` and ``dtype`` mismatches on shared leaves, each sorted."""
    gk, wk = set(got), set(want)
    shape = []
    dtype = []
    for key in sorted(gk & wk):
        (gs, gd), (ws, wd) = got[key], want[key]
        if tuple(gs) != tuple(ws):
            shape.append((key, tuple(gs), tuple(ws)))
        elif gd != wd:
            dtype.append((key, gd, wd))
    return {
        "missing": sorted(wk - gk),
        "extra": sorted(gk - wk),
        "shape": shape,
        "dtype": dtype,
    }


def structure_message(got_desc: str, want_desc: str,
                      context: str = "train->serve handoff") -> str:
    return (f"{context}: restored param tree does not match the serving "
            f"TransformerConfig (restored {got_desc}, serving expects "
            f"{want_desc}) — was the snapshot saved by a different "
            f"model?")


def geometry_message(leaf: str, got: Tuple[int, ...],
                     want: Tuple[int, ...],
                     context: str = "train->serve handoff") -> str:
    return (f"{context}: param {leaf} has shape {tuple(got)} but the "
            f"serving TransformerConfig expects {tuple(want)} — the "
            f"snapshot was saved by a different model geometry "
            f"(layers/width/heads/vocab)")


def _leaf_shapes(tree: Any, path: str = "") -> Dict[str, Tuple]:
    """``{keystr: (shape, "")}`` of a nested dict of arrays, in
    ``jax.tree_util.keystr``'s form (``['layers']['wq']``)."""
    if isinstance(tree, dict):
        out: Dict[str, Tuple] = {}
        for k in sorted(tree):
            out.update(_leaf_shapes(tree[k], f"{path}[{k!r}]"))
        return out
    return {path: (tuple(tree.shape), "")}


def _structure(tree: Any) -> str:
    """The key structure of a nested dict, for the mismatch message."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def load_for_serving(ckpt_dir: str, cfg: tfm.TransformerConfig,
                     template: Optional[Any] = None, *, device="cuda"
                     ) -> Tuple[int, Any]:
    """(step, params) from the newest committed training snapshot in
    ``ckpt_dir`` (``resilience.async_checkpoint.restore_latest``), placed
    on ``device``; pass them to ``ServeEngine(cfg, params)`` (under TP
    each rank's engine keeps its shard of these global parameters).

    The snapshot is the whole ``TrainState``: the optimizer's leaves
    (momentum, the error-feedback residual, the step) restore beside the
    parameters and are dropped. The parameter tree must have the keys of
    ``init_params(cfg)`` (``ValueError`` naming a different model) and
    its leaves their shapes (``ValueError`` naming the first leaf that
    differs). A missing snapshot raises ``FileNotFoundError``."""
    from horovod_tpu_torch.resilience import async_checkpoint as ac
    dev = resolve_device(device)
    got = ac.restore_latest(ckpt_dir, template=template)
    if got is None:
        raise FileNotFoundError(
            f"train->serve handoff: no committed checkpoint under "
            f"{ckpt_dir} (is HOROVOD_CKPT_DIR right, and did the "
            f"training run commit at least one snapshot?)")
    step, state = got
    params = getattr(state, "params", None)
    if params is None and isinstance(state, dict):
        params = state.get("params")
    if params is None:
        params = state          # a params-only tree saved directly
    with torch.device("meta"):
        expected = tfm.init_params(cfg, torch.Generator(), device="meta")
    if not isinstance(params, dict):
        raise ValueError(structure_message(type(params).__name__,
                                           _structure(expected)))
    diff = tree_diff(_leaf_shapes(params), _leaf_shapes(expected))
    if diff["missing"] or diff["extra"]:
        raise ValueError(structure_message(_structure(params),
                                           _structure(expected)))
    if diff["shape"]:
        name, got_shape, want_shape = diff["shape"][0]
        raise ValueError(geometry_message(name, got_shape, want_shape))

    def place(tree):
        if isinstance(tree, dict):
            return {k: place(v) for k, v in tree.items()}
        return torch.as_tensor(tree).to(device=dev, dtype=torch.float32)

    logger.info("train->serve handoff: restored step %d from %s "
                "(optimizer/residual leaves dropped)", step, ckpt_dir)
    return int(step), place(params)


# ---------------------------------------------------------------------------
# module-level registry (the serving block of serving_stats())
# ---------------------------------------------------------------------------

_active_engine: Optional[ServeEngine] = None


def _register_engine(engine: ServeEngine) -> None:
    global _active_engine
    _active_engine = engine


def active_engine() -> Optional[ServeEngine]:
    return _active_engine


def reset_for_tests() -> None:
    global _active_engine
    _active_engine = None
