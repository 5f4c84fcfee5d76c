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

PyTorch runs eagerly, so there is no AOT build and no artifact store:
``stats()`` keeps ``builds = 0`` and ``store_outcomes = {}`` so its keys
match the JAX engine's. The layer ``lax.scan`` becomes a Python loop
over the stacked layer leaves, and the page pool is updated in place.
Tensor parallelism, speculative decoding and ``load_for_serving`` come in
later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.models import transformer as tfm
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
            "sp/ep/pp axes None.")
    if cfg.tp_axis:
        raise ValueError(
            f"tp_axis={cfg.tp_axis!r}: tensor-parallel serving is not yet "
            f"ported to horovod_tpu_torch; build the config with "
            f"tp_axis=None")


def _check_draft(spec: str) -> None:
    if str(spec or "off").strip().lower() not in ("", "off", "0"):
        raise ValueError(
            f"HOROVOD_SERVE_DRAFT={spec!r}: speculative decoding is not "
            f"yet ported to horovod_tpu_torch; use 'off'")


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


def _qkv(cfg, lp, h):
    dt = cfg.dtype
    q = tp_lib.column_parallel(h, lp["wq"].to(dt))
    k = tp_lib.column_parallel(h, lp["wk"].to(dt))
    v = tp_lib.column_parallel(h, lp["wv"].to(dt))
    hl = q.shape[-1] // cfg.head_dim
    shp = tuple(h.shape[:-1]) + (hl, cfg.head_dim)
    return q.reshape(shp), k.reshape(shp), v.reshape(shp)


def _mlp(cfg, lp, x):
    dt = cfg.dtype
    h = tfm._rmsnorm(x, lp["mlp_norm"])
    # jax.nn.gelu defaults to the tanh approximation; torch's to the erf form
    u = torch.nn.functional.gelu(
        tp_lib.column_parallel(h, lp["w_in"].to(dt)), approximate="tanh")
    return tp_lib.row_parallel(u, lp["w_out"].to(dt), cfg.tp_axis)


def _gather_logits(cfg, x, head):
    """[.., D] hidden -> full-vocab f32 logits (computed in cfg.dtype)."""
    return (x @ head.to(cfg.dtype)).float()


def _layer(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def _decode_body(cfg: tfm.TransformerConfig, params: Any,
                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                 block_tables: torch.Tensor, lengths: torch.Tensor,
                 tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step over all slots: tokens ``[S]``, lengths ``[S]``
    (tokens already cached, the position this token lands at). Each layer
    writes the token's K/V into the pool (in place) and then attends with
    ``lengths + 1``. Empty slots carry length 0 and scratch-page block
    tables; their writes sink into the scratch page. Returns
    ``(next_tokens [S] int32, logits [S, V] f32)``."""
    scale = cfg.head_dim ** -0.5
    x = tp_lib.vocab_parallel_embed(
        tokens, params["embed"].to(cfg.dtype), cfg.tp_axis)    # [S, D]
    # Rows at or past the last block-table column would land in the
    # request's own last page; route them to the scratch page.
    n_ctx = block_tables.shape[1] * k_pages.shape[2]
    valid = lengths < n_ctx
    attend = lengths + 1
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kp, vp = k_pages[i], v_pages[i]
        h = tfm._rmsnorm(x, lp["attn_norm"])
        q, k, v = _qkv(cfg, lp, h)                              # [S, H, Dh]
        q = _rope_rows(q, lengths)
        k = _rope_rows(k, lengths)
        kvc.write_token_kv(kp, vp, k, v, block_tables, lengths, valid=valid)
        o = kvc.paged_decode_attention(q, kp, vp, block_tables, attend,
                                       scale)
        o = o.to(x.dtype).reshape(x.shape[0], -1)
        x = x + tp_lib.row_parallel(o, lp["wo"].to(cfg.dtype),
                                    cfg.tp_axis).to(x.dtype)
        x = x + _mlp(cfg, lp, x).to(x.dtype)
    x = tfm._rmsnorm(x, params["final_norm"])
    logits = _gather_logits(cfg, x, params["head"])            # [S, V] f32
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
        h = tfm._rmsnorm(x, lp["attn_norm"])
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
    x = tfm._rmsnorm(x, params["final_norm"])
    last = x[max(int(n_real) - 1, 0)]                           # [D]
    logits = _gather_logits(cfg, last, params["head"])         # [V] f32
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    return next_token, logits


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class ServeEngine:
    """Paged-cache inference engine on one device.

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
                 draft: Optional[str] = None):
        _check_cfg(cfg)
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
        _check_draft(self.draft_spec)

        self.pool = kvc.PagePool(cfg.n_layers, pool_pages, self.page,
                                 cfg.n_heads, cfg.head_dim,
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
        self.builds = 0
        self.store_outcomes: Dict[str, str] = {}
        # f32 logits of the most recent prefill chunk or decode step
        self.last_logits: Optional[torch.Tensor] = None
        logger.info(
            "serve engine up on %s: %d slots, %d+1 pages x %d tokens "
            "(%.1f MiB KV pool), prefill buckets %s", self.device,
            self.slots, pool_pages, self.page,
            self.pool.nbytes() / 2 ** 20, self.buckets)

    def _place(self, params: Any) -> Any:
        def place(tree, name=""):
            if isinstance(tree, dict):
                return {k: place(v, k) for k, v in tree.items()}
            t = torch.as_tensor(tree)
            dt = self.cfg.dtype if name in _CAST_AT_USE else t.dtype
            return t.to(device=self.device, dtype=dt)
        return place(params)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
        nxt, self.last_logits = _decode_body(
            self.cfg, self.params, self.k_pages, self.v_pages,
            self._tensor(bt_np), self._tensor(ln_np),
            self._tensor(np.asarray(tokens, np.int32)))
        self.tables.lengths[active] += 1
        return nxt.cpu().numpy()

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
            "spec_k": 0,
            "builds": self.builds,
            "store_outcomes": dict(self.store_outcomes),
            "tp": 1,
        }
