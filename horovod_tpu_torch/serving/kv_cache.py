"""Paged KV cache of the PyTorch serving engine.

The counterpart of ``horovod_tpu/serving/kv_cache.py`` (PagedAttention,
vLLM SOSP '23): K/V live in a fixed pool of pages
``[L, n_pages + 1, page, n_kv_heads, head_dim]`` shared by every request;
each request owns an ordered block table of physical page ids, and decode
attention follows the table in place (the CUDA kernel
``ops.flash_attention.flash_paged_decode`` on the card,
:func:`paged_attention_reference` on the CPU). The extra page, physical
id ``n_pages``, is the scratch page that absorbs the writes of padded
positions and empty slots.

Host state (:class:`PageAllocator`, :class:`PrefixIndex`,
:class:`BlockTables`) is numpy and plain Python, the same classes as the
JAX package's: the same operation sequence hands out the same page ids.
Device writes differ in one respect: where the JAX steps rebuild the
pool functionally and donate the old buffers, the port updates the pool
tensors in place (``index_put_``, slice assignment).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from horovod_tpu_torch.utils.device import resolve_device


class PagePool:
    """Static geometry of the paged cache, fixed at engine build time."""

    def __init__(self, n_layers: int, n_pages: int, page: int,
                 n_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        if n_pages < 1 or page < 1:
            raise ValueError(
                f"page pool needs n_pages>=1 and page>=1, got "
                f"n_pages={n_pages}, page={page}")
        self.n_layers = int(n_layers)
        self.n_pages = int(n_pages)
        self.page = int(page)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.device = resolve_device(device)

    @property
    def scratch_page(self) -> int:
        """Physical id of the write sink for padded/empty positions."""
        return self.n_pages

    def alloc_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed (k_pages, v_pages), each
        ``[n_layers, n_pages + 1, page, n_kv_heads, head_dim]``."""
        shape = (self.n_layers, self.n_pages + 1, self.page,
                 self.n_kv_heads, self.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.page)

    def nbytes(self) -> int:
        """Device memory the pool holds (K and V, scratch page included)."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return (2 * self.n_layers * (self.n_pages + 1) * self.page
                * self.n_kv_heads * self.head_dim * itemsize)


def _pool_gauges():
    """The hvd_serve_pages_* gauges, created at the allocator's first
    state change (not at import)."""
    from horovod_tpu_torch import metrics as M
    return (
        M.gauge("hvd_serve_pages_free",
                "Free pages in the serving KV pool"),
        M.gauge("hvd_serve_pages_shared",
                "Serving KV pool pages with more than one holder "
                "(N block tables and/or the prefix index)"),
    )


class PageAllocator:
    """Refcounted LIFO free list over physical page ids ``[0, n_pages)``;
    the scratch page is never handed out. A page returns to the free list
    when its last holder (a block table or the prefix index) lets go.
    Every change publishes ``hvd_serve_pages_free`` and
    ``hvd_serve_pages_shared``."""

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self._gauges = None

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages currently held by more than one holder."""
        return sum(1 for c in self._refs.values() if c > 1)

    @property
    def held_refs(self) -> int:
        """Total outstanding references across all live pages."""
        return sum(self._refs.values())

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def _publish(self) -> None:
        if self._gauges is None:
            self._gauges = _pool_gauges()
        self._gauges[0].set(len(self._free))
        self._gauges[1].set(self.shared_pages)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV page pool exhausted: {n} pages requested, "
                f"{len(self._free)} free of {self.n_pages} "
                f"(raise HOROVOD_SERVE_PAGES or lower "
                f"HOROVOD_SERVE_SLOTS / HOROVOD_SERVE_MAX_SEQ)")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        self._publish()
        return out

    def incref(self, page: int) -> None:
        """Add a holder to a live page."""
        p = int(page)
        if p not in self._refs:
            raise ValueError(
                f"incref of page {p} which is not allocated — a prefix "
                f"match must only hand out pages the index still holds")
        self._refs[p] += 1
        self._publish()

    def decref(self, page: int) -> bool:
        """Drop one holder; True when the page went back to the free
        list. Double frees raise."""
        p = int(page)
        if not (0 <= p < self.n_pages):
            raise ValueError(f"freeing invalid page id {p}")
        c = self._refs.get(p)
        if not c:
            raise ValueError(
                f"double free of KV page {p}: refcount is already 0 "
                f"(every holder must decref exactly once)")
        if c > 1:
            self._refs[p] = c - 1
            self._publish()
            return False
        del self._refs[p]
        self._free.append(p)
        self._publish()
        return True

    def free(self, pages: List[int]) -> None:
        """Drop one holder from each page."""
        for p in pages:
            self.decref(p)


def _chain_hash(prev: bytes, block: np.ndarray) -> bytes:
    """One link of the prefix hash chain: ``h_i = H(h_{i-1} || block_i)``,
    so a block's identity is its full token prefix."""
    return hashlib.sha256(
        prev + np.ascontiguousarray(block, np.int32).tobytes()).digest()


@dataclasses.dataclass
class _PrefixEntry:
    page: int                   # physical page id (one index-held ref)
    tokens: np.ndarray          # the full token block backing the page
    prev: bytes                 # parent chain hash
    stamp: int                  # LRU clock


class PrefixIndex:
    """Hash-chain index of resident prompt-prefix pages: full
    page-granularity token blocks of completed prefills, looked up by
    longest-prefix match. Each entry holds one allocator reference on its
    page; eviction is LRU over leaf entries whose page has no other
    holder."""

    def __init__(self, page: int, allocator: PageAllocator):
        self.page = int(page)
        self.allocator = allocator
        self._entries: Dict[bytes, _PrefixEntry] = {}
        self._children: Dict[bytes, Set[bytes]] = {}
        self._clock = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _bump(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, prompt: np.ndarray
              ) -> Tuple[List[int], int, Optional[Tuple[int, int]]]:
        """Longest resident prefix of ``prompt``: ``(pages, skip, cow)`` —
        matched full blocks' page ids (not yet increfed), prompt tokens
        they cover, and an optional ``(src_page, n_tokens)`` partial-block
        match to copy-on-write. At least one prompt token is always left
        to prefill."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = int(prompt.size)
        max_full = max((n - 1) // self.page, 0)
        h, pages, skip = b"", [], 0
        blocks = 0
        while blocks < max_full:
            block = prompt[blocks * self.page:(blocks + 1) * self.page]
            nh = _chain_hash(h, block)
            e = self._entries.get(nh)
            if e is None:
                break
            e.stamp = self._bump()
            pages.append(e.page)
            skip += self.page
            h = nh
            blocks += 1
        cow: Optional[Tuple[int, int]] = None
        rest = prompt[skip:]
        best = 0
        for ch in self._children.get(h, ()):
            e = self._entries.get(ch)
            if e is None:
                continue
            m = min(int(rest.size), self.page)
            neq = np.nonzero(e.tokens[:m] != rest[:m])[0]
            t = int(neq[0]) if neq.size else m
            t = min(t, n - 1 - skip)    # leave >=1 token to prefill
            if t > best:
                best = t
                cow = (e.page, t)
                e.stamp = self._bump()
        return pages, skip, cow

    def register(self, prompt: np.ndarray, pages: Sequence[int]) -> int:
        """Index every full prompt block of a freshly prefilled request
        (``pages`` in block-table order); returns pages newly indexed."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n_full = int(prompt.size) // self.page
        h, added = b"", 0
        for i in range(min(n_full, len(pages))):
            block = prompt[i * self.page:(i + 1) * self.page]
            nh = _chain_hash(h, block)
            e = self._entries.get(nh)
            if e is None:
                self.allocator.incref(pages[i])
                self._entries[nh] = _PrefixEntry(
                    page=int(pages[i]), tokens=block.copy(), prev=h,
                    stamp=self._bump())
                self._children.setdefault(h, set()).add(nh)
                added += 1
            else:
                e.stamp = self._bump()
            h = nh
        return added

    def evict(self, n_pages_needed: int) -> int:
        """LRU-evict index-only leaf entries until the allocator can cover
        ``n_pages_needed`` (or nothing evictable remains); returns pages
        freed."""
        freed = 0
        while self.allocator.free_pages < n_pages_needed:
            cand = [(e.stamp, h) for h, e in self._entries.items()
                    if not self._children.get(h)
                    and self.allocator.refcount(e.page) == 1]
            if not cand:
                break
            _, h = min(cand)
            e = self._entries.pop(h)
            self._children.get(e.prev, set()).discard(h)
            self._children.pop(h, None)
            if self.allocator.decref(e.page):
                freed += 1
            self.evictions += 1
        return freed

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries),
                "evictions": self.evictions}


class BlockTables:
    """Per-slot block tables + lengths, host-side (numpy int32).
    Unassigned entries hold the scratch page id."""

    def __init__(self, n_slots: int, n_max_pages: int, scratch_page: int):
        self.n_slots = int(n_slots)
        self.n_max_pages = int(n_max_pages)
        self.scratch_page = int(scratch_page)
        self.tables = np.full((n_slots, n_max_pages), scratch_page,
                              np.int32)
        self.lengths = np.zeros((n_slots,), np.int32)

    def assign(self, slot: int, pages: List[int]) -> None:
        if len(pages) > self.n_max_pages:
            raise ValueError(
                f"request needs {len(pages)} pages but the block table "
                f"holds {self.n_max_pages} (HOROVOD_SERVE_MAX_SEQ)")
        self.tables[slot, :] = self.scratch_page
        self.tables[slot, :len(pages)] = pages
        self.lengths[slot] = 0

    def clear(self, slot: int) -> None:
        self.tables[slot, :] = self.scratch_page
        self.lengths[slot] = 0

    def device_views(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(self.tables).to(device),
                torch.from_numpy(self.lengths).to(device))


# ---------------------------------------------------------------------------
# page writes (in place)
# ---------------------------------------------------------------------------
#
# Duplicate scatter indices: several empty slots (or padding positions of a
# prefill chunk longer than a page) write to the same scratch-page row in
# one index_put_. On CUDA which of the duplicates lands is nondeterministic;
# that is harmless only because nothing reads the scratch page as data —
# every read of it is masked out by a length.

def write_token_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   block_tables: torch.Tensor, positions: torch.Tensor,
                   valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token's K/V per sequence into its page, in place.

    k_pages/v_pages ``[n_phys, page, KVH, D]`` (one layer), k_new/v_new
    ``[B, KVH, D]``, block_tables ``[B, n_max]``, positions ``[B]`` (the
    token index each write lands at), valid ``[B]`` bool — invalid writes
    go to the scratch page (the last physical page). Returns the same
    (updated) tensors."""
    page = k_pages.shape[1]
    scratch = k_pages.shape[0] - 1
    pos = positions.long()
    logical = (pos // page).clamp(0, block_tables.shape[1] - 1)
    phys = torch.gather(block_tables.long(), 1, logical[:, None])[:, 0]
    offs = pos % page
    if valid is not None:
        phys = torch.where(valid, phys, torch.full_like(phys, scratch))
    k_pages.index_put_((phys, offs), k_new.to(k_pages.dtype))
    v_pages.index_put_((phys, offs), v_new.to(v_pages.dtype))
    return k_pages, v_pages


def write_chunk_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   block_table: torch.Tensor, start: int,
                   n_real: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write a prefill chunk's K/V (one sequence) into its pages, in place.

    k_new/v_new ``[C, KVH, D]`` for positions ``start .. start + C``;
    positions at or past ``start + n_real`` are padding and land on the
    scratch page. block_table ``[n_max]``."""
    page = k_pages.shape[1]
    scratch = k_pages.shape[0] - 1
    c = k_new.shape[0]
    idx = torch.arange(c, device=k_pages.device)
    pos = int(start) + idx
    phys = block_table.long()[(pos // page).clamp(0, block_table.shape[0] - 1)]
    phys = torch.where(idx < int(n_real), phys, torch.full_like(phys, scratch))
    offs = pos % page
    k_pages.index_put_((phys, offs), k_new.to(k_pages.dtype))
    v_pages.index_put_((phys, offs), v_new.to(v_pages.dtype))
    return k_pages, v_pages


def copy_page(k_pages: torch.Tensor, v_pages: torch.Tensor,
              src: int, dst: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy-on-write body: duplicate ONE physical page across every layer
    of ``[L, n_phys, page, KVH, D]`` pools, in place."""
    k_pages[:, int(dst)] = k_pages[:, int(src)]
    v_pages[:, int(dst)] = v_pages[:, int(src)]
    return k_pages, v_pages


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """Contiguous ``[n_max*page, KVH, D]`` copy of one sequence's pages
    (one layer) in block-table order — the prefill attention context."""
    g = pages[block_table.long()]                # [n_max, page, KVH, D]
    return g.reshape((-1,) + tuple(g.shape[2:]))


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              lengths: torch.Tensor, scale: float
                              ) -> torch.Tensor:
    """Plain PyTorch version of the paged-decode kernel (one layer):
    gather each sequence's pages, mask past its length, stable softmax in
    f32. Output ``[B, H, D]`` f32; empty sequences give zeros."""
    b, h, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    n_max = block_tables.shape[1]
    qpk = h // kvh
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, n_max * page, kvh, d).float()
    v = v_pages[bt].reshape(b, n_max * page, kvh, d).float()
    if qpk > 1:                                  # GQA: group heads
        k = k.repeat_interleave(qpk, dim=2)
        v = v.repeat_interleave(qpk, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    mask = (torch.arange(n_max * page, device=q.device)[None, :]
            < lengths.long()[:, None])[:, None, :]          # [B, 1, S]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhs,bshd->bhd", p / l, v)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, scale: float
                           ) -> torch.Tensor:
    """Dispatch on the tensors' device: the CUDA kernel on the card (which
    raises for a geometry it does not take), the plain version on the
    CPU."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         lengths, float(scale))
    from horovod_tpu_torch.ops import flash_attention as fa
    return fa.flash_paged_decode(q, k_pages, v_pages,
                                 block_tables.to(torch.int32).contiguous(),
                                 lengths.to(torch.int32).contiguous(),
                                 float(scale))
