"""Paged KV cache of the PyTorch port against the JAX package: the same
allocator / prefix-index / block-table operation sequence gives the same
page ids, and the page writes and the copy-on-write give the same pools
(exactly: they move values, they compute nothing)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.serving import kv_cache as jkvc
from horovod_tpu_torch.serving import kv_cache as kvc


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _allocator_trace(mod, seed):
    rng = np.random.default_rng(seed)
    a = mod.PageAllocator(12)
    live, trace = [], []
    for _ in range(60):
        op = rng.integers(0, 3)
        if op == 0 and a.can_alloc(2):
            got = a.alloc(int(rng.integers(1, 3)))
            live.append(got)
            trace.append(("alloc", tuple(got)))
        elif op == 1 and live:
            pages = live.pop(int(rng.integers(0, len(live))))
            a.free(pages)
            trace.append(("free", tuple(pages)))
        elif op == 2 and live:
            p = live[int(rng.integers(0, len(live)))][0]
            a.incref(p)
            live.append([p])
            trace.append(("incref", p))
        trace.append((a.free_pages, a.shared_pages, a.held_refs))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_trace_matches_jax(seed):
    assert _allocator_trace(kvc, seed) == _allocator_trace(jkvc, seed)


def test_allocator_errors_match_jax():
    for mod in (kvc, jkvc):
        a = mod.PageAllocator(4)
        got = a.alloc(3)
        with pytest.raises(MemoryError, match="HOROVOD_SERVE_PAGES"):
            a.alloc(2)
        a.free(got)
        with pytest.raises(ValueError, match="invalid page"):
            a.free([99])
        with pytest.raises(ValueError, match="double free"):
            a.decref(0)
        with pytest.raises(ValueError, match="not allocated"):
            a.incref(1)


def _prefix_trace(mod):
    rng = np.random.default_rng(11)
    a = mod.PageAllocator(10)
    idx = mod.PrefixIndex(4, a)
    shared = rng.integers(0, 50, 8).astype(np.int32)
    trace = []
    for i in range(6):
        tail = rng.integers(0, 50, int(rng.integers(1, 7))).astype(np.int32)
        prompt = np.concatenate([shared, tail])
        if i == 4:
            prompt[5] = (prompt[5] + 1) % 50        # divergence mid-block
        pages, skip, cow = idx.match(prompt)
        n_tail = -(-prompt.size // 4) - len(pages)
        if not a.can_alloc(n_tail):
            trace.append(("evicted", idx.evict(n_tail)))
        own = a.alloc(n_tail)
        for p in pages:
            a.incref(p)
        trace.append((tuple(pages), skip, cow, tuple(own)))
        trace.append(("registered", idx.register(prompt, pages + own)))
        a.free(pages + own)
        trace.append((a.free_pages, a.shared_pages, len(idx),
                      idx.evictions))
    trace.append(("evict_all", idx.evict(10), a.free_pages, a.held_refs))
    return trace


def test_prefix_index_trace_matches_jax():
    assert _prefix_trace(kvc) == _prefix_trace(jkvc)


def test_block_tables_match_jax():
    ours, theirs = kvc.BlockTables(3, 5, 9), jkvc.BlockTables(3, 5, 9)
    for bt in (ours, theirs):
        bt.assign(1, [4, 2, 7])
        bt.lengths[1] = 11
        bt.assign(0, [0])
        bt.clear(1)
        with pytest.raises(ValueError, match="HOROVOD_SERVE_MAX_SEQ"):
            bt.assign(2, list(range(6)))
    np.testing.assert_array_equal(ours.tables, theirs.tables)
    np.testing.assert_array_equal(ours.lengths, theirs.lengths)
    t, ln = ours.device_views("cpu")
    assert t.dtype == torch.int32 and ln.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), ours.tables)


def test_page_pool_geometry():
    pool = kvc.PagePool(2, 6, 16, 4, 8, dtype=torch.bfloat16, device="cpu")
    jpool = jkvc.PagePool(2, 6, 16, 4, 8, dtype=jnp.bfloat16)
    k, v = pool.alloc_arrays()
    jk, _ = jpool.alloc_arrays()
    assert tuple(k.shape) == jk.shape and k.dtype == torch.bfloat16
    assert not k.any() and not v.any()
    assert pool.scratch_page == jpool.scratch_page == 6
    assert pool.nbytes() == jpool.nbytes()
    assert pool.pages_for(33) == jpool.pages_for(33) == 3


def _pools(rng, n_phys=7, page=4, kvh=2, d=8):
    k = rng.standard_normal((n_phys, page, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n_phys, page, kvh, d)).astype(np.float32)
    return k, v


def test_write_token_kv_matches_jax():
    rng = np.random.default_rng(20)
    k, v = _pools(rng)
    kn = rng.standard_normal((4, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((4, 2, 8)).astype(np.float32)
    bt = np.asarray([[0, 1], [2, 3], [6, 6], [4, 5]], np.int32)
    pos = np.asarray([5, 2, 0, 8], np.int32)        # row 3 is past the table
    valid = pos < 8
    jk, jv = jkvc.write_token_kv(jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(bt), jnp.asarray(pos),
                                 valid=jnp.asarray(valid))
    tk, tv = _t(k.copy()), _t(v.copy())
    out = kvc.write_token_kv(tk, tv, _t(kn), _t(vn), _t(bt), _t(pos),
                             valid=_t(valid))
    assert out[0] is tk and out[1] is tv            # updated in place
    # row 2 (an empty slot) and row 3 both sink into the scratch page; the
    # duplicate scatter there is nondeterministic, so compare real pages
    np.testing.assert_array_equal(tk.numpy()[:6], np.asarray(jk)[:6])
    np.testing.assert_array_equal(tv.numpy()[:6], np.asarray(jv)[:6])


def test_write_chunk_kv_matches_jax():
    rng = np.random.default_rng(21)
    k, v = _pools(rng)
    c = 8
    kn = rng.standard_normal((c, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((c, 2, 8)).astype(np.float32)
    bt = np.asarray([3, 1, 0], np.int32)
    for start, n_real in ((0, 8), (2, 5), (6, 3)):
        jk, jv = jkvc.write_chunk_kv(jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.asarray(bt), jnp.asarray(start),
                                     jnp.asarray(n_real))
        tk, tv = _t(k.copy()), _t(v.copy())
        kvc.write_chunk_kv(tk, tv, _t(kn), _t(vn), _t(bt), start, n_real)
        np.testing.assert_array_equal(tk.numpy()[:6], np.asarray(jk)[:6])
        np.testing.assert_array_equal(tv.numpy()[:6], np.asarray(jv)[:6])


def test_copy_page_and_gather_match_jax():
    rng = np.random.default_rng(22)
    k = rng.standard_normal((2, 7, 4, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 7, 4, 2, 8)).astype(np.float32)
    jk, jv = jkvc.copy_page(jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(1, jnp.int32),
                            jnp.asarray(4, jnp.int32))
    tk, tv = _t(k.copy()), _t(v.copy())
    kvc.copy_page(tk, tv, 1, 4)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    bt = np.asarray([5, 0, 2], np.int32)
    np.testing.assert_array_equal(
        kvc.gather_pages(tk[1], _t(bt)).numpy(),
        np.asarray(jkvc.gather_pages(jk[1], jnp.asarray(bt))))
