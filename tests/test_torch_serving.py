"""The PyTorch port's serving slice against the JAX package, on the CPU.

The tiny config of ``tests/test_serving.py`` (d=64, H=4, Dh=16, L=2,
V=256, f32; slots 4, page 16, chunk 64) runs through the JAX
``ServeEngine``/``ServeScheduler`` and the port's, with the JAX weights
carried across by ``params_from_numpy``. Greedy tokens must be identical
and logits within 1e-4 (f32; the two frameworks sum in different orders).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.serving import Request as JRequest
from horovod_tpu.serving import ServeEngine as JServeEngine
from horovod_tpu.serving import ServeScheduler as JServeScheduler
from horovod_tpu.serving import engine as jengine
from horovod_tpu_torch import (Request, ServeEngine, ServeScheduler,
                               TransformerConfig, init_params,
                               params_from_numpy)
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.serving import engine

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LOGIT_TOL = 1e-4
ENGINE_KW = dict(slots=4, page=16, max_seq=128, prefill_chunk=64)
CFG_KW = dict(vocab_size=256, d_model=64, n_heads=4, head_dim=16,
              n_layers=2, d_ff=128, max_seq=256, dp_axis=None, remat=False)


def _jcfg(**kw):
    return jtfm.TransformerConfig(**{**CFG_KW, "dtype": jnp.float32, **kw})


def _cfg(**kw):
    return TransformerConfig(**{**CFG_KW, "dtype": torch.float32, **kw})


@pytest.fixture(scope="module")
def jparams():
    return jtfm.init_params(_jcfg(), jax.random.PRNGKey(0))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _synchronous(jeng):
    """Make the JAX engine's compiled steps wait for their results. Its
    ``decode_step`` advances the host lengths right after dispatching the
    step, and with every slot active the step reads those very arrays:
    under asynchronous dispatch the step can see the advanced lengths
    (seen here as a batched run that diverges from its own solo run)."""
    def wait(fn):
        return lambda *args: jax.block_until_ready(fn(*args))
    jeng._decode = wait(jeng._decode)
    jeng._prefill = {b: wait(f) for b, f in jeng._prefill.items()}
    return jeng


def _engines(jparams, **kw):
    kw = {**ENGINE_KW, **kw}
    jeng = _synchronous(JServeEngine(_jcfg(), jparams, mesh=None, **kw))
    eng = ServeEngine(_cfg(), params_from_numpy(_np_tree(jparams), "cpu"),
                      device="cpu", **kw)
    return jeng, eng


def _spy_logits(jeng):
    """Record the logits the JAX engine's compiled steps return (its slot
    API returns tokens only)."""
    seen = []

    def wrap(fn):
        def call(*args):
            out = fn(*args)
            seen.append(np.asarray(out[3]))
            return out
        return call

    jeng._decode = wrap(jeng._decode)
    jeng._prefill = {b: wrap(f) for b, f in jeng._prefill.items()}
    return seen


def _prompts(seed, n, lo=4, hi=100):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the pieces where a port goes wrong
# ---------------------------------------------------------------------------

def test_rope_rmsnorm_gelu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 4, 16)).astype(np.float32)
    pos = np.asarray([0, 1, 7, 100, 2047], np.int32)
    np.testing.assert_allclose(
        engine._rope_rows(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jengine._rope_rows(jnp.asarray(x), jnp.asarray(pos))),
        rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    scale = rng.standard_normal((64,)).astype(np.float32)
    np.testing.assert_allclose(
        tfm._rmsnorm(torch.from_numpy(h), torch.from_numpy(scale)).numpy(),
        np.asarray(jtfm._rmsnorm(jnp.asarray(h), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    hb = torch.from_numpy(h).bfloat16()
    assert tfm._rmsnorm(hb, torch.from_numpy(scale)).dtype == torch.bfloat16
    lp = {"mlp_norm": scale,
          "w_in": rng.standard_normal((64, 128)).astype(np.float32),
          "w_out": rng.standard_normal((128, 64)).astype(np.float32) * 0.1}
    ours = engine._mlp(_cfg(), {k: torch.from_numpy(v) for k, v in
                                lp.items()}, torch.from_numpy(h)).numpy()
    theirs = np.asarray(jengine._mlp(_jcfg(), {k: jnp.asarray(v) for k, v
                                               in lp.items()},
                                     jnp.asarray(h)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_argmax_takes_the_first_maximum_like_jax():
    row = np.asarray([[0.5, 2.0, 2.0, -1.0, 2.0], [3.0, 3.0, 0.0, 1.0, 3.0]],
                     np.float32)
    assert (torch.argmax(torch.from_numpy(row), dim=-1).tolist()
            == np.asarray(jnp.argmax(jnp.asarray(row), axis=-1)).tolist()
            == [1, 0])


def test_init_params_tree_matches_jax_and_is_seeded():
    cfg = _cfg()
    ours = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    again = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    theirs = jtfm.init_params(_jcfg(), jax.random.PRNGKey(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
    ours_flat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), ours))[0])
    assert {jax.tree_util.keystr(k): v.shape for k, v in flat.items()} == \
        {jax.tree_util.keystr(k): v.shape for k, v in ours_flat.items()}
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), ours)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 again))):
        np.testing.assert_array_equal(a, b)
    assert ours["layers"]["wq"].dtype == torch.float32
    moe = init_params(_cfg(num_experts=2), device="cpu")
    assert tuple(moe["layers"]["w_in"].shape) == (2, 2, 64, 128)


def test_params_from_numpy_keeps_the_stacked_tree(jparams):
    p = params_from_numpy(_np_tree(jparams), device="cpu",
                          dtype=torch.bfloat16)
    assert tuple(p["layers"]["wq"].shape) == (2, 64, 64)
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params_from_numpy(_np_tree(jparams), "cpu")["head"].numpy(),
        np.asarray(jparams["head"]))


# ---------------------------------------------------------------------------
# engine against the JAX engine
# ---------------------------------------------------------------------------

def test_prefill_and_decode_trajectory_matches_jax(jparams):
    """Two slots (one prompt crosses a chunk), an inactive slot, six
    decode steps: greedy tokens identical, logits within 1e-4."""
    jeng, eng = _engines(jparams)
    seen = _spy_logits(jeng)
    prompts = _prompts(3, 2, 20, 90)
    prompts[0] = np.resize(prompts[0], 70)              # two chunks
    slots, toks = [], []
    for p in prompts:
        s, js = eng.reserve(len(p) + 8), jeng.reserve(len(p) + 8)
        assert s == js
        t = eng.prefill(s, p)
        assert t == jeng.prefill(js, p)
        np.testing.assert_allclose(eng.last_logits.numpy(), seen[-1],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        slots.append(s)
        toks.append(t)
    for _ in range(6):
        tokens = np.zeros((eng.slots,), np.int32)
        tokens[slots] = toks
        nxt, jnxt = eng.decode_step(tokens), jeng.decode_step(tokens)
        np.testing.assert_array_equal(nxt[slots], jnxt[slots])
        np.testing.assert_allclose(eng.last_logits.numpy()[slots],
                                   seen[-1][slots],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        toks = [int(nxt[s]) for s in slots]
    np.testing.assert_array_equal(eng.tables.lengths, jeng.tables.lengths)
    np.testing.assert_array_equal(eng.tables.tables, jeng.tables.tables)


def test_engine_matches_jax_training_model_teacher_forced(jparams):
    """Prefill + paged decode reproduce the JAX training ``logits_fn``."""
    _, eng = _engines(jparams)
    cfg = _jcfg()
    prompt = np.random.default_rng(3).integers(0, 256, 70).astype(np.int32)
    slot = eng.reserve(len(prompt) + 8)
    seq = list(prompt)
    tok = eng.prefill(slot, prompt)
    for step in range(7):
        full = np.asarray(jtfm.logits_fn(
            cfg, jparams, jnp.asarray(np.array(seq))[None]))[0]
        last = eng.last_logits.numpy()
        last = last if step == 0 else last[slot]
        np.testing.assert_allclose(last, full[-1], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        assert tok == int(np.argmax(full[-1]))
        seq.append(tok)
        tokens = np.zeros((eng.slots,), np.int32)
        tokens[slot] = tok
        tok = int(eng.decode_step(tokens)[slot])


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_scheduler_tokens_match_jax(jparams, mode):
    jeng, eng = _engines(jparams)
    prompts = _prompts(4, 6)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=8)
             for i, p in enumerate(prompts)]
    done = ServeScheduler(eng, mode=mode, queue_deadline=0.0,
                          device="cpu").run(reqs)
    jsched = JServeScheduler(jeng, mode=mode, queue_deadline=0.0)
    jdone = jsched.run(jreqs)
    assert len(done) == len(jdone) == 6
    ours = {r.rid: r.tokens for r in done}
    theirs = {r.rid: r.tokens for r in jdone}
    assert ours == theirs
    assert all(len(t) == 8 for t in ours.values())
    assert eng.allocator.free_pages == eng.pool.n_pages


def test_scheduler_stats_and_engine_stats_keys_match_jax(jparams):
    jeng, eng = _engines(jparams)
    assert set(eng.stats()) == set(jeng.stats())
    assert eng.stats()["builds"] == 0 and eng.stats()["store_outcomes"] == {}
    sched = ServeScheduler(eng, queue_deadline=0.0, device="cpu")
    jsched = JServeScheduler(jeng, queue_deadline=0.0)
    p = _prompts(5, 1)[0]
    sched.run([Request(rid=0, prompt=p, max_new_tokens=3)])
    jsched.run([JRequest(rid=0, prompt=p, max_new_tokens=3)])
    ours, theirs = sched.stats(), jsched.stats()
    assert set(ours) == set(theirs)
    for k in ("completed", "generated_tokens", "decode_steps",
              "mean_occupancy", "prefix", "spec"):
        assert ours[k] == theirs[k], k


def test_prefix_cache_gives_the_same_tokens_as_off(jparams):
    """Shared-prefix prompts (full-page shares and a mid-page divergence
    that copy-on-writes) give the tokens of the cache-off engine and of
    the JAX engine with the cache on."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 256, 48).astype(np.int32)     # 3 full pages
    prompts = [np.concatenate([shared, rng.integers(0, 256, n).astype(
        np.int32)]) for n in (10, 7, 12)]
    prompts.append(prompts[0].copy())
    prompts[-1][40] = (prompts[-1][40] + 1) % 256          # COW at page 2

    def run(eng, sched_cls, req_cls, **kw):
        out = {}
        for wave in (prompts[:1], prompts[1:]):           # seed the index
            s = sched_cls(eng, queue_deadline=0.0, **kw)
            for r in s.run([req_cls(rid=len(out) + i, prompt=p,
                                    max_new_tokens=6)
                            for i, p in enumerate(wave)]):
                out[r.rid] = r.tokens
        return out, s

    jon, on = _engines(jparams, prefix_cache=True)
    _, off = _engines(jparams)
    on_tokens, s_on = run(on, ServeScheduler, Request, device="cpu")
    off_tokens, _ = run(off, ServeScheduler, Request, device="cpu")
    j_tokens, js_on = run(jon, JServeScheduler, JRequest)
    assert on_tokens == off_tokens == j_tokens
    assert on.cow_copies == jon.cow_copies >= 1
    assert s_on.stats()["prefix"] == js_on.stats()["prefix"]
    assert s_on.stats()["prefix"]["hit_rate"] > 0.5


def test_prefill_interleaves_one_chunk_per_cycle(jparams):
    _, eng = _engines(jparams, prefill_chunk=32)
    sched = ServeScheduler(eng, queue_deadline=0.0, device="cpu")
    rng = np.random.default_rng(7)
    short = Request(rid=0, prompt=rng.integers(0, 256, 8).astype(np.int32),
                    max_new_tokens=10)
    sched.submit(short)
    sched.step()
    long = Request(rid=1, prompt=rng.integers(0, 256, 90).astype(np.int32),
                   max_new_tokens=4)
    sched.submit(long)
    before = len(short.tokens)
    for chunk in (1, 2):
        sched.step()
        assert long.slot in sched.prefilling
        assert long._prefill_pos == 32 * chunk
        assert len(short.tokens) == before + chunk
    sched.step()
    assert long.slot not in sched.prefilling and long.tokens
    sched.run()
    assert {r.rid for r in sched.completed} == {0, 1}


def test_context_ceiling_clamp_reject_and_eos_match_jax(jparams):
    jeng, eng = _engines(jparams, max_seq=64)
    mk = [(0, np.arange(60, dtype=np.int32), 100, None),
          (1, np.arange(80, dtype=np.int32), 4, None),
          (2, np.arange(64, dtype=np.int32), 4, None)]
    done = ServeScheduler(eng, queue_deadline=0.0, device="cpu").run(
        [Request(rid=r, prompt=p, max_new_tokens=n) for r, p, n, _ in mk])
    jdone = JServeScheduler(jeng, queue_deadline=0.0).run(
        [JRequest(rid=r, prompt=p, max_new_tokens=n) for r, p, n, _ in mk])
    assert ({r.rid: (r.tokens, r.error) for r in done}
            == {r.rid: (r.tokens, r.error) for r in jdone})
    first = done[[r.rid for r in done].index(0)].tokens[0]
    eos = ServeScheduler(eng, queue_deadline=0.0, device="cpu").run(
        [Request(rid=9, prompt=np.arange(60, dtype=np.int32),
                 max_new_tokens=50, eos_token=first)])
    assert eos[0].tokens == [first]


def test_engine_admission_and_release(jparams):
    _, eng = _engines(jparams, slots=2, max_seq=64)
    s0, s1 = eng.reserve(60), eng.reserve(60)
    assert s0 is not None and s1 is not None
    assert eng.reserve(16) is None
    eng.release(s0)
    assert eng.allocator.free_pages == 4
    assert eng.reserve(16) is not None
    assert eng.bucket_for(1) == 32 and eng.bucket_for(33) == 64
    assert engine.prefill_buckets(256) == [32, 64, 128, 256]
    assert engine.prefill_buckets(96) == [32, 64, 96]


def test_engine_rejects_what_the_slice_does_not_serve(jparams):
    params = params_from_numpy(_np_tree(jparams), "cpu")
    with pytest.raises(ValueError, match="dense TP/DP"):
        ServeEngine(_cfg(sp_axis="sp"), params, device="cpu")
    with pytest.raises(ValueError, match="not yet ported"):
        ServeEngine(_cfg(tp_axis="tp"), params, device="cpu")
    with pytest.raises(ValueError, match="not yet ported"):
        ServeEngine(_cfg(), params, device="cpu", draft="ngram:3")
    _, eng = _engines(jparams)
    with pytest.raises(ValueError, match="HOROVOD_SERVE_MAX_SEQ"):
        eng.prefill(eng.reserve(16), np.zeros(4096, np.int32))
    with pytest.raises(ValueError, match="engine on cpu"):
        ServeScheduler(eng, device="meta")


def test_bf16_engine_runs_on_cpu_without_the_kernel(jparams):
    eng = ServeEngine(_cfg(dtype=torch.bfloat16),
                      params_from_numpy(_np_tree(jparams), "cpu"),
                      device="cpu", **ENGINE_KW)
    assert eng.params["layers"]["wq"].dtype == torch.bfloat16
    assert eng.params["layers"]["attn_norm"].dtype == torch.float32
    fa.reset_launches()
    done = ServeScheduler(eng, queue_deadline=0.0, device="cpu").run(
        [Request(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(_prompts(8, 3))])
    assert all(len(r.tokens) == 4 for r in done)
    assert torch.isfinite(eng.last_logits).all()
    assert fa.LAUNCHES["paged_decode"] == 0


# ---------------------------------------------------------------------------
# import hygiene and device discipline
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import horovod_tpu_torch\n"
        "for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,\n"
        "                               'horovod_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith('jax.') or k == 'horovod_tpu'\n"
        "             or k.startswith('horovod_tpu.'))\n"
        "assert not bad, bad\n"
        "import horovod_tpu_torch.ops._build as b\n"
        "assert not b._libs, 'a kernel was built at import time'\n"
        "print('ok', len([k for k in sys.modules\n"
        "                 if k.startswith('horovod_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) >= 12


def test_entry_points_default_to_cuda_and_raise_without_a_gpu(jparams):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    tree = _np_tree(jparams)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tree)
    params = params_from_numpy(tree, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(_cfg(), params, **ENGINE_KW)
    eng = ServeEngine(_cfg(), params, device="cpu", **ENGINE_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeScheduler(eng)


def test_one_environment_configures_both_packages(jparams, monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_SLOTS", "3")
    monkeypatch.setenv("HOROVOD_SERVE_PAGE", "32")
    monkeypatch.setenv("HOROVOD_SERVE_PREFIX_CACHE", "1")
    jeng = JServeEngine(_jcfg(), jparams, mesh=None, max_seq=128,
                        prefill_chunk=64)
    eng = ServeEngine(_cfg(), params_from_numpy(_np_tree(jparams), "cpu"),
                      device="cpu", max_seq=128, prefill_chunk=64)
    for k in ("slots", "page", "prefix_cache", "pages_total",
              "prefill_buckets"):
        assert eng.stats()[k] == jeng.stats()[k], k
    assert eng.slots == 3 and eng.page == 32 and eng.prefix_cache
