"""Speculative decoding, the train-to-serve handoff and the serving metrics
of the port against the JAX package, on the CPU.

The tiny config of ``tests/test_torch_serving.py`` (d=64, H=4, Dh=16,
L=2, V=256, f32; slots 4, page 16, chunk 64), JAX weights carried across
with ``params_from_numpy``. Replays the JAX package's
``tests/test_serving.py`` speculative, handoff and metrics tests on both
engines: the verify step's ``out`` arrays, the scheduler's tokens and
its proposed/accepted tallies must be identical to the JAX engine's and
to the sequential (``draft="off"``) tokens.
"""

import numpy as np
import pytest
import torch

import jax

from horovod_tpu import metrics as JM
from horovod_tpu.serving import NGramDrafter as JNGramDrafter
from horovod_tpu.serving import Request as JRequest
from horovod_tpu.serving import ServeEngine as JServeEngine
from horovod_tpu.serving import ServeScheduler as JServeScheduler
from horovod_tpu_torch import metrics as M
from horovod_tpu_torch import (AsyncCheckpointer, Request, ServeEngine,
                               ServeScheduler, TrainState, params_from_numpy)
from horovod_tpu_torch import serving
from horovod_tpu_torch.serving import (NGramDrafter, load_for_serving,
                                       serving_stats)
import test_torch_serving as ts


@pytest.fixture(scope="module")
def jparams():
    return ts.jtfm.init_params(ts._jcfg(), jax.random.PRNGKey(0))


def _port_params(jparams):
    return params_from_numpy(ts._np_tree(jparams), "cpu")


def _synchronous(jeng):
    """``ts._synchronous`` for the speculative steps too."""
    ts._synchronous(jeng)

    def wait(fn):
        return None if fn is None else (
            lambda *args: jax.block_until_ready(fn(*args)))
    jeng._verify, jeng._draft = wait(jeng._verify), wait(jeng._draft)
    return jeng


def _engines(jparams, **kw):
    kw = {**ts.ENGINE_KW, **kw}
    jeng = _synchronous(JServeEngine(ts._jcfg(), jparams, mesh=None, **kw))
    eng = ServeEngine(ts._cfg(), _port_params(jparams), device="cpu", **kw)
    return jeng, eng


def _greedy_solo(eng, prompt, n_new):
    """The sequential truth: one request alone, prefill then decode."""
    slot = eng.reserve(prompt.size + n_new)
    out = [eng.prefill(slot, prompt)]
    tokens = np.zeros((eng.slots,), np.int32)
    active = np.zeros((eng.slots,), bool)
    active[slot] = True
    while len(out) < n_new:
        tokens[slot] = out[-1]
        out.append(int(eng.decode_step(tokens, active=active)[slot]))
    eng.release(slot)
    return out


def test_spec_step_accept_prefix_matches_jax_and_sequential(jparams):
    """Row i of the verify step is the token sequential decode emits after
    rows 0..i: right drafts are all confirmed (plus the bonus token), a
    wrong draft stops confirmation there, rollback restores the length;
    the ``out`` arrays are the JAX engine's."""
    jeng, eng = _engines(jparams, draft="ngram:1", spec_k=3)
    _, off = _engines(jparams)
    prompt = np.random.default_rng(14).integers(0, 256, 20).astype(np.int32)
    seq = _greedy_solo(off, prompt, 6)
    for e in (jeng, eng):
        slot = e.reserve(prompt.size + 6)
        assert e.prefill(slot, prompt) == seq[0]
    tokens = np.zeros((eng.slots,), np.int32)
    tokens[slot] = seq[0]
    drafts = np.zeros((eng.slots, 3), np.int32)
    drafts[slot] = seq[1:4]
    active = np.zeros((eng.slots,), bool)
    active[slot] = True
    out = eng.spec_step(tokens, drafts, active=active)
    np.testing.assert_array_equal(out, jeng.spec_step(tokens, drafts,
                                                      active=active))
    assert out[slot].tolist() == seq[1:5]
    assert eng.tables.lengths[slot] == prompt.size + 4
    assert eng.last_logits.shape == (eng.slots * 4, 256)
    tokens[slot] = seq[4]
    drafts[slot] = [seq[5], (seq[5] + 1) % 256, 0]
    out = eng.spec_step(tokens, drafts, active=active)
    np.testing.assert_array_equal(out, jeng.spec_step(tokens, drafts,
                                                      active=active))
    assert out[slot][0] == seq[5]
    for e in (jeng, eng):
        e.rollback(slot, 2)                 # draft 0 right, draft 1 wrong
        assert e.tables.lengths[slot] == prompt.size + 6
    np.testing.assert_array_equal(eng.tables.lengths, jeng.tables.lengths)
    with pytest.raises(ValueError, match="rollback of 99"):
        eng.rollback(slot, 99)
    with pytest.raises(RuntimeError, match="truncate:N"):
        eng.propose_drafts(tokens, active)
    with pytest.raises(RuntimeError, match="HOROVOD_SERVE_DRAFT"):
        off.spec_step(tokens, drafts, active=active)


def test_truncated_draft_proposals_match_jax(jparams):
    """``truncate:1``: the K draft tokens from the first layer, and the
    pool's layer-0 writes they leave, are the JAX engine's."""
    jeng, eng = _engines(jparams, draft="truncate:1", spec_k=3)
    prompts = ts._prompts(21, 2, 10, 40)
    tokens = np.zeros((eng.slots,), np.int32)
    active = np.zeros((eng.slots,), bool)
    for p in prompts:
        slots = [e.reserve(p.size + 8) for e in (jeng, eng)]
        assert slots[0] == slots[1]
        tokens[slots[1]] = eng.prefill(slots[1], p)
        assert jeng.prefill(slots[0], p) == tokens[slots[1]]
        active[slots[1]] = True
    drafts = eng.propose_drafts(tokens, active)
    np.testing.assert_array_equal(drafts,
                                  jeng.propose_drafts(tokens, active))
    np.testing.assert_array_equal(eng.tables.lengths, jeng.tables.lengths)
    n = eng.pool.n_pages                    # the scratch page excluded
    np.testing.assert_allclose(eng.k_pages[0, :n].numpy(),
                               np.asarray(jeng.k_pages)[0, :n],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("draft", ["ngram:3", "truncate:1"])
def test_scheduler_with_prefix_and_spec_equals_solo_and_jax(jparams, draft):
    """Continuous batching with the prefix cache AND speculation on: every
    request's tokens are its solo sequential tokens and the JAX
    scheduler's, with the JAX scheduler's proposed/accepted tallies."""
    _, off = _engines(jparams)
    rng = np.random.default_rng(15)
    shared = rng.integers(0, 256, 40).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, 256, int(rng.integers(5, 15)))]).astype(np.int32)
        for _ in range(6)]
    n_new = 10
    solo = [_greedy_solo(off, p, n_new) for p in prompts]
    jeng, eng = _engines(jparams, prefix_cache=True, draft=draft, spec_k=3)
    sched = ServeScheduler(eng, queue_deadline=0.0, device="cpu")
    done = sched.run([Request(rid=i, prompt=p, max_new_tokens=n_new)
                      for i, p in enumerate(prompts)])
    jsched = JServeScheduler(jeng, queue_deadline=0.0)
    jdone = jsched.run([JRequest(rid=i, prompt=p, max_new_tokens=n_new)
                        for i, p in enumerate(prompts)])
    ours = {r.rid: r.tokens for r in done}
    assert ours == {r.rid: r.tokens for r in jdone}
    assert ours == dict(enumerate(solo))
    st, jst = sched.stats(), jsched.stats()
    assert st["spec"] == jst["spec"] and st["prefix"] == jst["prefix"]
    assert st["prefix"]["hit_rate"] > 0 and st["spec"]["proposed"] > 0
    assert st["decode_steps"] == jst["decode_steps"]
    assert serving_stats()["scheduler"]["spec"]["draft"] == draft


def test_spec_eos_and_cap_cut_the_accepted_run(jparams):
    _, off = _engines(jparams)
    prompt = np.random.default_rng(16).integers(0, 256, 12).astype(np.int32)
    seq = _greedy_solo(off, prompt, 8)
    jeng, eng = _engines(jparams, draft="ngram:2", spec_k=4)
    for e, sched_cls, req_cls, kw in (
            (eng, ServeScheduler, Request, dict(device="cpu")),
            (jeng, JServeScheduler, JRequest, {})):
        done = sched_cls(e, queue_deadline=0.0, **kw).run(
            [req_cls(rid=0, prompt=prompt, max_new_tokens=3)])
        assert done[0].tokens == seq[:3]
        # an EOS token that first appears inside the run
        i = next(i for i in range(2, 8) if seq[i] not in seq[:i])
        done = sched_cls(e, queue_deadline=0.0, **kw).run(
            [req_cls(rid=0, prompt=prompt, max_new_tokens=8,
                     eos_token=int(seq[i]))])
        assert done[0].tokens == seq[:i + 1]
        assert e.allocator.free_pages == e.pool.n_pages


@pytest.mark.parametrize("draft,spec_k", [
    ("truncate", None), ("truncate:2", None), ("truncate:0", None),
    ("banana", None), ("ngram:0", None), ("ngram:3", 0)])
def test_draft_validation_errors_are_the_jax_errors(jparams, draft, spec_k):
    with pytest.raises(ValueError) as jerr:
        _engines(jparams, draft=draft, spec_k=spec_k)
    params = _port_params(jparams)
    with pytest.raises(ValueError) as err:
        ServeEngine(ts._cfg(), params, device="cpu", draft=draft,
                    spec_k=spec_k, **ts.ENGINE_KW)
    assert str(err.value) == str(jerr.value)


def test_parse_draft_and_knob_defaults(jparams, monkeypatch):
    from horovod_tpu.serving import engine as jengine
    from horovod_tpu_torch.serving import engine
    for spec in ("off", "", "0", "ngram", "ngram:5", "NGRAM:2 ",
                 "truncate:1"):
        assert engine._parse_draft(spec, 2) == jengine._parse_draft(spec, 2)
    monkeypatch.setenv("HOROVOD_SERVE_DRAFT", "ngram:2")
    monkeypatch.setenv("HOROVOD_SERVE_SPEC_K", "5")
    jeng = JServeEngine(ts._jcfg(), jparams, mesh=None, **ts.ENGINE_KW)
    eng = ServeEngine(ts._cfg(), _port_params(jparams), device="cpu",
                      **ts.ENGINE_KW)
    for k in ("draft", "spec_k"):
        assert eng.stats()[k] == jeng.stats()[k], k
    assert (eng.draft_mode, eng.draft_n, eng.spec_k) == ("ngram", 2, 5)


def test_ngram_drafter_proposals_match_jax():
    rng = np.random.default_rng(17)
    for n in (1, 2, 3, 5):
        ours, theirs = NGramDrafter(n), JNGramDrafter(n)
        for _ in range(40):
            h = rng.integers(0, 6, int(rng.integers(0, 30))).tolist()
            k = int(rng.integers(1, 6))
            assert ours.propose(h, k) == theirs.propose(h, k), (n, h, k)
    assert NGramDrafter(3).propose([1, 2, 3, 1, 2], 3) == [3, 1, 2]
    assert NGramDrafter(0).n == 1


def test_latency_buckets_are_the_jax_buckets():
    assert tuple(M.LATENCY_BUCKETS) == tuple(JM.LATENCY_BUCKETS)
    assert M.LATENCY_BUCKETS[0] < 0.001
    assert sum(1 for b in M.LATENCY_BUCKETS if b < 0.001) >= 3
    assert tuple(M.LATENCY_BUCKETS) == tuple(sorted(M.LATENCY_BUCKETS))


def _counts(mod):
    reg = mod.get_registry()

    def lab(name, **kw):
        m = reg.get(name)
        return 0.0 if m is None else m.labels(**kw).value

    ttft = reg.get("hvd_serve_ttft_seconds")
    tpot = reg.get("hvd_serve_tpot_seconds")
    return {
        **{e: lab("hvd_serve_requests_total", event=e)
           for e in ("submitted", "admitted", "completed", "rejected")},
        **{k: lab("hvd_serve_tokens_total", kind=k)
           for k in ("prefill", "decode")},
        "ttft": ttft.total_count if ttft is not None else 0,
        "tpot": tpot.total_count if tpot is not None else 0}


def test_serving_metrics_after_a_run_match_jax(jparams):
    """The hvd_serve_* counters and the TTFT/TPOT histograms move by what
    the JAX scheduler's move by over the same requests (one over the
    ceiling, rejected); the histograms use LATENCY_BUCKETS."""
    jeng, eng = _engines(jparams, max_seq=64)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, 12).astype(np.int32) for _ in range(3)]
    prompts.append(np.arange(80, dtype=np.int32))        # over the ceiling
    deltas = []
    for mod, e, sched_cls, req_cls, kw in (
            (M, eng, ServeScheduler, Request, dict(device="cpu")),
            (JM, jeng, JServeScheduler, JRequest, {})):
        before = _counts(mod)
        sched = sched_cls(e, queue_deadline=0.0, **kw)
        sched.run([req_cls(rid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(prompts)])
        after = _counts(mod)
        deltas.append({k: after[k] - before[k] for k in after})
    assert deltas[0] == deltas[1]
    assert deltas[0]["completed"] == 3 and deltas[0]["rejected"] == 1
    assert deltas[0]["ttft"] == 3 and deltas[0]["decode"] == 12
    reg = M.get_registry()
    assert tuple(reg.get("hvd_serve_ttft_seconds").buckets) == \
        M.LATENCY_BUCKETS
    assert reg.get("hvd_serve_queue_depth").value == 0
    assert reg.get("hvd_serve_batch_occupancy").value == 0
    assert "hvd_serve_ttft_seconds_bucket" in M.render_snapshot(
        M.metrics_snapshot())


def test_pool_gauges_track_allocator(jparams):
    _, eng = _engines(jparams, slots=2, max_seq=64, prefix_cache=True)
    prompt = np.arange(36, dtype=np.int32)                # 3 pages
    slot = eng.reserve(40, prompt=prompt)
    eng.prefill(slot, prompt)
    s2 = eng.reserve(40, prompt=prompt)                   # shares 2 pages
    reg = M.get_registry()
    g_free = reg.get("hvd_serve_pages_free")
    g_shared = reg.get("hvd_serve_pages_shared")
    assert g_free.value == eng.allocator.free_pages
    assert g_shared.value == eng.allocator.shared_pages == 2
    pool = serving_stats()["engine"]["pool"]
    assert pool["free"] == eng.allocator.free_pages
    assert pool["shared"] == 2 and 0 < pool["utilization"] <= 1
    eng.release(slot)
    eng.release(s2)
    assert g_free.value == eng.allocator.free_pages


def test_registry_and_serving_stats(jparams):
    serving.reset_for_tests()
    assert serving_stats() is None and serving.active_engine() is None
    _, eng = _engines(jparams)
    assert serving.active_engine() is eng
    assert set(serving_stats()) == {"engine"}
    sched = ServeScheduler(eng, queue_deadline=0.0, device="cpu")
    assert serving.active_scheduler() is sched
    assert serving_stats()["scheduler"]["spec"] is None
    assert serving_stats()["engine"] == eng.stats()
    serving.reset_for_tests()
    assert serving_stats() is None


# ---------------------------------------------------------------------------
# train -> serve handoff
# ---------------------------------------------------------------------------

def _train_state(cfg, seed=1):
    """A TrainState as train_loop checkpoints it: the parameter tree and
    an SGD optimizer with momentum after one step."""
    from horovod_tpu_torch import init_params
    from horovod_tpu_torch.utils import tree as tree_util
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    leaves = tree_util.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
        t.grad = torch.ones_like(t)
    opt = torch.optim.SGD(leaves, lr=0.01, momentum=0.9)
    opt.step()
    return TrainState(9, params, opt)


def test_load_for_serving_drops_optimizer_and_serves_the_same_tokens(
        tmp_path):
    cfg = ts._cfg()
    state = _train_state(cfg)
    d = str(tmp_path / "ckpt")
    with AsyncCheckpointer(d, interval=0) as ck:
        ck.save(9, state, sync=True)
    step, params = load_for_serving(d, cfg, device="cpu")
    assert step == 9
    assert set(params) == set(state.params)
    assert set(params["layers"]) == set(state.params["layers"])
    for k in ("embed", "head", "final_norm"):
        torch.testing.assert_close(params[k], state.params[k].detach(),
                                   rtol=0, atol=0)
    prompts = ts._prompts(30, 3, 5, 40)
    runs = []
    for p in (params, {k: (v.detach() if not isinstance(v, dict) else
                           {kk: vv.detach() for kk, vv in v.items()})
                       for k, v in state.params.items()}):
        eng = ServeEngine(cfg, p, device="cpu", **ts.ENGINE_KW)
        done = ServeScheduler(eng, queue_deadline=0.0, device="cpu").run(
            [Request(rid=i, prompt=x, max_new_tokens=6)
             for i, x in enumerate(prompts)])
        runs.append({r.rid: r.tokens for r in done})
    assert runs[0] == runs[1]


def test_load_for_serving_errors_name_the_fix(tmp_path):
    cfg = ts._cfg()
    with pytest.raises(FileNotFoundError, match="HOROVOD_CKPT_DIR"):
        load_for_serving(str(tmp_path / "nope"), cfg, device="cpu")
    d = str(tmp_path / "ckpt")
    with AsyncCheckpointer(d, interval=0) as ck:
        ck.save(1, {"params": {"not_a_transformer": torch.ones(3)}},
                sync=True)
    with pytest.raises(ValueError, match="different model\\?"):
        load_for_serving(d, cfg, device="cpu")
    d2 = str(tmp_path / "ckpt2")
    with AsyncCheckpointer(d2, interval=0) as ck:
        ck.save(2, _train_state(ts._cfg(d_ff=96)), sync=True)
    with pytest.raises(ValueError, match="different model geometry"):
        load_for_serving(d2, cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_for_serving(d2, cfg)


def test_handoff_messages_are_the_jax_messages():
    from horovod_tpu.analysis import rules_compat
    from horovod_tpu_torch.serving import engine
    assert engine.structure_message("a", "b") == \
        rules_compat.structure_message("a", "b")
    assert engine.geometry_message("['x']", (1, 2), (3,)) == \
        rules_compat.geometry_message("['x']", (1, 2), (3,))
    got = {"a": ((1,), "f"), "b": ((2,), "f"), "c": ((3,), "g")}
    want = {"b": ((3,), "f"), "c": ((3,), "h"), "d": ((1,), "f")}
    assert engine.tree_diff(got, want) == rules_compat.tree_diff(got, want)


def test_chunked_verify_logits_are_the_decode_logits_bitwise():
    """At ``slots * (K+1)`` rows the verify step's logits are, bit for bit,
    the sequential decode steps' logits, and every GEMM of its body runs
    in chunks of ``slots`` rows, the decode step's shape. d_ff = 2048
    makes the point on this CPU too: there an [M, 2048] x [2048, 128]
    f32 product at M = 20 is not bitwise its M = 4 rows, as the MLP's
    output product at M = 40 is not its M = 8 rows on an H100."""
    from horovod_tpu_torch import TransformerConfig, init_params
    from horovod_tpu_torch.parallel import tensor_parallel as tp_lib
    from horovod_tpu_torch.serving import engine as eng_mod
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            head_dim=32, n_layers=2, d_ff=2048, max_seq=256,
                            dp_axis=None, remat=False, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    k = 4
    off = ServeEngine(cfg, params, device="cpu", **ts.ENGINE_KW)
    spec = ServeEngine(cfg, params, device="cpu", draft="ngram:3",
                       spec_k=k, **ts.ENGINE_KW)
    rng = np.random.default_rng(0)
    toks = np.zeros((off.slots, k + 1), np.int32)
    for s in range(off.slots):
        prompt = rng.integers(1, 255, int(rng.integers(5, 40))
                              ).astype(np.int32)
        for e in (off, spec):
            slot = e.reserve(prompt.size + k + 1)
            first = e.prefill(slot, prompt)
        toks[slot] = rng.integers(1, 255, k + 1)
        toks[slot, 0] = first
    decode = []
    for i in range(k + 1):
        off.decode_step(toks[:, i])
        decode.append(off.last_logits.clone())
    rows = []
    row_parallel, column_parallel = tp_lib.row_parallel, tp_lib.column_parallel

    def spy_row(x, w, axis):
        rows.append(("row", tuple(w.shape), x.shape[0]))
        return row_parallel(x, w, axis)

    def spy_column(x, w):
        rows.append(("column", tuple(w.shape), x.shape[0]))
        return column_parallel(x, w)

    try:
        tp_lib.row_parallel, tp_lib.column_parallel = spy_row, spy_column
        spec.spec_step(toks[:, 0], toks[:, 1:])
    finally:
        tp_lib.row_parallel, tp_lib.column_parallel = (row_parallel,
                                                       column_parallel)
    assert eng_mod.tp_lib is tp_lib
    # per layer: q, k, v, o, the MLP's in and out products, each in K+1
    # chunks of `slots` rows
    assert len(rows) == 6 * (k + 1) * cfg.n_layers
    assert {m for _, _, m in rows} == {off.slots}
    assert sum(w == (cfg.d_ff, cfg.d_model) for _, w, _ in rows) == \
        (k + 1) * cfg.n_layers
    verify = spec.last_logits.reshape(off.slots, k + 1, -1)
    for i in range(k + 1):
        assert torch.equal(verify[:, i], decode[i]), i
