"""The port's online tuner and bucket auto-resolution
(``horovod_tpu_torch.autotune``) against the JAX package's, on the CPU.

The GP, the acquisition and the optimizer are the same numpy arithmetic,
so their results must be bitwise equal. A ``ParameterManager`` of each
package is fed one fake clock and one byte stream (and, for the v2
score, one stream of step statistics): the overrides each applies after
every update, and its CSV log, must be equal. The bucket-auto functions
hold ``tests/test_bucket_auto.py``'s cases on both packages, the ring
model with the JAX package's link constants passed explicitly (the port
carries none); the port's measured sweep (``sweep_bucket_bytes``) is held
by its own cases.

Both registries' overrides are cleared before and after each test: the
tuner writes process-wide overrides.

The whole module runs under a time limit of its own (``LIMIT_S``).
"""

import json
import signal

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu import autotune as jautotune
from horovod_tpu.config import knobs as jknobs
from horovod_tpu_torch import autotune
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger

LIMIT_S = 120
MIB = 1 << 20
TUNABLES = sorted(n for n, k in knobs.knobs().items() if k.tunable)
# The JAX package's link constants (horovod_tpu/autotune.py:497-506), given
# to the port's model functions as arguments.
JAX_LINK = dict(ici_gbps=jautotune.ICI_RING_GBPS,
                ici_hop_s=jautotune.ICI_HOP_LATENCY_S,
                dcn_gbps=jautotune.DCN_RING_GBPS,
                dcn_hop_s=jautotune.DCN_HOP_LATENCY_S)
PACKAGES = [(autotune, knobs), (jautotune, jknobs)]


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def _clean_state():
    def clean():
        for mod, reg in PACKAGES:
            reg.clear_all_overrides()
            mod._STEP_OBSERVERS.clear()
            mod._WORLD_HISTORY.clear()
            mod._auto_miss_warned.clear()
    clean()
    yield
    clean()


# ---------------------------------------------------------------------------
# GP, acquisition, optimizer
# ---------------------------------------------------------------------------

def test_gp_fit_predict_and_ei_bitwise():
    rng = np.random.RandomState(3)
    x, y, q = rng.rand(12, 4), rng.rand(12), rng.rand(40, 4)
    got, want = autotune.GaussianProcess(), jautotune.GaussianProcess()
    for gp in (got, want):
        gp.fit(x, y)
    (mu, sd), (jmu, jsd) = got.predict(q), want.predict(q)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(sd, jsd)
    np.testing.assert_array_equal(
        autotune.expected_improvement(mu, sd, float(y.max())),
        jautotune.expected_improvement(jmu, jsd, float(y.max())))


def test_optimizer_suggestions_bitwise_over_25_observations():
    """``BayesianOptimizer.suggest`` at seed 0 (256 candidates), fed the
    same scores: every suggestion and the best point bitwise JAX's."""
    got, want = autotune.BayesianOptimizer(5), jautotune.BayesianOptimizer(5)
    rng = np.random.RandomState(0)
    for _ in range(25):
        a, b = got.suggest(), want.suggest()
        np.testing.assert_array_equal(a, b)
        y = float(np.sin(7 * a).sum() + 0.1 * rng.rand())
        got.observe(a, y)
        want.observe(b, y)
    np.testing.assert_array_equal(got.best[0], want.best[0])
    assert got.best[1] == want.best[1]


@pytest.mark.parametrize("value", ["none", "bf16", "fp16", "fp8_e4m3",
                                   "fp8_e5m2", "auto", "flat", "two_level",
                                   "bogus"])
def test_ordinal_index_matches_jax(value):
    """fp16 and fp8_e5m2 (tiers the tuner does not sample) map to their
    nearest candidate, 'auto' to two_level, as in the JAX package."""
    choices = (autotune.DCN_SCHEDULE_CANDIDATES
               if value in ("auto", "flat", "two_level")
               else autotune.COMPRESSION_TIER_CANDIDATES)
    assert autotune._ordinal_index(choices, value) == \
        jautotune._ordinal_index(choices, value)
    assert autotune.COMPRESSION_TIER_CANDIDATES == \
        jautotune.COMPRESSION_TIER_CANDIDATES
    assert autotune._ordinal_index(autotune.COMPRESSION_TIER_CANDIDATES,
                                   "fp8_e5m2") == 2
    assert autotune._ordinal_index(autotune.COMPRESSION_TIER_CANDIDATES,
                                   "fp16") == 1


# ---------------------------------------------------------------------------
# ParameterManager trajectories
# ---------------------------------------------------------------------------

def _trajectory(mod, reg, log, clock, sizes, steps, hierarchical):
    readings = iter(clock)
    mgr = mod.ParameterManager(
        clock=lambda: next(readings),
        continuous=mod.continuous_dims(hierarchical))
    out = []
    for i, nbytes in enumerate(sizes):
        if steps is not None:
            mod.feed_step_stats(*steps[i])
        changed = mgr.update(int(nbytes))
        out.append((changed, {k: reg.get(k) for k in TUNABLES}))
    mgr.close()
    with open(log) as f:
        rows = f.read()
    return out, rows, mgr.converged, mgr._samples, mgr._opt.dims


CASES = {
    "v1": ({}, False, False),
    "v2": ({}, False, True),
    "warmup": ({"HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "2"}, False, True),
    "hierarchical": ({"HOROVOD_FUSION_THRESHOLD": "local:1MB,cross:16KB"},
                     True, True),
    "compression": ({"HOROVOD_AUTOTUNE_COMPRESSION": "1",
                     "HOROVOD_GRADIENT_COMPRESSION": "fp16"}, False, False),
    "dcn": ({"HOROVOD_DCN_VIRTUAL_SLICES": "2"}, False, True),
    "compression_dcn": ({"HOROVOD_AUTOTUNE_COMPRESSION": "1",
                         "HOROVOD_DCN_VIRTUAL_SLICES": "2"}, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_bitwise_jax(case, monkeypatch, tmp_path):
    """From one fake clock and one byte stream, each package's tuner
    applies the same overrides after every update and logs the same CSV
    rows: the warmup, the v1 (dispatch throughput) and v2 (step goodput)
    scores, the cross dimension of a hierarchical mesh and the ordinal
    dimensions (the wire tier, the DCN schedule)."""
    env, hierarchical, v2 = CASES[case]
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "2")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "7")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(11)
    clock = np.cumsum(rng.rand(200) * 0.05)
    sizes = rng.randint(1, 64 * MIB, size=24)
    steps = ([(float(a), float(a * b)) for a, b in
              zip(rng.rand(24) * 0.2, rng.rand(24))] if v2 else None)
    res = []
    for mod, reg in PACKAGES:
        log = tmp_path / f"{mod.__name__}.csv"
        monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
        res.append(_trajectory(mod, reg, str(log), clock, sizes, steps,
                               hierarchical))
        reg.clear_all_overrides()
    assert res[0] == res[1]
    out, rows, converged, samples, dims = res[0]
    assert converged and samples == 7
    assert len(rows.strip().splitlines()) == 7
    assert dims == (len(autotune.continuous_dims(hierarchical))
                    + len(autotune.ordinal_dims())
                    + len(autotune._CATEGORICAL))
    assert sum(changed for changed, _ in out) == 7


def _reseed_manager(mod, reg, world):
    reg.set_override("HOROVOD_AUTOTUNE", True)
    return mod.ParameterManager(world=world)


@pytest.mark.parametrize("mod,reg", PACKAGES, ids=["port", "jax"])
def test_reseed_archives_and_restores_per_world(mod, reg):
    """tests/test_resize.py::TestAutotuneWorldReseed::test_reseed_archives_
    and_restores_per_world, on each package."""
    m = _reseed_manager(mod, reg, 8)
    m._opt.observe(m._current, 1.0)
    m._opt.observe(m._current, 2.0)
    m._samples = 2
    m.reseed_for_world(6)
    assert m._samples == 0 and not m.converged
    assert len(m._opt.xs) == 0
    m._opt.observe(m._current, 9.0)
    m._samples = 1
    m.reseed_for_world(8)
    assert m._samples == 2 and len(m._opt.xs) == 2
    m.reseed_for_world(6)
    assert m._samples == 1 and m._opt.ys == [9.0]
    m.close()


@pytest.mark.parametrize("mod,reg", PACKAGES, ids=["port", "jax"])
def test_explicit_archive_adopted_by_next_manager_for_that_world(mod, reg):
    """tests/test_resize.py's archive case: close() does not archive;
    archive_world_history() (the resize's call) is adopted by the next
    manager of that world; a disabled manager's reseed is a no-op."""
    m = _reseed_manager(mod, reg, 8)
    m._opt.observe(m._current, 4.0)
    m._samples = 1
    m.close()
    m2 = _reseed_manager(mod, reg, 8)
    assert m2._samples == 0 and m2._opt.ys == []
    m2._opt.observe(m2._current, 4.0)
    m2._samples = 1
    m2.archive_world_history()
    m2.close()
    m3 = _reseed_manager(mod, reg, 8)
    assert m3._samples == 1 and m3._opt.ys == [4.0]
    m3.close()
    reg.clear_all_overrides()
    off = mod.ParameterManager(world=5)
    assert not off.enabled and off.converged
    off.reseed_for_world(6)                  # must not raise
    assert off.converged and set(mod._WORLD_HISTORY) == {8}
    off.close()


def test_knob_registry_matches_jax():
    """The tunable set, the tuner's knobs and clear_all_overrides."""
    assert TUNABLES == sorted(n for n, k in jknobs.knobs().items()
                              if k.tunable)
    for name in ("HOROVOD_AUTOTUNE", "HOROVOD_AUTOTUNE_LOG",
                 "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
                 "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
                 "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
                 "HOROVOD_AUTOTUNE_COMPRESSION"):
        assert knobs.get(name) == jknobs.get(name), name
    knobs.set_override("HOROVOD_CYCLE_TIME", 3.0)
    knobs.clear_all_overrides()
    assert knobs.get("HOROVOD_CYCLE_TIME") == 1.0


# ---------------------------------------------------------------------------
# bucket auto: signatures, the ring model, the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tdt,jdt", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
    (torch.float16, jnp.float16), (torch.int32, jnp.int32)])
def test_grad_signature_strings_equal_jax(tdt, jdt):
    tl = [((64, 32), tdt), ((32,), tdt), ((3, 3, 8, 16), torch.float32)]
    jl = [((64, 32), jnp.dtype(jdt)), ((32,), jnp.dtype(jdt)),
          ((3, 3, 8, 16), jnp.dtype(jnp.float32))]
    for world in (1, 8):
        assert autotune.grad_signature(tl, world) == \
            jautotune.grad_signature(jl, world)
    tensors = [torch.zeros(s, dtype=d) for s, d in tl]
    assert autotune.grad_signature(tensors, 8) == \
        autotune.grad_signature(tl, 8)
    assert autotune.grad_signature(tl[::-1], 8) == \
        autotune.grad_signature(tl, 8)
    assert autotune.grad_signature(tl, 8) != autotune.grad_signature(
        [((64, 33), tdt)] + tl[1:], 8)


def _fake_rows(bucket_bytes, payload=100 * MIB, total_fusions=100):
    """tests/test_bucket_auto.py::_fake_rows."""
    n = max(1, payload // bucket_bytes)
    return [{"bytes": payload // n,
             "hideable_conv_fusions": int(min(0.8, 0.1 + 0.1 * i)
                                          * total_fusions),
             "conv_fusions_total": total_fusions} for i in range(int(n))]


@pytest.mark.parametrize("schedule", ["flat", "two_level",
                                      "two_level_compressed"])
def test_ring_model_equals_jax_given_its_constants(schedule):
    for n, slices in ((8, 1), (8, 2), (16, 4), (2, 1)):
        assert autotune.collective_seconds(
            64 * MIB, n, schedule=schedule, dcn_slices=slices,
            wire_itemsize=1, **JAX_LINK) == jautotune.collective_seconds(
            64 * MIB, n, schedule=schedule, dcn_slices=slices,
            wire_itemsize=1)
    rows = _fake_rows(8 * MIB)
    link = dict(ring_gbps=JAX_LINK["ici_gbps"],
                hop_latency_s=JAX_LINK["ici_hop_s"],
                dcn_gbps=JAX_LINK["dcn_gbps"],
                dcn_hop_latency_s=JAX_LINK["dcn_hop_s"])
    assert autotune.score_bucket_schedule(
        rows, 8, schedule=schedule, dcn_slices=2, wire_itemsize=1,
        **link) == jautotune.score_bucket_schedule(
        rows, 8, schedule=schedule, dcn_slices=2, wire_itemsize=1)
    got = autotune.score_dcn_schedules(256 * MIB, 4, 2, wire_itemsize=1,
                                       **JAX_LINK)
    want = jautotune.score_dcn_schedules(256 * MIB, 4, 2, wire_itemsize=1)
    assert got["schedules"] == want["schedules"]
    assert got["winner"] == want["winner"]


def test_ring_model_needs_the_link_terms():
    """No TPU constant stands in for a term the caller did not give."""
    with pytest.raises(ValueError, match="ici_gbps"):
        autotune.collective_seconds(MIB, 8)
    with pytest.raises(ValueError, match="dcn_gbps"):
        autotune.collective_seconds(MIB, 8, dcn_slices=2,
                                    ici_gbps=1.0, ici_hop_s=1e-6)
    assert not hasattr(autotune, "ICI_RING_GBPS")
    assert autotune.resolve_dcn_schedule(1 << 30, 4, 2) == "flat"


def test_auto_bucket_search_equals_jax():
    seen = []

    def compile_eval(bb):
        seen.append(bb)
        return _fake_rows(bb)

    got = autotune.auto_bucket_search(
        compile_eval, 8, ring_gbps=JAX_LINK["ici_gbps"],
        hop_latency_s=JAX_LINK["ici_hop_s"])
    want = jautotune.auto_bucket_search(_fake_rows, 8)
    assert seen == [m * MIB for m in autotune.BUCKET_CANDIDATES_MIB]
    assert got["candidates"] == want["candidates"]
    assert got["winner_bucket_bytes"] == want["winner_bucket_bytes"]


@pytest.fixture()
def bucket_cache(tmp_path):
    """tests/test_bucket_auto.py's fixture, on both registries."""
    path = tmp_path / "bucket_auto.json"
    for reg in (knobs, jknobs):
        reg.set_override("HOROVOD_BUCKET_AUTO_CACHE", str(path))
    yield str(path)


def _warnings(monkeypatch, name):
    got = []
    monkeypatch.setattr(get_logger(name), "warning",
                        lambda msg, *a, **k: got.append(msg % a))
    return got


def test_auto_miss_falls_back_and_warns_once(bucket_cache, monkeypatch):
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", "auto")
    warnings = _warnings(monkeypatch, "horovod_tpu_torch.autotune")
    leaves = [((10, 10), torch.float32)]
    for _ in range(2):
        assert autotune.resolve_bucket_bytes(leaves, world=8) == \
            autotune.DEFAULT_BUCKET_BYTES
    assert autotune.grad_signature(leaves, 8) in autotune._auto_miss_warned
    assert len(warnings) == 1 and "sweep_bucket_bytes" in warnings[0]
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", 7 * MIB)
    assert autotune.resolve_bucket_bytes(leaves, world=8) == 7 * MIB


def test_auto_hit_resolves_the_cached_winner_jax_wrote(bucket_cache):
    """A winner the JAX package cached for the same leaves resolves in the
    port (one key form), and another world is another key."""
    jleaves = [((64, 32), jnp.dtype(jnp.float32)),
               ((32,), jnp.dtype(jnp.float32))]
    jautotune.bucket_cache_store(jautotune.grad_signature(jleaves, 8),
                                 50 * MIB)
    leaves = [((64, 32), torch.float32), ((32,), torch.float32)]
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", "auto")
    assert autotune.resolve_bucket_bytes(leaves, world=8) == 50 * MIB
    assert autotune.resolve_bucket_bytes(leaves, world=16) == \
        autotune.DEFAULT_BUCKET_BYTES


def test_cache_store_warns_on_conflicting_overwrite(bucket_cache,
                                                    monkeypatch):
    warnings = _warnings(monkeypatch, "horovod_tpu_torch.autotune")
    autotune.bucket_cache_store("k/n8", 25 * MIB)
    autotune.bucket_cache_store("k/n8", 25 * MIB)
    assert not warnings
    autotune.bucket_cache_store("k/n8", 50 * MIB)
    assert warnings and "overwriting" in warnings[0]
    assert autotune.bucket_cache_load() == jautotune.bucket_cache_load() \
        == {"k/n8": 50 * MIB}


# ---------------------------------------------------------------------------
# the measured sweep
# ---------------------------------------------------------------------------

def _step(bucket_bytes, exposed, nccl=1e-3):
    n = max(1, (100 * MIB) // bucket_bytes)
    return {"buckets": [{"bytes": (100 * MIB) // n, "nccl_seconds": nccl,
                         "overlapped_seconds": nccl / 2}] * n,
            "exposed_collective_seconds_per_step": exposed}


def test_score_measured_steps_takes_medians_and_keeps_the_spread():
    steps = [_step(50 * MIB, e, nccl=n) for e, n in
             ((3e-3, 1e-3), (1e-3, 2e-3), (2e-3, 4e-3))]
    s = autotune.score_measured_steps(steps)
    assert s["collectives"] == 2 and s["steps"] == 3
    assert s["exposed_comm_s"] == 2e-3
    assert s["exposed_comm_s_spread"] == [1e-3, 3e-3]
    assert s["comm_s"] == 4e-3
    assert s["buckets"][0] == {"bytes": 50 * MIB, "nccl_seconds": 2e-3,
                               "overlapped_seconds": 1e-3}
    with pytest.raises(ValueError, match="bucket plans"):
        autotune.score_measured_steps([_step(50 * MIB, 0.0),
                                       _step(25 * MIB, 0.0)])


def test_sweep_measures_then_serves_warm(bucket_cache, tmp_path,
                                         monkeypatch):
    """A cold sweep measures every candidate and caches the least exposed
    (a tie goes to fewer collectives: 100 MiB over 50); the record is
    persisted in the artifact store, and a second sweep of the same
    model is served warm without measuring."""
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.store import artifact_store
    monkeypatch.setenv("HOROVOD_ARTIFACT_STORE", str(tmp_path / "store"))
    artifact_store.reset_for_tests()
    exposed = {8: 5e-3, 16: 4e-3, 25: 3e-3, 50: 1e-3, 100: 1e-3}
    measured = []

    def measure(bb):
        measured.append(bb)
        return [_step(bb, exposed[bb >> 20] + d) for d in (1e-4, 0, -1e-4)]

    leaves = [((1024, 1024), torch.bfloat16)] * 4
    try:
        cold = autotune.sweep_bucket_bytes(measure, 1, workload="w",
                                           leaves=leaves)
        assert measured == [m * MIB for m in autotune.BUCKET_CANDIDATES_MIB]
        assert cold["winner_bucket_bytes"] == 100 * MIB
        assert not cold["warm"] and cold["measured_candidates"] == 5
        sig = autotune.grad_signature(leaves, 1)
        assert autotune.bucket_cache_load() == {sig: 100 * MIB}
        assert cold["sweep"]["candidates"][str(50 * MIB)][
            "exposed_comm_s_spread"] == [1e-3 - 1e-4, 1e-3 + 1e-4]
        hits = M.get_registry().get("hvd_bucket_auto_warm_hits_total")
        before = hits.value if hits is not None else 0.0
        measured.clear()
        warm = autotune.sweep_bucket_bytes(measure, 1, workload="w",
                                           leaves=leaves)
        assert measured == [] and warm["warm"]
        assert warm["measured_candidates"] == 0
        assert warm["winner_bucket_bytes"] == 100 * MIB
        assert warm["sweep"] == json.loads(json.dumps(cold["sweep"]))
        assert M.get_registry().get(
            "hvd_bucket_auto_warm_hits_total").value == before + 1
        knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", "auto")
        assert autotune.resolve_bucket_bytes(leaves, 1) == 100 * MIB
    finally:
        artifact_store.reset_for_tests()


def test_profiled_step_row_reads_a_trace():
    """A step's row from trace events (the CPU's reading): each bucket's
    collective seconds under its label and their overlap with compute,
    and the step's exposed collective seconds."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "hvd_bucket0",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "c10d::allreduce_",
         "pid": 1, "tid": 1, "ts": 10.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "hvd_bucket1",
         "pid": 1, "tid": 1, "ts": 200.0, "dur": 40.0},
        {"ph": "X", "cat": "cpu_op", "name": "c10d::allreduce_",
         "pid": 1, "tid": 1, "ts": 210.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
         "pid": 1, "tid": 2, "ts": 30.0, "dur": 60.0},
    ]
    row = autotune.profiled_step_row(ev, [4096, 1024], device=False)
    assert row["buckets"] == [
        {"bytes": 4096, "nccl_seconds": 50e-6, "overlapped_seconds": 30e-6},
        {"bytes": 1024, "nccl_seconds": 20e-6, "overlapped_seconds": 0.0}]
    assert row["exposed_collective_seconds_per_step"] == \
        pytest.approx(40e-6)
