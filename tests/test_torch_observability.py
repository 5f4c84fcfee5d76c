"""The port's metrics registry, spans, goodput accountant, step stats and
straggler detector against the JAX package, on the CPU.

Replays the cases of ``tests/test_metrics.py``, ``tests/test_tracing.py``
and ``tests/test_goodput.py`` that this file covers (the HTTP server,
``/healthz`` and the aggregator are ``test_torch_metrics_export.py``'s;
the trace merge, profile windows, numerics and the ledger are
``test_torch_{merge,profile,numerics,ledger}.py``'s). Where both
packages take the same input, both run and their outputs must be equal:
the Prometheus text of the same registry operations, the merge of the
same snapshots, the span names and categories of the same ``train_loop``
run (checkpoint, preemption and step spans), the goodput phases that run
charges, the straggler view of the same step times.

The whole module runs under a time limit of its own (``LIMIT_S``).
"""

import collections
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from horovod_tpu import metrics as JM
from horovod_tpu.goodput import accountant as jgoodput
from horovod_tpu.parallel import trainer as jtrainer
from horovod_tpu.resilience import async_checkpoint as jac
from horovod_tpu.resilience import chaos as jchaos
from horovod_tpu.resilience import preemption as jpre
from horovod_tpu.tracing import spans as jspans
from horovod_tpu.tracing import straggler as jstraggler
import horovod_tpu_torch as htt
from horovod_tpu_torch import metrics as M
from horovod_tpu_torch import tracing as trace
from horovod_tpu_torch.callbacks import StepStats
from horovod_tpu_torch.goodput import accountant
from horovod_tpu_torch.resilience import async_checkpoint as ac
from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.resilience import preemption as pre
from horovod_tpu_torch.tracing import spans as trace_spans
from horovod_tpu_torch.tracing import straggler

LIMIT_S = 120


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
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("HOROVOD_TRACE_DIR", str(tmp_path / "trace"))
    yield
    for mod in (trace_spans, jspans):
        mod.reset()
    for mod in (accountant, jgoodput):
        mod.reset_for_tests()
    for mod in (chaos, jchaos):
        mod.install(None)
    straggler.install(None)


# ---------------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------------

def _fill(reg):
    c = reg.counter("t_requests_total", "Total requests",
                    labelnames=("op",))
    c.labels(op='all"re\\duce\n').inc(2)
    reg.gauge("t_depth", "Queue depth").set(3.5)
    reg.gauge("t_knob", "knob", labelnames=("knob",),
              aggregation="leader").labels(knob="CYCLE_TIME").set(5.0)
    h = reg.histogram("t_lat_seconds", "Latency", buckets=(0.1, 1.0))
    for v in (0.25, 0.5, 2.0):
        h.observe(v)
    reg.histogram("t_dur_seconds", "Default buckets").observe(0.003)
    return reg


def test_prometheus_text_equals_jax():
    port, jax_ = _fill(M.MetricsRegistry()), _fill(JM.MetricsRegistry())
    assert port.render() == jax_.render()
    assert port.snapshot() == jax_.snapshot()
    assert port.render().splitlines()[:3] == [
        "# HELP t_requests_total Total requests",
        "# TYPE t_requests_total counter",
        't_requests_total{op="all\\"re\\\\duce\\n"} 2']


def test_merge_snapshots_equals_jax():
    snaps = []
    for mod in (M, JM):
        regs = [_fill(mod.MetricsRegistry()), _fill(mod.MetricsRegistry())]
        regs[1].counter("t_extra_total", "e").inc(4)
        merged = mod.merge_snapshots([r.snapshot() for r in regs])
        snaps.append((merged, mod.render_snapshot(merged)))
    assert snaps[0] == snaps[1]
    merged = snaps[0][0]
    assert merged["t_knob"]["series"][0]["value"] == 5.0   # leader's
    assert merged["t_depth"]["series"][0]["value"] == 7.0  # summed
    assert merged["t_lat_seconds"]["series"][0]["count"] == 6


def test_metric_kind_and_label_validation():
    reg = M.MetricsRegistry()
    c = reg.counter("t_c_total", "c")
    assert reg.counter("t_c_total", "again") is c
    with pytest.raises(ValueError):
        reg.gauge("t_c_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    lab = reg.counter("t_lab_total", "l", labelnames=("a",))
    with pytest.raises(ValueError):
        lab.labels(b="x")
    with pytest.raises(ValueError):
        lab.inc()


def test_histogram_quantile_equals_jax():
    qs = []
    for mod in (M, JM):
        h = mod.MetricsRegistry().histogram("t_q_seconds", "q",
                                            buckets=(0.01, 0.1, 1.0))
        assert h.quantile(0.5) is None
        for v in [0.05] * 50 + [0.5] * 50:
            h.observe(v)
        qs.append([h.quantile(q) for q in (0.1, 0.5, 0.9, 0.99)])
    assert qs[0] == qs[1]


def test_runtime_totals_and_snapshot_goodput_block():
    """The totals read this process's registry, which the eager
    coordinator and handles feed (any earlier test in the process may
    have), so they are read from fresh registries: zero at first, and
    after a cycle its bytes (world x a rank's) and its handle's wait."""
    import torch
    from horovod_tpu_torch.ops.coordinator import Coordinator
    shared = M._registry
    M._registry = M.MetricsRegistry()
    try:
        assert M.runtime_totals() == {"bytes_reduced": 0.0,
                                      "collective_seconds": 0.0}
    finally:
        M._registry = shared
    assert "goodput" not in M.metrics_snapshot()
    accountant.init_begin()
    accountant.init_end()
    snap = M.metrics_snapshot()
    assert set(snap["goodput"]["phases"]) == set(accountant.PHASES)
    assert "hvd_goodput_fraction" in snap
    assert "goodput" not in M.merge_snapshots([snap])
    M._registry = M.MetricsRegistry()
    try:
        ctx = htt.init(device="cpu")
        try:
            ctx.coordinator = Coordinator(ctx, start_thread=False)
            h = htt.allreduce_async(torch.ones(3), name="totals")
            ctx.coordinator.run_cycle()
            h.wait()
        finally:
            htt.shutdown()
        totals = M.runtime_totals()
    finally:
        M._registry = shared
    assert totals["bytes_reduced"] == 12.0
    assert totals["collective_seconds"] > 0.0


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class TestSpans:
    def test_nesting_and_parent_links(self):
        trace.enable(buffer_spans=64)
        with trace.span("outer", cat="t"):
            with trace.span("inner", cat="t", attrs={"k": 1}):
                pass
        rows = trace.snapshot()
        assert [r["name"] for r in rows] == ["inner", "outer"]
        inner, outer = rows
        assert inner["parent_id"] == outer["span_id"]
        assert outer["parent_id"] == 0 and inner["attrs"] == {"k": 1}

    def test_ring_buffer_is_bounded_and_counts_dropped(self):
        trace.enable(buffer_spans=32)
        for i in range(100):
            with trace.span(f"s{i}", cat="t"):
                pass
        rows = trace.snapshot()
        assert len(rows) == 32 and rows[-1]["name"] == "s99"
        assert trace_spans.summary()["dropped"] == 100 - 32

    def test_off_path_is_the_shared_noop(self):
        assert not trace.enabled()
        s1, s2 = trace.span("a"), trace.span("b", attrs={"x": 1})
        assert s1 is s2
        with s1:
            pass
        assert trace.snapshot() == []

    def test_off_path_overhead_benchmark(self):
        n = 10_000
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("hot"):
                pass
        per_op_us = (time.perf_counter() - t0) / n * 1e6
        assert per_op_us < 5.0, f"off-path span cost {per_op_us:.2f}us"

    def test_cross_thread_async_pair(self):
        trace.enable()
        trace.begin_async("tensor_a", "queue")
        t = threading.Thread(target=lambda: trace.end_async(
            "tensor_a", "queue", attrs={"bin": 0}))
        t.start()
        t.join()
        rows = trace.snapshot()
        assert len(rows) == 1 and rows[0]["attrs"] == {"bin": 0}

    def test_chrome_export_atomic_and_loadable(self, tmp_path):
        trace.enable()
        with trace.span("op", cat="t"):
            pass
        path = str(tmp_path / "out.trace.json")
        trace.export_chrome_trace(path, process_index=3)
        data = json.loads(open(path).read())
        assert not os.path.exists(path + ".tmp")
        assert [e for e in data["traceEvents"] if e.get("ph") == "M"][0][
            "pid"] == 3
        assert data["metadata"]["trace_id"] == trace.trace_id()

    def test_init_from_env_and_at_init(self, monkeypatch):
        monkeypatch.setenv("HOROVOD_TRACE", "1")
        monkeypatch.setenv("HOROVOD_TRACE_BUFFER_SPANS", "128")
        htt.init(device="cpu")
        try:
            assert trace.enabled()
            with trace.span("x"):
                pass
            assert len(trace.snapshot()) == 1
        finally:
            htt.shutdown()

    def test_flight_recording_includes_in_flight_spans(self, tmp_path):
        trace.enable()
        assert trace.dump_flight_recording("nothing", str(tmp_path)) is None
        with trace.span("op1", cat="wait"):
            pass
        stuck = trace.span("stuck_wait", cat="wait")
        stuck.__enter__()
        try:
            p = trace.dump_flight_recording("stall", str(tmp_path))
            data = json.loads(open(p).read())
            by_name = {e["name"]: e for e in data["traceEvents"]
                       if e.get("ph") == "X"}
            assert data["metadata"]["reason"] == "stall"
            assert "op1" in by_name
            assert by_name["stuck_wait"]["args"]["in_flight"] is True
        finally:
            stuck.__exit__(None, None, None)


# ---------------------------------------------------------------------------
# one train_loop run, both packages: spans, goodput phases, step stats
# ---------------------------------------------------------------------------

def _slow_mini_step(state, batch):
    time.sleep(0.02)
    return ({"w": state["w"] + batch, "step": state["step"] + 1},
            float(batch))


def _instrumented_run(loop, ck_mod, pre_mod, chaos_mod, spans_mod,
                      goodput_mod, d):
    """A preempted train_loop run with tracing and goodput on; returns
    the (name, cat) counts of its spans, the phases it charged and its
    info dict."""
    spans_mod.enable(buffer_spans=4096)
    goodput_mod.init_begin()
    goodput_mod.init_end()
    ck = ck_mod.AsyncCheckpointer(d, interval=2, fmt="pickle")
    h = pre_mod.PreemptionHandler(checkpointer=ck, margin=0,
                                  install_signals=False)
    chaos_mod.install({"preempt_at": 4})
    try:
        _, info = loop(_slow_mini_step, {"w": np.zeros(2), "step": 0},
                       [np.float64(1.0)] * 6, checkpointer=ck, preemption=h)
    finally:
        chaos_mod.install(None)
        h.close()
        ck.close()
    counts = collections.Counter((r["name"], r["cat"])
                                 for r in spans_mod.snapshot())
    report = goodput_mod.goodput_report()
    charged = {p for p, v in report["phases"].items() if v > 0}
    return counts, charged, report, info


def test_train_loop_spans_and_goodput_phases_match_jax(tmp_path):
    port = _instrumented_run(htt.train_loop, ac, pre, chaos, trace_spans,
                             accountant, str(tmp_path / "port"))
    jax_ = _instrumented_run(jtrainer.train_loop, jac, jpre, jchaos, jspans,
                             jgoodput, str(tmp_path / "jax"))
    assert port[0] == jax_[0]
    assert port[0][("train.step", "train")] == 4
    assert port[0][("preemption.drain", "preemption")] == 1
    assert port[0][("preemption.quiesce", "preemption")] == 1
    for name in ("checkpoint.snapshot", "checkpoint.serialize",
                 "checkpoint.commit"):
        assert port[0][(name, "checkpoint")] >= 2
    assert port[1] == jax_[1]
    assert {"step_compute", "input_wait", "checkpoint", "restart",
            "idle"} <= port[1]
    report = port[2]
    assert abs(report["attributed_seconds"] - report["total_seconds"]) \
        <= 0.01 * report["total_seconds"]
    assert report["current_phase"] == "idle"
    assert port[3] == {k: v for k, v in jax_[3].items()
                       if k != "verify_step_reused"}
    flights = os.listdir(os.environ["HOROVOD_TRACE_DIR"])
    assert any(f.startswith("flight-preemption-step4") for f in flights)


def test_step_stats_feed_the_histogram_like_jax():
    from horovod_tpu.callbacks import StepStats as JStepStats
    rows = []
    for Stats, mod in ((StepStats, M), (JStepStats, JM)):
        hist = mod.histogram("hvd_step_duration_seconds",
                             "Wall time per training step")
        n0 = hist.total_count
        stats = Stats()
        assert stats.end() == {}                  # first end() begins
        time.sleep(0.01)
        row = stats.end()
        rows.append(sorted(row))
        assert row["step_time_s"] >= 0.01
        assert hist.total_count == n0 + 1
    assert rows[0] == rows[1]


# ---------------------------------------------------------------------------
# goodput accountant
# ---------------------------------------------------------------------------

class TestAccountant:
    def test_phase_catalog_is_the_jax_catalog(self):
        assert accountant.PHASES == jgoodput.PHASES
        assert accountant.GOODPUT_PHASES == jgoodput.GOODPUT_PHASES

    def test_phases_partition_total(self):
        accountant.init_begin()
        accountant.init_end()
        accountant.set_phase(accountant.STEP_COMPUTE)
        time.sleep(0.02)
        accountant.set_phase(accountant.INPUT_WAIT)
        time.sleep(0.01)
        r = accountant.goodput_report()
        assert abs(r["attributed_seconds"] - r["total_seconds"]) \
            <= 0.01 * r["total_seconds"]
        assert r["phases"]["step_compute"] >= 0.015
        assert r["current_phase"] == "input_wait"

    def test_carve_preserves_total_and_clamps(self):
        accountant.init_begin()
        accountant.init_end()
        accountant.set_phase(accountant.STEP_COMPUTE)
        time.sleep(0.02)
        moved = accountant.carve(accountant.EXPOSED_COLLECTIVE, 10.0)
        r = accountant.goodput_report()
        assert 0.0 < moved <= r["total_seconds"]
        assert r["phases"]["exposed_collective"] == pytest.approx(
            moved, abs=1e-6)

    def test_phase_scope_restores(self):
        accountant.init_begin()
        accountant.init_end()
        accountant.set_phase(accountant.STEP_COMPUTE)
        with accountant.phase_scope(accountant.CHECKPOINT):
            assert accountant.current_phase() == "checkpoint"
        assert accountant.current_phase() == "step_compute"

    def test_disabled_is_noop(self):
        assert accountant.current_phase() == "untracked"
        accountant.set_phase(accountant.IDLE)
        assert accountant.carve(accountant.COMPILE, 1.0) == 0.0
        assert accountant.health_block() is None

    def test_unknown_phase_rejected(self):
        with pytest.raises(ValueError):
            accountant.get_accountant().set_phase("nonsense")

    def test_init_drives_the_init_phase(self, monkeypatch):
        htt.init(device="cpu")
        try:
            assert accountant.enabled()
            assert accountant.current_phase() == "idle"
            assert accountant.goodput_report()["phases"]["init"] > 0
        finally:
            htt.shutdown()
        accountant.reset_for_tests()
        monkeypatch.setenv("HOROVOD_GOODPUT", "0")
        htt.init(device="cpu")
        try:
            assert accountant.current_phase() == "untracked"
        finally:
            htt.shutdown()


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------

class _DictKV:
    """A KV of the RetryingKV interface over one dict (shared by the
    simulated ranks)."""

    def __init__(self, store):
        self.store = store

    def set(self, key, value, overwrite=False):
        self.store[key] = value

    def try_get(self, key):
        return self.store.get(key)


def _views(mod, means):
    store = {}
    dets = [mod.StragglerDetector(_DictKV(store), i, len(means), window=4,
                                  publish_every=2, hostname=f"host{i}")
            for i in range(len(means))]
    for _ in range(4):
        for d, m in zip(dets, means):
            d.observe_step(m)
    return [d.publish_and_check() for d in dets]


def test_straggler_view_equals_jax():
    port = _views(straggler, [0.10, 0.15, 0.12])
    jax_ = _views(jstraggler, [0.10, 0.15, 0.12])
    assert port == jax_
    assert port[0]["slowest"] == "p1 (host1)"
    assert port[0]["skew_seconds"] == pytest.approx(0.05)
    assert port[2]["slowest"] == port[0]["slowest"]      # symmetric


def test_straggler_missing_peer_and_world_of_one():
    d0 = straggler.StragglerDetector(_DictKV({}), 0, 2, window=4,
                                     publish_every=1, hostname="hostA")
    d0.observe_step(0.1)
    snap = d0.publish_and_check()
    assert snap["skew_seconds"] == 0.0 and list(snap["means"]) == ["0"]
    assert "hvd_straggler_skew_seconds" in M.metrics_snapshot()
    assert straggler.from_env() is None                 # no peers here


def test_train_loop_feeds_an_installed_detector():
    seen = []

    class Det:
        def observe_step(self, s):
            seen.append(s)

    straggler.install(Det())
    htt.train_loop(_slow_mini_step, {"w": np.zeros(1), "step": 0},
                   [np.float64(1.0)] * 3)
    assert len(seen) == 3 and min(seen) >= 0.02
