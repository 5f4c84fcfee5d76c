"""hvdmodel-torch (horovod_tpu_torch.analysis.model) against the JAX
package's hvdmodel, on the CPU: the protocol model checker HVD6xx.

Mirrors ``tests/test_modellint.py``: the scheduler mechanics, the port's
real-protocol builtin scenarios (must explore clean), the seeded-bug
corpus ``tests/modelcheck_torch/protocols.py`` (each caught by exactly its
HVD6xx rule, clean twins pass), counterexample replay, the CLI and the
SchedulerHooks no-op seam. Beside that:

- parity with JAX: every corpus pair gives the same codes in both
  checkers; the fixtures that reach only the harness, ``schedhooks``
  and the filesystem (no store, no checkpointer: ``HARNESS_ONLY``)
  explore alike, schedule for schedule, and a trace JAX wrote replays in
  the port to the same code and the same schedule;
- the simulated c10d store (``ModelKV``) against a real ``TCPStore``;
- faults seeded into the port's real protocol code with ``monkeypatch``,
  each caught by its code.
"""

import datetime
import json
import os
import queue
import subprocess
import sys
import threading

import pytest

from horovod_tpu_torch.analysis import model
from horovod_tpu_torch.analysis import rules_model
from horovod_tpu_torch.analysis.model import (
    Harness, Scenario, explore, replay, replay_file, resolve_scenarios,
    run_model, trace_from_json, trace_to_json,
)
from horovod_tpu_torch.utils import schedhooks

HERE = os.path.dirname(__file__)
REPO = os.path.abspath(os.path.join(HERE, ".."))
CORPUS = os.path.join(HERE, "modelcheck_torch", "protocols.py")
JAX_CORPUS = os.path.join(HERE, "data", "modellint", "protocols.py")
LIMIT_S = 120           # per test: the deep -m slow runs take 45 s each

BAD = [("bad_stop_step", "HVD601"),
       ("bad_rotation", "HVD602"),
       ("bad_dropped_ack", "HVD602"),
       ("bad_lock_order", "HVD603"),
       ("bad_unlocked_drain", "HVD604"),
       ("bad_resume_offbyone", "HVD605"),
       ("bad_resize_plan_order", "HVD602"),
       ("bad_fleet_drain_drop", "HVD604")]
CLEAN = ["clean_stop_step", "clean_rotation", "clean_dropped_ack",
         "clean_lock_order", "clean_locked_drain", "clean_resume",
         "clean_resize_plan_order", "clean_fleet_drain"]
# The fixtures that touch no store and no checkpointer: only the harness,
# the schedhooks primitives, the commit rename and plain files (the
# rotation and plan fixtures read directory names through the port's
# ``list_committed_steps``/``step_dirname`` and ``commit_plan``/
# ``load_plan``, which yield nowhere). Their schedules are the same
# transitions in both checkers.
HARNESS_ONLY = ["bad_rotation", "clean_rotation", "bad_lock_order",
                "clean_lock_order", "bad_unlocked_drain",
                "clean_locked_drain", "bad_resume_offbyone", "clean_resume",
                "bad_resize_plan_order", "clean_resize_plan_order",
                "bad_fleet_drain_drop", "clean_fleet_drain"]


@pytest.fixture(autouse=True)
def _limit():
    import signal

    def expired(*_):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")
    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def one_scenario(spec):
    [(_, sc)] = resolve_scenarios(spec)
    return sc


def jax_model():
    from horovod_tpu.analysis import model as jm
    return jm


def jax_scenario(name):
    [(_, sc)] = jax_model().resolve_scenarios(f"{JAX_CORPUS}:{name}")
    return sc


class _RunClock:
    """A ``time`` stand-in for ``explore``'s budget: each reading is one
    tick later, so a budget of N seconds is N runs, the same in both
    checkers whatever the machine's speed."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 1.0
        return self.t


# ---------------------------------------------------------------------------
# seeded-bug corpus
# ---------------------------------------------------------------------------

class TestCorpus:
    @pytest.mark.parametrize("name,code", BAD)
    def test_each_bad_fixture_caught_by_exactly_its_rule(self, name, code):
        sc = one_scenario(f"{CORPUS}:{name}")
        # the fixture's own codes= declaration is the checked contract
        assert sc.codes == (code,), (
            f"{name} declares codes={sc.codes}, test expects ({code},)")
        res = explore(sc, budget_s=30.0)
        assert [f.code for f in res.findings] == [code], (
            f"{name}: {[(f.code, f.message) for f in res.findings]}")
        # the counterexample is a concrete, replayable schedule
        assert res.findings[0].trace

    @pytest.mark.parametrize("name", CLEAN)
    def test_clean_twins_explore_clean(self, name):
        res = explore(one_scenario(f"{CORPUS}:{name}"), budget_s=2.0)
        assert res.findings == [], (
            f"{name}: {[(f.code, f.message) for f in res.findings]}")

    def test_small_corpus_fixtures_exhaust_their_state_space(self):
        # the distilled protocols are small enough for FULL coverage:
        # "caught" above means caught exhaustively, not by luck
        for name in ("bad_stop_step", "bad_lock_order", "clean_stop_step",
                     "clean_lock_order", "bad_resize_plan_order",
                     "clean_resize_plan_order"):
            res = explore(one_scenario(f"{CORPUS}:{name}"), budget_s=30.0)
            assert res.exhausted, name

    def test_crash_knob_gates_crash_injection(self):
        from horovod_tpu_torch.config import knobs
        knobs.set_override("HOROVOD_MODEL_MAX_CRASHES", 0)
        try:
            res = explore(one_scenario(f"{CORPUS}:bad_resume_offbyone"),
                          budget_s=10.0)
        finally:
            knobs.clear_override("HOROVOD_MODEL_MAX_CRASHES")
        # the off-by-one only diverges across a crash+restore; with
        # crash injection off the schedule space is bug-free
        assert res.findings == []


# ---------------------------------------------------------------------------
# parity with the JAX checker
# ---------------------------------------------------------------------------

class TestParityWithJax:
    @pytest.mark.parametrize("bad,code", BAD)
    def test_corpus_pair_gives_jax_codes(self, bad, code):
        clean = CLEAN[[b for b, _ in BAD].index(bad)]
        for name, budget, codes in ((bad, 30.0, [code]), (clean, 1.0, [])):
            want = [f.code for f in jax_model().explore(
                jax_scenario(name), budget_s=budget).findings]
            got = [f.code for f in explore(
                one_scenario(f"{CORPUS}:{name}"), budget_s=budget).findings]
            assert got == want == codes, name

    @pytest.mark.parametrize("name", HARNESS_ONLY)
    def test_harness_only_fixture_explores_alike(self, name, monkeypatch):
        jm = jax_model()
        monkeypatch.setattr(jm, "time", _RunClock())
        monkeypatch.setattr(model, "time", _RunClock())
        want = jm.explore(jax_scenario(name), budget_s=120.0, seed=0)
        got = explore(one_scenario(f"{CORPUS}:{name}"), budget_s=120.0,
                      seed=0)
        for attr in ("runs", "transitions", "exhausted", "pruned",
                     "depth_truncated"):
            assert getattr(got, attr) == getattr(want, attr), (name, attr)
        assert [f.code for f in got.findings] == \
            [f.code for f in want.findings]
        assert [f.trace for f in got.findings] == \
            [f.trace for f in want.findings]

    @pytest.mark.parametrize("name", [n for n in HARNESS_ONLY
                                      if n.startswith("bad_")])
    def test_jax_trace_replays_in_the_port(self, name, tmp_path):
        _, traces = jax_model().run_model([f"{JAX_CORPUS}:{name}"],
                                          budget_s=30.0,
                                          trace_dir=str(tmp_path))
        [(key, path)] = traces.items()
        code = key.split(":")[1]
        with open(path) as f:
            spec, trace = trace_from_json(f.read())
        assert spec.endswith(f"protocols.py:{name}")
        out = replay(one_scenario(f"{CORPUS}:{name}"), trace)
        assert out.violation is not None and out.violation.code == code
        assert out.chosen == trace
        assert out.chosen == jax_model().replay_file(path).chosen

    def test_builtin_scenarios_have_jax_names_and_codes(self):
        want = jax_model().builtin_scenarios()
        got = model.builtin_scenarios()
        assert list(got) == list(want)
        for name, sc in got.items():
            j = want[name]
            assert (sc.codes, sc.max_crashes, sc.max_losses, sc.knobs) == \
                (j.codes, j.max_crashes, j.max_losses, j.knobs), name

    def test_rule_catalog_is_jax_word_for_word(self):
        from horovod_tpu.analysis import rules_model as jrules
        assert [(r.code, r.severity, r.summary) for r in rules_model.RULES] \
            == [(r.code, r.severity, r.summary) for r in jrules.RULES]


# ---------------------------------------------------------------------------
# the simulated c10d store against a real one
# ---------------------------------------------------------------------------

def _store_ops(store):
    """One sequence of every call ``DistributedKV`` makes, each call's
    value or its exception's class."""
    def do(fn):
        try:
            return fn()
        except Exception as e:       # noqa: BLE001 - the class is the answer
            return type(e)
    short = datetime.timedelta(seconds=0.2)
    out = [
        do(lambda: store.set("a", "1")),
        do(lambda: store.compare_set("a", "", "2")),        # present
        do(lambda: store.compare_set("a", "1", "3")),       # swaps
        do(lambda: store.compare_set("b", "", "x")),        # missing: writes
        do(lambda: store.compare_set("c", "zz", "y")),      # missing: no
        do(lambda: store.get("a")),
        do(lambda: store.check(["a"])),
        do(lambda: store.check(["a", "c"])),
        do(lambda: store.wait(["a"], short)),
        do(lambda: store.wait(["nope"], short)),
        do(lambda: store.delete_key("a")),
        do(lambda: store.delete_key("a")),
        do(lambda: store.check(["a"])),
    ]
    clone = store.clone()
    out += [do(lambda: clone.get("b")),
            do(lambda: clone.set("d", b"\x00\xff")),
            do(lambda: store.get("d")),
            do(lambda: store.get("nope"))]
    return out


class TestModelStore:
    def test_model_store_answers_as_a_tcp_store(self):
        import torch.distributed as dist
        real = dist.TCPStore("127.0.0.1", 0, 1, True,
                             timeout=datetime.timedelta(seconds=0.5),
                             wait_for_workers=False)
        want = _store_ops(real)
        got = {}

        def fn(h):
            p = h.process("p0")
            h.spawn(p, lambda: got.setdefault("ops", _store_ops(h.kv)), "t")
            h.go()

        out = replay(Scenario("store", fn), [])
        assert out.violation is None
        assert got["ops"] == want
        assert dist.DistStoreError in want and bytes in {type(v)
                                                         for v in want}

    def test_lost_store_call_is_a_network_error(self):
        import torch.distributed as dist
        seen = []

        def fn(h):
            p = h.process("p0")

            def t():
                try:
                    h.kv.set("k", "v")
                    seen.append("ok")
                except dist.DistNetworkError:
                    seen.append("lost")
            h.spawn(p, t, "t")
            h.go()

        res = explore(Scenario("loss", fn, max_losses=1), budget_s=5.0)
        assert res.exhausted and sorted(set(seen)) == ["lost", "ok"]

    def test_distributed_kv_rides_the_model_store(self):
        """Inside a run, ``distributed_kv`` wraps the simulated store in
        the port's real stack: write-once through ``compare_set``, a
        blocking get through ``wait`` then ``get``, its timeout a
        ``KVDeadlineExceeded``, and a ``clone`` for an own connection."""
        from horovod_tpu_torch.utils.kvstore import KVDeadlineExceeded
        seen = {}

        def fn(h):
            from horovod_tpu_torch.utils.kvstore import distributed_kv
            p = h.process("p0", pidx=0, nproc=2)

            def t():
                kv = distributed_kv(site="preemption")
                own = distributed_kv(site="preemption",
                                     own_connection=True)
                kv.set("k", "v")
                seen["own"] = own.get("k", 1.0)
                seen["ops"] = [c[1] for c, _ in h.controller.decisions]
                try:
                    kv.get("missing", 1.0)
                except KVDeadlineExceeded:
                    seen["timeout"] = True

            h.spawn(p, t, "t")
            h.go()

        out = replay(Scenario("stack", fn), [])
        assert out.violation is None
        assert seen["own"] == "v" and seen["timeout"]
        assert seen["ops"] == ["start", "kv_compare_set", "kv_wait",
                               "kv_get"]


# ---------------------------------------------------------------------------
# faults seeded into the port's real code
# ---------------------------------------------------------------------------

def _two_notices(h: Harness) -> None:
    """Both controllers get an eviction notice, at different steps, and
    run the port's real PreemptionHandler in lockstep: whoever publishes
    first must be the stop step of both."""
    stops = {}
    barrier = model._StepBarrier(2)
    procs = [h.process(f"ctl{r}", pidx=r, nproc=2) for r in range(2)]

    def ctl(r):
        def loop():
            from horovod_tpu_torch.resilience.preemption import (
                PreemptionHandler,
            )
            handler = PreemptionHandler(checkpointer=None, sentinel="",
                                        margin=2, install_signals=False)
            try:
                for step in range(6):
                    if step == 1 - r:
                        handler.request("maintenance notice")
                    if handler.check(step):
                        stops[r] = step
                        barrier.leave()
                        return
                    barrier.wait()
                stops[r] = None
            finally:
                handler.close()
        return loop

    for r, p in enumerate(procs):
        with h.on(p):
            h.spawn(p, ctl(r), "train")
    h.go()
    if len(set(stops.values())) > 1:
        h.violation("HVD601", f"controllers quiesced at different steps "
                              f"({stops})")


class TestSeededFaults:
    def test_shutdown_without_its_final_flush_is_hvd604(self, monkeypatch):
        from horovod_tpu_torch.ops.coordinator import Coordinator
        sc = model.builtin_scenarios()["coordinator"]
        assert explore(sc, budget_s=1.0).findings == []

        def shutdown(self):
            # the seeded fault: stop without flushing the queue
            self._shutdown.set()
            self._wake.set()
            self.buffers.clear()
            self.autotune.close()

        monkeypatch.setattr(Coordinator, "shutdown", shutdown)
        res = explore(sc, budget_s=3.0)
        assert [f.code for f in res.findings] == ["HVD604"]

    def test_rotation_before_the_commit_is_hvd602(self, monkeypatch):
        import shutil

        from horovod_tpu_torch.resilience import async_checkpoint as ac
        sc = model.builtin_scenarios()["checkpoint"]
        write_and_commit = ac.AsyncCheckpointer._write_and_commit

        def rotate_first(self, item):
            # the seeded fault: make room for the new snapshot before it
            # is committed
            steps = ac.list_committed_steps(self.directory)
            for s in steps[:len(steps) - self.max_to_keep + 1]:
                shutil.rmtree(os.path.join(self.directory,
                                           ac.step_dirname(s)))
            return write_and_commit(self, item)

        monkeypatch.setattr(ac.AsyncCheckpointer, "_write_and_commit",
                            rotate_first)
        res = explore(sc, budget_s=3.0)
        assert [f.code for f in res.findings] == ["HVD602"]

    def test_overwriting_stop_step_is_hvd601(self, monkeypatch):
        from horovod_tpu_torch.utils import kvstore
        sc = Scenario("two_notices", _two_notices,
                      knobs={"HOROVOD_PREEMPTION_POLL_SECONDS": 0.0})
        clean = explore(sc, budget_s=2.0)
        assert clean.findings == [] and clean.runs > 1
        set_ = kvstore.DistributedKV.set

        def overwriting(self, key, value, overwrite=False):
            # the seeded fault: the stop step overwrites a peer's
            return set_(self, key, value, overwrite=overwrite
                        or key.startswith("hvd_preempt/"))

        monkeypatch.setattr(kvstore.DistributedKV, "set", overwriting)
        res = explore(sc, budget_s=3.0)
        assert [f.code for f in res.findings] == ["HVD601"]


# ---------------------------------------------------------------------------
# real protocols: zero findings
# ---------------------------------------------------------------------------

class TestBuiltinScenarios:
    @pytest.mark.parametrize("name", sorted(model.builtin_scenarios()))
    def test_real_protocol_explores_clean(self, name):
        # tier-1 keeps this a 1 s smoke per protocol: the -m slow tier
        # below carries the big-budget exploration
        sc = model.builtin_scenarios()[name]
        res = explore(sc, budget_s=1.0)
        assert res.findings == [], (
            f"{name}: {[(f.code, f.message) for f in res.findings]}")
        assert res.runs >= 1 and res.transitions > 0

    @pytest.mark.slow
    @pytest.mark.parametrize("name", sorted(model.builtin_scenarios()))
    def test_deep_budget_exploration_stays_clean(self, name):
        sc = model.builtin_scenarios()[name]
        res = explore(sc, budget_s=45.0)
        assert res.findings == [], (
            f"{name}: {[(f.code, f.message) for f in res.findings]}")


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

class TestReplay:
    def test_every_counterexample_replays_deterministically(self, tmp_path):
        results, traces = run_model([f"{CORPUS}:all_bad"], budget_s=30.0,
                                    trace_dir=str(tmp_path))
        assert sorted(k.split(":")[1] for k in traces) == sorted(
            code for _, code in BAD)
        for key, path in sorted(traces.items()):
            first = replay_file(path)
            second = replay_file(path)
            assert first.violation is not None, key
            assert first.violation.code == key.split(":")[1]
            # bitwise-identical schedule both times
            assert first.chosen == second.chosen

    def test_trace_json_round_trip(self):
        mf = model.ModelFinding(
            "HVD601", "msg", "s", [("p.t", "op", "res", "do")])
        spec, trace = trace_from_json(trace_to_json("spec", mf))
        assert spec == "spec" and trace == [("p.t", "op", "res", "do")]
        assert trace_to_json("spec", mf) == \
            jax_model().trace_to_json("spec", mf)

    def test_replay_rejects_garbage(self, tmp_path):
        p = tmp_path / "t.json"
        p.write_text(json.dumps({"nope": 1}))
        with pytest.raises(ValueError):
            replay_file(str(p))

    def test_fixed_protocol_no_longer_reproduces(self):
        # a trace recorded against the BAD protocol, replayed against
        # the CLEAN twin, must either diverge or come back clean, never
        # fabricate a violation
        res = explore(one_scenario(f"{CORPUS}:bad_lock_order"),
                      budget_s=30.0)
        trace = res.findings[0].trace
        clean = one_scenario(f"{CORPUS}:clean_lock_order")
        try:
            out = replay(clean, trace)
            assert out.violation is None
        except model.ReplayDivergence:
            pass


# ---------------------------------------------------------------------------
# findings pipeline (rules_model -> engine.Finding)
# ---------------------------------------------------------------------------

class TestFindings:
    def test_findings_anchor_to_scenario_def_and_name_the_trace(self):
        results, _ = run_model([f"{CORPUS}:bad_stop_step"], budget_s=10.0)
        findings = rules_model.to_findings(results)
        assert len(findings) == 1
        f = findings[0]
        assert f.code == "HVD601" and f.severity == "error"
        assert f.path.endswith("tests/modelcheck_torch/protocols.py")
        assert "bad_stop_step-HVD601.json" in f.message
        assert "--replay" in f.message
        # fingerprints must be machine- and flag-independent: no tmp
        # paths and no --trace-dir value in the message
        assert "/tmp" not in f.message

    def test_rule_catalog_covers_601_to_605(self):
        assert sorted(rules_model.RULES_BY_CODE) == [
            "HVD601", "HVD602", "HVD603", "HVD604", "HVD605"]

    def test_suppression_on_the_scenario_def_drops_the_finding(
            self, tmp_path):
        src = tmp_path / "supp.py"
        src.write_text(
            "from horovod_tpu_torch.analysis.model import Scenario\n"
            "\n"
            "def fn(h):  # hvdlint: disable=HVD601 a known fault\n"
            "    h.violation('HVD601', 'always')\n"
            "\n"
            "def target():\n"
            "    return Scenario('supp', fn)\n")
        results, _ = run_model([f"{src}:target"], budget_s=5.0)
        assert [f.code for f in results[0].findings] == ["HVD601"]
        assert rules_model.to_findings(results) == []


# ---------------------------------------------------------------------------
# scheduler mechanics
# ---------------------------------------------------------------------------

class TestMechanics:
    def test_deadlock_detection_names_the_blocked_threads(self):
        def fn(h: Harness):
            evt = schedhooks.Event()
            p = h.process("p0")
            h.spawn(p, lambda: evt.wait(), "waiter")   # nobody ever sets
            h.go()

        res = explore(Scenario("dl", fn), budget_s=5.0)
        assert [f.code for f in res.findings] == ["HVD603"]
        assert "waiter" in res.findings[0].message

    def test_unhandled_thread_exception_is_a_finding(self):
        def fn(h: Harness):
            p = h.process("p0")

            def boom():
                schedhooks.sleep(0)
                raise RuntimeError("kaput")

            h.spawn(p, boom, "t")
            h.go()

        res = explore(Scenario("boom", fn), budget_s=5.0)
        assert [f.code for f in res.findings] == ["HVD603"]
        assert "kaput" in res.findings[0].message

    def test_message_loss_respects_budget(self):
        """Loss budget mechanics, seen through the production stack:
        distributed_kv() interposes RetryingKV, so observing a RAW loss
        needs a no-retry policy; with a retrying policy a single lost
        message is ABSORBED by a retry (the retry layer must not change
        what the consumer sees beyond latency)."""
        from horovod_tpu_torch.resilience import faults
        seen = []

        def make_fn(site):
            def fn(h: Harness):
                from horovod_tpu_torch.utils.kvstore import distributed_kv
                p = h.process("p0")

                def send():
                    kv = distributed_kv(site=site)
                    try:
                        kv.set("k", "v")
                        seen.append("ok")
                    except Exception:
                        seen.append("lost")

                h.spawn(p, send, "t")
                h.go()
            return fn

        try:
            faults.register_policy(faults.RetryPolicy(
                site="no_retry", deadline_s=1.0, max_attempts=1,
                base_backoff_s=0.0, critical=True))
            fn = make_fn("no_retry")
            res = explore(Scenario("nl", fn, max_losses=0), budget_s=5.0)
            assert res.exhausted and "lost" not in seen
            seen.clear()
            res = explore(Scenario("wl", fn, max_losses=1), budget_s=5.0)
            assert res.exhausted and "lost" in seen
            faults.register_policy(faults.RetryPolicy(
                site="with_retry", deadline_s=30.0, max_attempts=3,
                base_backoff_s=0.0, critical=True))
            seen.clear()
            res = explore(Scenario("wr", make_fn("with_retry"),
                                   max_losses=1), budget_s=5.0)
            assert res.exhausted and set(seen) == {"ok"}
        finally:
            faults.reset_for_tests()

    def test_violating_schedules_still_branch_to_other_codes(self):
        """A run that ends in a Violation must not drop its unexplored
        branch alternatives: a second rule's counterexample can live in
        the sibling subtree."""
        def fn(h: Harness):
            order = []
            p = h.process("p0")

            def t(tag):
                def run():
                    schedhooks.sleep(0)
                    order.append(tag)
                return run

            h.spawn(p, t("a"), "ta")
            h.spawn(p, t("b"), "tb")
            h.go()
            if order == ["a", "b"]:
                h.violation("HVD601", "order a,b")
            h.violation("HVD602", "order b,a")

        res = explore(Scenario("two", fn), budget_s=10.0)
        assert sorted(f.code for f in res.findings) == ["HVD601",
                                                        "HVD602"]

    def test_dependent_interleavings_are_fully_enumerated(self):
        """Same-process (dependent) threads must see ALL C(4,2)=6
        interleavings of two 2-op threads, and 'exhausted' must mean
        exactly that."""
        seen = set()

        def fn(h: Harness):
            order = []
            p = h.process("p0")

            def t(tag):
                def run():
                    schedhooks.sleep(0)
                    order.append(tag)
                    schedhooks.sleep(0)
                    order.append(tag)
                return run

            h.spawn(p, t("a"), "ta")
            h.spawn(p, t("b"), "tb")
            h.go()
            seen.add(tuple(order))

        res = explore(Scenario("interleave", fn), budget_s=20.0)
        assert res.exhausted
        assert len(seen) == 6, sorted(seen)

    def test_depth_truncation_forfeits_exhaustion(self):
        """Runs cut at the max_steps bound leave an unchecked suffix, so
        the emptied-frontier result must NOT claim exhaustion."""
        def fn(h: Harness):
            order = []
            p = h.process("p0")

            def t(tag):
                def run():
                    for _ in range(3):
                        schedhooks.sleep(0)
                        order.append(tag)
                return run

            h.spawn(p, t("a"), "ta")
            h.spawn(p, t("b"), "tb")
            h.go()
            if order == ["b", "b", "b", "a", "a", "a"]:
                h.violation("HVD601", "only the deepest schedule fails")

        deep = explore(Scenario("deep", fn), budget_s=20.0)
        assert deep.exhausted and deep.depth_truncated == 0
        assert [f.code for f in deep.findings] == ["HVD601"]
        cut = explore(Scenario("deep", fn), budget_s=20.0, max_steps=4)
        assert cut.findings == []
        assert cut.depth_truncated > 0
        assert not cut.exhausted

    def test_kv_write_once_semantics(self):
        outcome = {}

        def fn(h: Harness):
            from horovod_tpu_torch.utils.kvstore import distributed_kv
            p = h.process("p0")

            def t():
                kv = distributed_kv()
                kv.set("a", "1")
                try:
                    kv.set("a", "2")
                    outcome["second"] = "accepted"
                except Exception:
                    outcome["second"] = "rejected"
                kv.set("a", "3", overwrite=True)
                outcome["final"] = kv.try_get("a")
                outcome["missing"] = kv.try_get("nope")

            h.spawn(p, t, "t")
            h.go()

        res = explore(Scenario("kv", fn), budget_s=5.0)
        assert res.findings == []
        assert outcome == {"second": "rejected", "final": "3",
                           "missing": None}

    def test_each_schedule_plays_fresh_processes(self):
        """The port's per-process protocol counters (the preemption
        handlers' stop-key sequence) start afresh in every explored
        schedule and are the host process's own again afterwards."""
        from horovod_tpu_torch.resilience import preemption
        keys = set()

        def fn(h: Harness):
            p = h.process("p0", pidx=1, nproc=2)

            def t():
                schedhooks.sleep(0)
                handler = preemption.PreemptionHandler(
                    checkpointer=None, sentinel="", install_signals=False)
                keys.add(handler._stop_key)
                handler.close()

            h.spawn(p, t, "t")
            h.spawn(p, lambda: schedhooks.sleep(0), "u")
            h.go()

        before = dict(preemption._handler_seqs)
        res = explore(Scenario("fresh", fn), budget_s=5.0)
        assert res.exhausted and res.runs > 1
        assert keys == {"hvd_preempt/stop_step/0"}
        assert preemption._handler_seqs == before


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------

class TestCli:
    def test_model_flag_exit_codes_and_replay(self, tmp_path, capsys):
        from horovod_tpu_torch.analysis.__main__ import main
        trace_dir = str(tmp_path / "traces")
        rc = main(["--model", f"{CORPUS}:bad_stop_step",
                   "--model-budget", "10", "--trace-dir", trace_dir,
                   "--no-baseline"])
        assert rc == 1
        out = capsys.readouterr().out
        assert "HVD601" in out
        trace = os.path.join(trace_dir, "bad_stop_step-HVD601.json")
        assert os.path.exists(trace)
        rc = main(["--replay", trace])
        assert rc == 1                       # reproduced
        assert "reproduced HVD601" in capsys.readouterr().out

    def test_model_flag_clean_scenario_exits_zero(self, tmp_path):
        from horovod_tpu_torch.analysis.__main__ import main
        rc = main(["--model", f"{CORPUS}:clean_stop_step",
                   "--model-budget", "5",
                   "--trace-dir", str(tmp_path), "--no-baseline"])
        assert rc == 0

    def test_hvdmodel_alias_translates_positionals(self, tmp_path):
        from horovod_tpu_torch.analysis.__main__ import model_main
        rc = model_main([f"{CORPUS}:clean_lock_order", "--model-budget",
                         "5", "--trace-dir", str(tmp_path),
                         "--no-baseline"])
        assert rc == 0

    def test_default_trace_dir_is_the_ported_one(self):
        from horovod_tpu_torch.analysis.__main__ import build_parser
        args = build_parser().parse_args(["--model", "all"])
        assert args.trace_dir == ".hvdmodel-torch"

    def test_unknown_scenario_is_a_usage_error(self):
        from horovod_tpu_torch.analysis.__main__ import main
        rc = main(["--model", "no_such_scenario", "--no-baseline"])
        assert rc == 2

    def test_select_narrows_model_findings_without_aborting(self, tmp_path):
        """--select HVD6xx with --model (and no paths) must run the
        checker, not die with 'matches no rules'."""
        from horovod_tpu_torch.analysis.__main__ import main
        rc = main(["--model", f"{CORPUS}:bad_stop_step", "--select",
                   "HVD605", "--model-budget", "5",
                   "--trace-dir", str(tmp_path), "--no-baseline"])
        assert rc == 0          # HVD601 found but filtered out
        rc = main(["--model", f"{CORPUS}:bad_stop_step", "--select",
                   "HVD601", "--model-budget", "5",
                   "--trace-dir", str(tmp_path), "--no-baseline"])
        assert rc == 1

    def test_checker_crash_exits_two_not_one(self, monkeypatch):
        """A gate that wants 'the corpus fails with exit exactly 1'
        relies on a checker CRASH exiting 2."""
        from horovod_tpu_torch.analysis import __main__ as cli
        monkeypatch.setattr(
            "horovod_tpu_torch.analysis.model.run_model",
            lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("boom")))
        rc = cli.main(["--model", "coordinator", "--no-baseline"])
        assert rc == 2

    def test_replay_crash_exits_two_not_one(self, tmp_path, capsys):
        """Same contract on the --replay path: a broken replay
        (unresolvable spec, renamed fixture callable) is not a
        reproduced violation."""
        from horovod_tpu_torch.analysis.__main__ import main
        trace = tmp_path / "bogus-HVD601.json"
        trace.write_text(json.dumps({
            "hvdmodel_trace": 1,
            "scenario": f"{CORPUS}:no_such_callable_anymore",
            "trace": ["p0.t|kv_set|kv:x|do"]}))
        rc = main(["--replay", str(trace)])
        capsys.readouterr()
        assert rc == 2

    def test_list_rules_includes_hvd6xx(self, capsys):
        from horovod_tpu_torch.analysis.__main__ import main
        assert main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for code in ("HVD601", "HVD602", "HVD603", "HVD604", "HVD605"):
            assert code in out

    def test_module_cli_checks_all_builtins_clean(self, tmp_path):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        out = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.analysis", "--model",
             "all", "--model-budget", "4.5", "--trace-dir", str(tmp_path),
             "--no-baseline"],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stderr.count("0 finding(s)") == 9
        assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# hvdfault x hvdmodel: the retry layer inside the model world
# ---------------------------------------------------------------------------

class TestKVBrownoutScenario:
    def test_kv_brownout_is_a_builtin_with_declared_codes(self):
        sc = model.builtin_scenarios()["kv_brownout"]
        assert sc.max_losses >= 2
        assert set(sc.codes) == {"HVD601", "HVD602", "HVD603"}

    def test_model_world_interposes_production_retrying_kv(self):
        """Inside a model run, distributed_kv() returns the REAL
        RetryingKV over the simulated store: kv_brownout checks the
        production retry layer, not a parallel model."""
        from horovod_tpu_torch.resilience import faults
        seen = {}

        def fn(h):
            from horovod_tpu_torch.utils.kvstore import distributed_kv
            p = h.process("p0")

            def probe():
                kv = distributed_kv(site="preemption")
                seen["type"] = type(kv).__name__
                seen["site"] = kv.site
                seen["inner"] = type(kv.inner.store).__name__
                kv.set("k", "v")
                seen["value"] = kv.get("k", 1.0)

            h.spawn(p, probe, "t")
            h.go()

        res = explore(Scenario("seam", fn), budget_s=5.0)
        assert res.findings == []
        assert seen == {"type": "RetryingKV", "site": "preemption",
                        "inner": "ModelKV", "value": "v"}
        assert faults.policy_for("preemption").critical


# ---------------------------------------------------------------------------
# SchedulerHooks seam: no-op in production
# ---------------------------------------------------------------------------

class TestNoOpSeam:
    def test_default_hooks_hand_out_real_stdlib_primitives(self):
        assert type(schedhooks.hooks()) is schedhooks.SchedulerHooks
        assert isinstance(schedhooks.Lock(), type(threading.Lock()))
        assert isinstance(schedhooks.RLock(), type(threading.RLock()))
        assert isinstance(schedhooks.Event(), threading.Event)
        assert isinstance(schedhooks.Condition(), threading.Condition)
        assert isinstance(schedhooks.Queue(), queue.Queue)
        t = schedhooks.Thread(target=lambda: None, name="x")
        assert isinstance(t, threading.Thread) and t.daemon

    def test_default_rename_is_os_rename(self, tmp_path):
        src, dst = tmp_path / "a", tmp_path / "b"
        src.write_text("x")
        schedhooks.rename(str(src), str(dst))
        assert dst.read_text() == "x" and not src.exists()

    def test_install_swaps_and_restores(self):
        class Marker(schedhooks.SchedulerHooks):
            pass

        m = Marker()
        prev = schedhooks.install(m)
        try:
            assert schedhooks.hooks() is m
        finally:
            schedhooks.install(prev)
        assert type(schedhooks.hooks()) is schedhooks.SchedulerHooks

    def test_unshimmed_checkpointer_e2e_uses_real_threads(self, tmp_path):
        """The seam must not change production behavior: a plain
        AsyncCheckpointer round-trip runs on real threading/queue
        primitives and commits durably."""
        from horovod_tpu_torch.resilience.async_checkpoint import (
            AsyncCheckpointer, restore_latest,
        )
        ckpt = AsyncCheckpointer(str(tmp_path), interval=1, max_to_keep=2,
                                 fmt="pickle")
        try:
            assert isinstance(ckpt._queue, queue.Queue)
            assert isinstance(ckpt._worker, threading.Thread)
            assert isinstance(ckpt._idle, threading.Event)
            ckpt.save(1, {"w": 1.25})
            ckpt.wait()
        finally:
            ckpt.close()
        step, tree = restore_latest(str(tmp_path))
        assert step == 1 and tree["w"] == 1.25

    def test_unshimmed_coordinator_uses_stdlib_primitives(self):
        """The retrofitted coordinator: with the default hooks its
        queue's, cache's and cycle's locks, its events and its cycle
        thread are the stdlib's, and it dispatches as before."""
        import torch

        from horovod_tpu_torch.ops.coordinator import (
            Coordinator, Entry, TensorQueue,
        )
        lock_t = type(threading.Lock())
        assert isinstance(TensorQueue()._lock, lock_t)
        coord = Coordinator(model._StubCtx(), start_thread=True)
        try:
            assert isinstance(coord.queue._lock, lock_t)
            assert isinstance(coord.cache._lock, lock_t)
            assert isinstance(coord._cycle_lock, lock_t)
            assert isinstance(coord._shutdown, threading.Event)
            assert isinstance(coord._wake, threading.Event)
            assert type(coord._thread) is threading.Thread
            assert coord._thread.is_alive()
        finally:
            coord.shutdown()
        assert not coord._thread.is_alive()

        resolved = []

        class Quiet(Coordinator):
            def _dispatch_bin(self, entries, lane, watch=None):
                for e in entries:
                    e.handle._set_result(e.x)
                    resolved.append(e.name)
                self.queue.mark_complete([e.name for e in entries])

        coord = Quiet(model._StubCtx(), start_thread=False)
        coord.enqueue(Entry(name="g", op_type="allreduce",
                            x=torch.ones(3), handle=model._RecHandle("g")))
        coord.shutdown()
        assert resolved == ["g"]

    def test_model_run_leaves_no_hooks_behind(self):
        explore(one_scenario(f"{CORPUS}:clean_lock_order"), budget_s=2.0)
        assert type(schedhooks.hooks()) is schedhooks.SchedulerHooks


def test_model_checker_imports_no_jax():
    """The checker and a scenario over the port's code run where jax
    cannot be imported (the card's machine has none)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from horovod_tpu_torch.analysis import model\n"
        "res = model.explore(model.builtin_scenarios()['coordinator'], "
        "budget_s=0.5)\n"
        "assert res.findings == [] and res.runs > 0\n"
        "assert not any(m == 'horovod_tpu' or m.startswith('horovod_tpu.')"
        " for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
