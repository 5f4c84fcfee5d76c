"""The port's serving fleet against the JAX package's, on the CPU.

Each of the twelve scenarios of ``tests/test_fleet.py`` runs on both
packages at its small config (d=64, H=4, Dh=16, L=2, V=256, f32; slots
4, page 16, chunk 64), the JAX weights carried across with
``params_from_numpy``. Per request: the tokens, the error and the replica
that took it; per fleet: ``readmission_log``, the scale events (event,
replica, cycle, pages freed), ``FleetUnavailable`` and the keys of
``stats()``. All must be equal.

The JAX fleet is built with ``HOROVOD_ARTIFACT_STORE`` unset (a
store-loaded executable fails on this CPU with "8 shards") and its
engines made synchronous (``test_torch_serving._synchronous``: the JAX
``decode_step`` races its own host tables). Two of the JAX test's
assertions do not hold for the JAX fleet here, so the port alone is held
to them, as each test says: the threaded run (the race above) and
``builds == 0`` (a JAX replica without the store compiles).

The whole module runs under a time limit of its own (``LIMIT_S``); the
threaded case has its own (``THREADED_LIMIT_S``).
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

import jax

from horovod_tpu import metrics as JM
from horovod_tpu.elastic.registry import MemberRegistry as JMemberRegistry
from horovod_tpu.resilience import chaos as jchaos
from horovod_tpu.serving import FleetUnavailable as JFleetUnavailable
from horovod_tpu.serving import Request as JRequest
from horovod_tpu.serving import ServeScheduler as JServeScheduler
from horovod_tpu.serving import ServeEngine as JServeEngine
from horovod_tpu.serving import ServingFleet as JServingFleet
from horovod_tpu.serving import reset_for_tests as jreset_serving
from horovod_tpu_torch import metrics as M
from horovod_tpu_torch import params_from_numpy
from horovod_tpu_torch.elastic.registry import MemberRegistry
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.serving import (FleetUnavailable, ReplicaState,
                                       Request, ServeEngine, ServeScheduler,
                                       ServingFleet)
from horovod_tpu_torch.serving import kv_cache as kvc
from horovod_tpu_torch.serving import reset_for_tests as reset_serving
import test_torch_serving as ts

LIMIT_S = 240
THREADED_LIMIT_S = 60


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(scope="module", autouse=True)
def _no_artifact_store():
    from horovod_tpu.store import artifact_store
    old = os.environ.pop("HOROVOD_ARTIFACT_STORE", None)
    artifact_store.reset_for_tests()
    yield
    if old is not None:
        os.environ["HOROVOD_ARTIFACT_STORE"] = old
    artifact_store.reset_for_tests()


@pytest.fixture(autouse=True)
def _clean():
    yield
    chaos.install(None)
    jchaos.install(None)
    reset_serving()
    jreset_serving()


@pytest.fixture(scope="module")
def params():
    jp = ts.jtfm.init_params(ts._jcfg(), jax.random.PRNGKey(0))
    return jp, params_from_numpy(ts._np_tree(jp), "cpu")


# ---------------------------------------------------------------------------
# both packages' fleets, requests and summaries
# ---------------------------------------------------------------------------

class Pkg:
    """One package's fleet API: ``jax`` or ``port``."""

    def __init__(self, name, params, engine_kw=None):
        self.name = name
        self.jax = name == "jax"
        self.Request = JRequest if self.jax else Request
        self.Unavailable = JFleetUnavailable if self.jax else FleetUnavailable
        self.chaos = jchaos if self.jax else chaos
        self.metrics = JM if self.jax else M
        self.reset = jreset_serving if self.jax else reset_serving
        kw = {**ts.ENGINE_KW, **(engine_kw or {})}
        jp, pp = params
        if self.jax:
            self.make_engine = lambda rid: ts._synchronous(
                JServeEngine(ts._jcfg(), jp, mesh=None, **kw))
        else:
            self.make_engine = lambda rid: ServeEngine(
                ts._cfg(), pp, device="cpu", **kw)

    def fleet(self, replicas=2, **kw):
        kw.setdefault("min_replicas", 1)
        kw.setdefault("max_replicas", max(replicas, 4))
        kw.setdefault("scale_down_idle", 10 ** 9)   # the autoscaler is quiet
        kw.setdefault("cooldown", 0)                # unless a test opts in
        kw.setdefault("queue_deadline", 0.0)
        cls = JServingFleet if self.jax else ServingFleet
        f = cls(self.make_engine, replicas=replicas, **kw)
        f.placed = []                   # (request rid, replica rid)
        submit_on = f.submit_on

        def record(rep, req):
            f.placed.append((req.rid, rep.rid))
            submit_on(rep, req)
        f.submit_on = record
        return f

    def reqs(self, n, seed=0, n_new=6, plen=12, arrival=0.0):
        rng = np.random.default_rng(seed)
        return [self.Request(rid=i,
                             prompt=rng.integers(1, 255, plen).astype(
                                 np.int32),
                             max_new_tokens=n_new, arrival=arrival)
                for i in range(n)]


def both(params, **kw):
    return Pkg("jax", params, **kw), Pkg("port", params, **kw)


def summary(fleet, done=None):
    """What must be equal between the packages (builds and wall times
    left out)."""
    done = fleet.completed if done is None else done
    events = [{k: e[k] for k in ("event", "replica", "cycle", "reason",
                                 "replicas",
                                 "queue_depth", "pages_freed",
                                 "pages_total", "orphaned", "aboard")
               if k in e} for e in fleet.scale_events]
    stats = fleet.stats()
    return {
        "tokens": {r.rid: list(r.tokens) for r in done},
        "errors": {r.rid: r.error for r in done},
        "placed": list(fleet.placed),
        "readmission_log": list(fleet.readmission_log),
        "scale_events": events,
        "states": {rid: rep.state for rid, rep in fleet.replicas.items()},
        "stats_keys": sorted(stats),
        "member_keys": {m: sorted(v) for m, v in stats["members"].items()},
        "stats": {k: v for k, v in stats.items() if k != "members"},
        "members": {m: {k: v for k, v in st.items() if k != "builds"}
                    for m, st in stats["members"].items()},
    }


# ---------------------------------------------------------------------------
# the bitwise contract and the lifecycle edges
# ---------------------------------------------------------------------------

def test_fleet_of_one_bitwise_equal_bare_engine(params):
    """A fleet of one gives the bare engine's tokens bitwise, in both
    packages, and the same tokens as the JAX fleet."""
    got = {}
    for pkg in both(params):
        fleet = pkg.fleet(replicas=1, max_replicas=1)
        done = fleet.run(pkg.reqs(6))
        got[pkg.name] = summary(fleet, done)
        pkg.reset()
        eng = pkg.make_engine(99)
        sched = (JServeScheduler(eng, queue_deadline=0.0) if pkg.jax else
                 ServeScheduler(eng, queue_deadline=0.0, device="cpu"))
        bare = sched.run(pkg.reqs(6))
        assert got[pkg.name]["tokens"] == {r.rid: r.tokens for r in bare}
        assert not any(got[pkg.name]["errors"].values())
    assert got["port"] == got["jax"]


def _limited(fn, seconds):
    """``fn()`` under a time limit of its own; the module's limit goes on
    afterwards, less the time spent."""
    def expired(signum, frame):
        raise TimeoutError(f"threaded fleet ran past {seconds} s")

    prev = signal.signal(signal.SIGALRM, expired)
    left = signal.alarm(seconds)
    t0 = time.monotonic()
    try:
        return fn()
    finally:
        signal.signal(signal.SIGALRM, prev)
        spent = int(time.monotonic() - t0) + 1
        signal.alarm(max(left - spent, 1) if left else 0)


def test_parallel_threaded_stepping_matches_serial(params):
    """``run(parallel=True)`` completes the same traffic with the same
    tokens as serial stepping. The JAX fleet's threaded run races its
    engine's host tables here, so the port alone is held to the JAX
    test's assertions, and its serial tokens to the JAX fleet's."""
    jpkg, pkg = both(params)
    jserial = summary_tokens(jpkg.fleet(replicas=2).run(jpkg.reqs(8)))
    serial = summary_tokens(pkg.fleet(replicas=2).run(pkg.reqs(8)))
    reset_serving()
    threaded = _limited(lambda: pkg.fleet(replicas=2).run(
        pkg.reqs(8), parallel=True), THREADED_LIMIT_S)
    assert len(threaded) == 8
    assert all(not r.error for r in threaded)
    assert summary_tokens(threaded) == serial == jserial


def summary_tokens(done):
    return {r.rid: list(r.tokens) for r in done}


def test_a_fleet_runs_threaded_twice(params):
    """A second ``run(parallel=True)`` of one fleet starts its replicas'
    threads again and serves (the JAX replica's second thread sees its
    stop flag still set and exits, and that fleet's run spins)."""
    pkg = Pkg("port", params)
    fleet = pkg.fleet(replicas=2)
    first = _limited(lambda: list(fleet.run(pkg.reqs(4), parallel=True)),
                     THREADED_LIMIT_S)
    second = pkg.reqs(4, seed=1)
    for r in second:
        r.rid += 10
    _limited(lambda: fleet.run(second, parallel=True), THREADED_LIMIT_S)
    assert len(first) == 4 and all(r.done and not r.error for r in second)
    assert all(rep._thread is None for rep in fleet.replicas.values())


def test_drain_no_drop_and_pages_freed(params):
    """Scale-down is admission-stop + run-to-completion: every request
    aboard the draining replica finishes, then it leaves with its whole
    page pool free; the two packages place, serve and drain alike."""
    got = {}
    for pkg in both(params):
        fleet = pkg.fleet(replicas=2)
        for r in pkg.reqs(8, seed=1):
            fleet.dispatch(r)
        fleet.cycle()
        rep = fleet.replicas[1]
        assert len(rep.aboard) > 0
        fleet.drain(1, reason="test")
        assert rep.state == "draining"
        assert rep not in fleet.admitting()
        extra = pkg.Request(rid=100, prompt=np.arange(1, 11, dtype=np.int32),
                            max_new_tokens=4)
        fleet.dispatch(extra)
        assert getattr(extra, "_fleet_seq") not in rep.aboard
        fleet.run([])
        assert rep.state == "left"
        assert len(fleet.completed) == 9
        assert all(not r.error for r in fleet.completed)
        assert rep.engine.allocator.free_pages == rep.engine.pool.n_pages
        leave = [e for e in fleet.scale_events if e["event"] == "leave"]
        assert leave and leave[0]["pages_freed"] == rep.engine.pool.n_pages
        got[pkg.name] = summary(fleet)
    assert got["port"] == got["jax"]


def test_replica_kill_readmission_is_deterministic(params):
    """A killed replica's queued and in-flight-but-unacked requests
    re-admit on the survivor in submission order, twice over identically,
    and the port re-admits as the JAX fleet does."""
    got = {}
    for pkg in both(params):
        runs = []
        for _ in range(2):
            fleet = pkg.fleet(replicas=2)
            reqs = pkg.reqs(12, seed=2, n_new=8)
            for r in reqs:
                r.arrival = None
                fleet.dispatch(r)
            for _ in range(2):
                fleet.cycle()
            acked_before = {r.rid for r in fleet.completed}
            orphans = fleet.kill_replica(1)
            assert fleet.replicas[1].state == "dead"
            assert orphans, "kill found nothing aboard: the drill is vacuous"
            fleet.run([])
            assert {r.rid for r in fleet.completed} == {r.rid for r in reqs}
            assert all(not r.error for r in fleet.completed)
            assert not (acked_before & {r.rid for r in orphans})
            assert fleet.readmission_log == sorted(fleet.readmission_log)
            runs.append(summary(fleet))
            pkg.reset()
        assert runs[0] == runs[1]
        got[pkg.name] = runs[0]
    assert got["port"] == got["jax"]


def test_warm_replica_builds_zero_through_router_path(params, monkeypatch):
    """A replica grown on a warm build directory reports ``builds == 0``
    and serves a routed request. The JAX fleet without its store compiles
    each replica (``builds == 3`` here), so the port alone is held to
    ``builds == 0``; the tokens and placements are the JAX fleet's. The
    count is real: a first paged-decode call that builds the kernel (one
    ``nvcc`` build, simulated on the CPU) lands on the replica that made
    it, and the grown replica reports none."""
    first_call = {"built": False}
    decode = kvc.paged_decode_attention

    def building_decode(*args, **kw):
        if not first_call["built"]:
            first_call["built"] = True
            with _build._count_lock:
                _build.builds_run += 1
        return decode(*args, **kw)

    got = {}
    for pkg in both(params):
        if not pkg.jax:
            monkeypatch.setattr(kvc, "paged_decode_attention",
                                building_decode)
        fleet = pkg.fleet(replicas=1)
        fleet.run(pkg.reqs(2, seed=3))
        rep = fleet.grow(reason="test")
        fleet.drain(0, reason="test")
        fleet.run([])
        req = pkg.Request(rid=50, prompt=np.arange(1, 13, dtype=np.int32),
                          max_new_tokens=4)
        assert fleet.dispatch(req) == rep.rid
        fleet.run([])
        assert req.done and not req.error and len(req.tokens) == 4
        if not pkg.jax:
            assert fleet.replicas[0].engine.builds == 1
            assert rep.engine.builds == 0
            assert fleet.stats()["members"]["replica-1"]["builds"] == 0
            grow = [e for e in fleet.scale_events if e["event"] == "grow"]
            assert [e["builds"] for e in grow] == [0, 0]
        got[pkg.name] = summary(fleet)
    assert got["port"] == got["jax"]


def test_prefix_affinity_routes_to_resident_replica(params):
    """A request whose prompt prefix is resident on replica R routes to R,
    and the reuse shows as cached prefill tokens, in both packages."""
    got = {}
    for pkg in both(params, engine_kw={"prefix_cache": True}):
        fleet = pkg.fleet(replicas=2)
        rng = np.random.default_rng(4)
        sys_prompt = rng.integers(1, 255, 48).astype(np.int32)

        def req(rid):
            tail = rng.integers(1, 255, 8).astype(np.int32)
            return pkg.Request(rid=rid,
                               prompt=np.concatenate([sys_prompt, tail]),
                               max_new_tokens=4)
        fleet.dispatch(req(0))
        fleet.run([])
        first = next(r.rid for r in fleet.replicas.values()
                     if r.dispatched_count)
        assert fleet.dispatch(req(1)) == first
        assert fleet.router.affinity_hits >= 1
        fleet.run([])
        cached = fleet.replicas[first].scheduler.cached_tokens
        assert cached > 0
        got[pkg.name] = (summary(fleet), cached, fleet.router.stats())
    assert got["port"] == got["jax"]


def test_autoscaler_grows_same_cycle_and_drains_idle(params):
    """Queue pressure grows the fleet in the SAME cycle it is observed;
    sustained idle drains back to the floor; both packages record the
    same scale events. The JAX replica grown without its store compiles,
    so ``builds == 0`` is held on the port alone."""
    got = {}
    for pkg in both(params):
        fleet = pkg.fleet(replicas=1, max_replicas=2, scale_up_depth=2,
                          scale_down_idle=3, cooldown=0)
        for r in pkg.reqs(10, seed=5, n_new=4):
            r.arrival = None
            fleet.dispatch(r)
        assert len(fleet.live()) == 1
        fleet.cycle()
        grow = [e for e in fleet.scale_events
                if e["event"] == "grow" and "queue_depth" in str(e["reason"])]
        assert grow and grow[0]["cycle"] == 0, \
            "the autoscaler did not react within one scheduling cycle"
        if not pkg.jax:
            assert grow[0]["builds"] == 0
        fleet.run([])
        assert len(fleet.completed) == 10
        for _ in range(12):
            fleet.cycle()
        fleet.run([])
        assert len(fleet.admitting()) == fleet.min_replicas
        assert any(e["event"] == "drain" for e in fleet.scale_events)
        got[pkg.name] = summary(fleet)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# chaos drills at the real dispatch path
# ---------------------------------------------------------------------------

def _injections(pkg, action):
    fam = pkg.metrics.get_registry().snapshot().get(
        "hvd_chaos_injections_total", {"series": []})
    return sum(s["value"] for s in fam["series"]
               if s["labels"]["action"] == action)


def test_chaos_replica_kill_zero_drops_at_dispatch_path(params):
    got = {}
    for pkg in both(params):
        before = _injections(pkg, "replica_kill")
        pkg.chaos.install({"replica_kill": {"replica": 1,
                                            "after_requests": 2}})
        fleet = pkg.fleet(replicas=2)
        # whether replica 1 is blacklisted when the registry announces its
        # death (the cooldown is 10 s: a slow run may outlast it)
        blacklisted = []
        fleet.registry.register_listener(
            lambda ts_, res, reg=fleet.registry: blacklisted.append(
                reg.is_blacklisted("replica-1")))
        reqs = pkg.reqs(10, seed=6, n_new=5)
        done = fleet.run(reqs)
        assert {r.rid for r in done} == {r.rid for r in reqs}
        assert all(not r.error for r in done)
        assert fleet.replicas[1].state == "dead"
        assert fleet.readmissions >= 1
        assert blacklisted == [True]
        assert _injections(pkg, "replica_kill") >= before + 1
        got[pkg.name] = summary(fleet, done)
    assert got["port"] == got["jax"]


def test_chaos_replica_slow_delays_but_serves(params):
    got = {}
    for pkg in both(params):
        before = _injections(pkg, "replica_slow")
        pkg.chaos.install({"replica_slow": {"replica": 0, "delay": 0.002,
                                            "after_requests": 1}})
        fleet = pkg.fleet(replicas=1, max_replicas=1)
        done = fleet.run(pkg.reqs(4, seed=7, n_new=3))
        assert len(done) == 4 and all(not r.error for r in done)
        assert fleet.router.stats()["slow_injected_s"] >= 0.002
        assert _injections(pkg, "replica_slow") >= before + 1
        got[pkg.name] = summary(fleet, done)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# registry + observability surface
# ---------------------------------------------------------------------------

def test_member_registry_lifecycle_and_blacklist():
    got = []
    for cls in (JMemberRegistry, MemberRegistry):
        events = []
        reg = cls()
        reg.register_listener(lambda ts_, res: events.append(res))
        seen = []
        reg.join("replica-0", slots=4)
        reg.join("replica-1", slots=4)
        seen.append((reg.members(), reg.slots("replica-1")))
        reg.dead("replica-0")
        seen.append((reg.members(), reg.is_blacklisted("replica-0")))
        reg.join("replica-0", slots=4)       # cooling down: no flap-back
        seen.append(reg.members())
        reg.leave("replica-1")
        seen.append(reg.members())
        reg.register_listener(lambda ts_, res: 1 / 0)
        reg.join("replica-2", slots=1)
        seen.append((reg.listener_failures, reg.members()))
        assert seen == [(["replica-0", "replica-1"], 4),
                        (["replica-1"], True), ["replica-1"], [],
                        (1, ["replica-2"])]
        got.append((seen, [int(e) for e in events]))
    assert got[0] == got[1]


def test_fleet_unavailable_when_nothing_admits(params):
    msgs = []
    for pkg in both(params):
        fleet = pkg.fleet(replicas=1, max_replicas=1)
        fleet.drain(0, reason="test")
        fleet.run([])
        with pytest.raises(pkg.Unavailable) as exc:
            fleet.dispatch(pkg.Request(rid=0,
                                       prompt=np.arange(1, 5, dtype=np.int32),
                                       max_new_tokens=2))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_fleet_healthz_block_and_metrics(params):
    got = {}
    for pkg in both(params):
        fleet = pkg.fleet(replicas=2)
        fleet.run(pkg.reqs(4, seed=8, n_new=3))
        blk = pkg.metrics.health_snapshot().get("fleet")
        assert blk is not None
        assert blk["replicas"] == 2 and blk["completed"] == 4
        assert set(blk["members"]) == {"replica-0", "replica-1"}
        assert blk["router"]["dispatches"] == 4
        reg = pkg.metrics.get_registry().snapshot()
        for name in ("hvd_fleet_replicas", "hvd_fleet_queue_depth",
                     "hvd_fleet_scale_events_total",
                     "hvd_fleet_readmissions_total"):
            assert name in reg
            assert reg[name]["kind"] == (
                pkg.metrics.get_registry().get(name).kind)
        got[pkg.name] = (
            {k: v for k, v in blk.items() if k != "members"},
            {m: {k: v for k, v in st.items() if k != "builds"}
             for m, st in blk["members"].items()},
            {n: (reg[n]["kind"], reg[n]["help"]) for n in reg
             if n.startswith("hvd_fleet_")})
        pkg.reset()
        assert pkg.metrics.health_snapshot().get("fleet") is None
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# port-only: the device a replica serves on
# ---------------------------------------------------------------------------

def test_replica_scheduler_takes_the_engine_device(params):
    """Each replica's scheduler is built on its engine's device, and the
    replica steps with that device current (a no-op on the CPU)."""
    pkg = Pkg("port", params)
    fleet = pkg.fleet(replicas=2)
    for rep in fleet.replicas.values():
        assert rep.engine.device == torch.device("cpu")
        with rep._on_device():
            pass
    done = fleet.run(pkg.reqs(4, seed=9, n_new=2))
    assert [r.rid for r in done] == [0, 1, 2, 3]
    assert all(rep.state == ReplicaState.READY
               for rep in fleet.replicas.values())


def test_fleet_and_metrics_export_import_no_jax():
    """The fleet, the router and the metrics exports are part of the
    jax-free package."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from horovod_tpu_torch.serving import fleet, router\n"
            "from horovod_tpu_torch.metrics import (MetricsServer,\n"
            "    SnapshotDumper, ClusterAggregator, health_snapshot)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'horovod_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
