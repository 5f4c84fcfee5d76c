"""The port's elastic layer (``horovod_tpu_torch/elastic``) against the JAX
package's (``horovod_tpu/elastic``) on the CPU.

The scenarios of ``tests/test_elastic.py`` run through both packages with
the same ``FakeClock`` and their results are compared: the host-manager
diffs, cooldown and resurrection; ``assign_slots``; the ``ElasticDriver``
scenarios (growth with rank preservation, a failure's blacklist, spawns on
new and recovered hosts, a resumable exit restoring the committed
snapshot, the min-np timeout, readiness, the store mirror of a dropped
push); the notification round trip and the bad signature (each package's
client against the other's service too); the sampler's partitions across
a resize, index for index; ``ObjectState``/``TorchState`` commit, restore
and sync (the sampler union); the ``run`` wrapper's recovery and reset
limit; and the elastic launcher's connectivity probe. The port's state
runs in a world of one (``init(device="cpu")``), the JAX package's on its
8-device CPU mesh.

The whole module runs under a time limit of its own (``LIMIT_S``).
"""

import dataclasses
import json
import signal
import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu as hvd
from horovod_tpu import elastic as jelastic
from horovod_tpu.elastic import discovery as jdisc
from horovod_tpu.elastic import driver as jdriver
from horovod_tpu.elastic import notification as jnotif
import horovod_tpu_torch as htt
from horovod_tpu_torch import elastic
from horovod_tpu_torch.elastic import discovery as disc
from horovod_tpu_torch.elastic import driver as tdriver
from horovod_tpu_torch.elastic import notification as notif

LIMIT_S = 180
PACKAGES = {"port": (disc, tdriver), "jax": (jdisc, jdriver)}


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture()
def port_world():
    """The port initialized in a world of one on the CPU."""
    htt.init(device="cpu")
    yield
    if htt.is_initialized():
        htt.shutdown()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def both(fn):
    """``fn(discovery_module, driver_module)`` for each package; asserts
    the results equal and returns the port's."""
    got = {name: fn(*mods) for name, mods in PACKAGES.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


# -- discovery / host manager -------------------------------------------------

def test_host_manager_diffs_and_order():
    def scenario(D, _):
        d = D.FixedHosts({"a": 2, "b": 2})
        hm = D.HostManager(d, clock=FakeClock())
        out = [hm.update_available_hosts(), hm.available_slots,
               list(hm.host_assignment_order)]
        d.set({"c": 2, "a": 2, "b": 2})
        out += [hm.update_available_hosts(), list(hm.host_assignment_order)]
        d.set({"a": 2, "c": 2})
        out += [hm.update_available_hosts(), list(hm.host_assignment_order),
                hm.update_available_hosts()]
        d.set({"a": 1, "c": 3})
        out += [hm.update_available_hosts()]
        return out

    got = both(scenario)
    assert got[:3] == [disc.HostUpdateResult.ADDED, 4, ["a", "b"]]
    assert got[4] == ["a", "b", "c"] and got[6] == ["a", "c"]
    assert got[-1] == disc.HostUpdateResult.MIXED


def test_blacklist_cooldown_resurrection():
    def scenario(D, _):
        clock = FakeClock()
        hm = D.HostManager(D.FixedHosts({"a": 1, "b": 1}), clock=clock)
        hm.update_available_hosts()
        hm.blacklist("b")
        out = [hm.is_blacklisted("b")]
        hm.update_available_hosts()
        out.append(hm.available_slots)
        clock.advance(11.0)
        out += [hm.is_blacklisted("b"), hm.update_available_hosts(),
                hm.available_slots]
        hm.blacklist("b")
        clock.advance(11.0)
        out.append(hm.is_blacklisted("b"))      # second period is 20 s
        clock.advance(10.0)
        out.append(hm.is_blacklisted("b"))
        return out

    assert both(scenario) == [True, 1, False, disc.HostUpdateResult.ADDED, 2,
                              True, False]


@pytest.mark.parametrize("hosts,order,max_np", [
    ({"a": 2, "b": 2}, ["a", "b"], None),
    ({"a": 2, "b": 2}, ["a", "b"], 3),
    ({"x": 1, "y": 3, "z": 2}, ["z", "x", "y"], 5),
    ({"a": 4}, ["a"], None)])
def test_assign_slots_matches_jax(hosts, order, max_np):
    def scenario(_, M):
        return [dataclasses.astuple(s)
                for s in M.assign_slots(order, hosts, max_np)]

    got = both(scenario)
    assert len(got) == min(sum(hosts.values()), max_np or 99)


def test_slot_shrink_classified_as_removed():
    def scenario(D, _):
        d = D.FixedHosts({"a": 4})
        hm = D.HostManager(d, clock=FakeClock())
        hm.update_available_hosts()
        d.set({"a": 2})
        return hm.update_available_hosts()

    assert both(scenario) == disc.HostUpdateResult.REMOVED


def test_discovery_script_parsing(tmp_path):
    script = tmp_path / "d.sh"
    script.write_text("#!/bin/sh\necho a:2\necho b\necho\necho c:1\n")
    script.chmod(0o755)
    assert disc.HostDiscoveryScript(str(script), default_slots=3) \
        .find_available_hosts_and_slots() == \
        jdisc.HostDiscoveryScript(str(script), default_slots=3) \
        .find_available_hosts_and_slots() == {"a": 2, "b": 3, "c": 1}


# -- driver -------------------------------------------------------------------

def make_driver(M, D, hosts, min_np=1, max_np=None, clock=None):
    d = D.FixedHosts(hosts)
    driver = M.ElasticDriver(d, min_np=min_np, max_np=max_np,
                             clock=clock or FakeClock())
    started = []
    driver.start(min_np, lambda slot: started.append(slot))
    return driver, d, started


def test_driver_initial_launch_and_resize():
    def scenario(D, M):
        driver, d, started = make_driver(M, D, {"a": 2, "b": 2})
        try:
            out = [len(started), driver.world_size()]
            events = []
            driver.register_worker_notification_listener(
                lambda ts, res: events.append(res))
            d.set({"a": 2, "b": 2, "c": 2})
            driver.host_manager.update_available_hosts()
            driver._on_hosts_updated(D.HostUpdateResult.ADDED)
            out += [driver.world_size(), events, sorted(
                ((s.hostname, s.local_rank), s.rank)
                for s in driver.current_assignments),
                list(driver.world_size_history)]
            return out
        finally:
            driver.stop()

    got = both(scenario)
    assert got[:3] == [4, 4, 6]
    assert dict(got[4])[("c", 0)] == 4 and dict(got[4])[("b", 1)] == 3


def test_driver_worker_failure_blacklists_and_reassigns():
    def scenario(D, M):
        driver, d, _ = make_driver(M, D, {"a": 1, "b": 1})
        try:
            events = []
            driver.register_worker_notification_listener(
                lambda ts, res: events.append(res))
            driver.record_worker_exit(1, exit_code=1)
            return [driver.host_manager.is_blacklisted("b"),
                    driver.world_size(),
                    driver.current_assignments[0].hostname,
                    driver.reset_count, events]
        finally:
            driver.stop()

    assert both(scenario) == [True, 1, "a", 1,
                              [disc.HostUpdateResult.REMOVED]]


def test_driver_spawns_workers_on_new_and_recovered_hosts():
    def scenario(D, M):
        clock = FakeClock()
        driver, d, started = make_driver(M, D, {"a": 1, "b": 1},
                                         clock=clock)
        try:
            d.set({"a": 1, "b": 1, "c": 1})
            driver.host_manager.update_available_hosts()
            driver._on_hosts_updated(D.HostUpdateResult.ADDED)
            driver.record_worker_exit(1, exit_code=1)
            n_cooling = len(started)
            clock.advance(11.0)
            driver.host_manager.update_available_hosts()
            driver._on_hosts_updated(D.HostUpdateResult.ADDED)
            return [[s.hostname for s in started], n_cooling,
                    driver.world_size()]
        finally:
            driver.stop()

    assert both(scenario) == [["a", "b", "c", "b"], 3, 3]


def test_driver_restore_after_reset_resumes_from_snapshot(tmp_path):
    """A worker that exits with the RESUMABLE status is respawned WITHOUT
    blacklisting its host and resumes from the latest committed snapshot
    (each package's own AsyncCheckpointer, the same numpy state)."""
    from horovod_tpu.resilience import AsyncCheckpointer as JCk
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.resilience import AsyncCheckpointer as Ck
    from horovod_tpu_torch.resilience.preemption import RESUMABLE_EXIT_CODE
    cks = {"port": Ck, "jax": JCk}
    resets = M.counter("hvd_elastic_resets_total")
    before = resets.value

    def run(name):
        D, Mod = PACKAGES[name]
        ckpt_dir = str(tmp_path / name)
        incarnations = []

        def worker(slot):
            with cks[name](ckpt_dir, interval=0, fmt="pickle") as ck:
                got = ck.restore_latest()
                step, state = got if got is not None else (
                    0, {"w": np.zeros(4, np.float64)})
                incarnations.append((slot.rank, step))
                for _ in range(step, step + 5):
                    state = {"w": state["w"] + 1.0}
                ck.save(step + 5, state, sync=True)

        driver = Mod.ElasticDriver(D.FixedHosts({"a": 1}), min_np=1,
                                   clock=FakeClock())
        driver.start(1, worker)
        try:
            driver.record_worker_exit(0, RESUMABLE_EXIT_CODE)
            with cks[name](ckpt_dir, interval=0, fmt="pickle") as ck:
                step, state = ck.restore_latest()
            return [incarnations, driver.host_manager.is_blacklisted("a"),
                    driver.reset_count, step, state["w"].tolist()]
        finally:
            driver.stop()

    got = run("port")
    assert got == run("jax")
    assert got == [[(0, 0), (0, 5)], False, 1, 10, [10.0] * 4]
    assert resets.value == before + 1


def test_driver_min_np_timeout():
    for D, M in PACKAGES.values():
        clock = FakeClock()
        driver = M.ElasticDriver(D.FixedHosts({"a": 1}), min_np=4,
                                 timeout=5.0, clock=clock)

        def advance():
            time.sleep(0.05)
            clock.advance(10.0)

        t = threading.Thread(target=advance)
        t.start()
        with pytest.raises(TimeoutError, match="4 slots"):
            driver.wait_for_available_slots(4)
        t.join()


def test_driver_readiness():
    def scenario(D, M):
        driver, _, _ = make_driver(M, D, {"a": 2}, min_np=2)
        try:
            out = [driver.all_ranks_ready()]
            driver.record_ready("a", 0)
            out.append(driver.all_ranks_ready())
            driver.record_ready("a", 1)
            out.append(driver.all_ranks_ready())
            return out
        finally:
            driver.stop()

    assert both(scenario) == [False, False, True]


def test_driver_mirror_reaches_a_worker_through_the_store(monkeypatch):
    """A dropped push is mirrored into the c10d store (site
    elastic_notification), and a worker's State finds it there at its
    next commit: the port's driver and state over one HashStore."""
    import torch.distributed as dist
    from horovod_tpu_torch.utils import schedhooks
    store = dist.HashStore()

    class Hooks(schedhooks.SchedulerHooks):
        def kv_client(self):
            return store

    prev = schedhooks.install(Hooks())
    try:
        state = elastic.ObjectState(epoch=0)
        clock = FakeClock()
        clock.advance(5.0)          # the event's timestamp must be > 0
        driver, d, _ = make_driver(tdriver, disc, {"a": 1}, clock=clock)
        ok = []
        driver.register_worker_notification_listener(
            lambda ts, res: ok.append(ts))
        driver.register_worker_notification_listener(
            lambda ts, res: (_ for _ in ()).throw(OSError("push failed")))
        d.set({"a": 1, "b": 1})
        driver._wakeup.set()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                not store.check(["hvd/elastic/hosts_updated"]):
            time.sleep(0.05)
        driver.stop()
        assert ok, "healthy listener starved by broken one"
        msg = json.loads(store.get("hvd/elastic/hosts_updated"))
        assert msg["wall_time"] > 0 and "timestamp" in msg
        with pytest.raises(elastic.HostsUpdatedInterrupt) as e:
            state.check_host_updates()
        assert not e.value.skip_sync          # ADDED: sync needed
    finally:
        schedhooks.install(prev)


# -- notification RPC ---------------------------------------------------------

@pytest.mark.parametrize("service,client", [
    (notif, notif), (notif, jnotif), (jnotif, notif)])
def test_worker_notification_roundtrip(service, client):
    svc = service.WorkerNotificationService()
    got = []
    svc.register_listener(lambda ts, res: got.append((ts, res)))
    addr = svc.start()
    try:
        assert client.WorkerNotificationClient(addr).notify_hosts_updated(
            123.0, disc.HostUpdateResult.ADDED)
        deadline = time.time() + 2
        while not got and time.time() < deadline:
            time.sleep(0.01)
        assert got == [(123.0, disc.HostUpdateResult.ADDED)]
    finally:
        svc.stop()


def test_worker_notification_bad_signature_rejected():
    svc = notif.WorkerNotificationService(secret=b"right")
    got = []
    svc.register_listener(lambda ts, res: got.append(ts))
    addr = svc.start()
    try:
        assert not notif.WorkerNotificationClient(
            addr, secret=b"wrong").notify_hosts_updated(1.0)
        time.sleep(0.2)
        assert got == []
    finally:
        svc.stop()
    assert notif.SECRET_ENV == jnotif.SECRET_ENV == "HVD_TPU_SECRET"


# -- sampler ------------------------------------------------------------------

def _samplers(**kw):
    return elastic.ElasticSampler(**kw), jelastic.ElasticSampler(**kw)


def _jax_world_progress(world, batches, bs, **kw):
    """The JAX samplers of a world after ``batches`` synchronous batches:
    each records its own chunk; the world's progress is their union (what
    ``TpuState.sync`` forms)."""
    ranks = [jelastic.ElasticSampler(rank=r, num_replicas=world, **kw)
             for r in range(world)]
    for x in ranks:
        for b in range(batches):
            x.record_batch(b, bs)
    return ranks, {i for x in ranks for i in x.processed_indices}


def test_elastic_sampler_partition_and_resize_index_for_index():
    """The partitions are the JAX sampler's, index for index, before and
    after a resize. The port's one rank records the world's batch, which
    is the union of the JAX ranks' own records."""
    s, j = _samplers(dataset_size=20, shuffle=False, rank=0, num_replicas=2)
    assert list(s) == list(j) == list(range(0, 20, 2)) and len(s) == 10
    jranks, union = _jax_world_progress(2, 3, 2, dataset_size=20,
                                        shuffle=False)
    for b in range(3):
        s.record_batch(b, 2)
    assert sorted(s.processed_indices) == sorted(union) == list(range(12))
    j.load_state_dict({"epoch": 0, "processed_indices": sorted(union)})
    for x in (s, j):
        x._explicit_replicas = 4
        x.reset()
    assert list(s.indices) == list(j.indices)
    for r in range(4):
        s2, j2 = _samplers(dataset_size=20, shuffle=False, rank=r,
                           num_replicas=4)
        s2.load_state_dict(s.state_dict())
        j2.load_state_dict(j.state_dict())
        assert list(s2.indices) == list(j2.indices)


@pytest.mark.parametrize("size,seed,world1,world2", [(101, 3, 2, 3),
                                                     (64, 0, 4, 3),
                                                     (37, 9, 3, 5)])
def test_elastic_sampler_carryover_across_world_resize(size, seed, world1,
                                                       world2):
    """Synchronous batches on world1, then the carry onto world2: the
    port's carry (any one rank's record) is the JAX ranks' union, and the
    new partitions are equal index for index."""
    bs = 4
    carries = []
    for pkg in (elastic, jelastic):
        w1 = [pkg.ElasticSampler(dataset_size=size, shuffle=True, seed=seed,
                                 rank=r, num_replicas=world1)
              for r in range(world1)]
        for x in w1:
            for b in range(2):
                x.record_batch(b, bs)
        if pkg is elastic:
            merged = set(w1[-1].state_dict()["processed_indices"])
            assert all(set(x.processed_indices) == merged for x in w1)
        else:
            merged = set()
            for x in w1:
                merged.update(x.state_dict()["processed_indices"])
        carry = {"epoch": 0, "processed_indices": sorted(merged)}
        w2 = []
        for r in range(world2):
            x = pkg.ElasticSampler(dataset_size=size, shuffle=True,
                                   seed=seed, rank=r, num_replicas=world2)
            x.load_state_dict(dict(carry))
            w2.append([int(i) for i in x.indices])
        carries.append((carry, w2))
    assert carries[0] == carries[1]
    carry, w2 = carries[0]
    union = set(i for shard in w2 for i in shard)
    assert union == set(range(size)) - set(carry["processed_indices"])


def test_elastic_sampler_epoch_reset():
    s, j = _samplers(dataset_size=8, shuffle=True, rank=0, num_replicas=1,
                     seed=1)
    order0 = list(s)
    for x in (s, j):
        x.record_batch(0, 4)
        x.set_epoch(1)
    assert s.processed_indices == [] and len(s) == 8
    assert list(s) == list(j) and list(s) != order0


# -- state + run wrapper ------------------------------------------------------

def test_object_state_commit_restore(port_world, hvd_ctx):
    for pkg in (elastic, jelastic):
        st = pkg.ObjectState(epoch=0, best=1.0)
        st.epoch = 5
        st.restore()
        assert st.epoch == 0
        st.epoch = 5
        st.commit()
        st.epoch = 9
        st.restore()
        assert st.epoch == 5
        st.sync()
        assert (st.epoch, st.best) == (5, 1.0)


def _model_opt():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return model, opt


def _train(model, opt):
    opt.zero_grad()
    model(torch.ones(5, 3) * torch.arange(5.0)[:, None]).sum().backward()
    opt.step()


def test_torch_state_commit_restore_in_place(port_world):
    """``restore`` writes the committed model and optimizer state into the
    live tensors (the objects that hold them see the values); ``sync``
    makes them rank 0's (a world of one: themselves)."""
    model, opt = _model_opt()
    _train(model, opt)
    st = elastic.TorchState(model=model, optimizer=opt, epoch=0)
    ref = {k: v.clone() for k, v in model.state_dict().items()}
    mom = {i: opt.state[p]["momentum_buffer"].clone()
           for i, p in enumerate(model.parameters())}
    live = [p for p in model.parameters()]
    live_mom = [opt.state[p]["momentum_buffer"] for p in live]
    _train(model, opt)
    st.epoch = 3
    st.restore()
    assert st.epoch == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    for i, p in enumerate(model.parameters()):
        assert p is live[i]
        assert opt.state[p]["momentum_buffer"] is live_mom[i]
        assert torch.equal(live_mom[i], mom[i])
    _train(model, opt)
    st.epoch = 4
    st.commit()
    committed = {k: v.clone() for k, v in model.state_dict().items()}
    _train(model, opt)
    st.sync()
    assert st.epoch == 4
    for k, v in model.state_dict().items():
        assert torch.equal(v, committed[k]), k


def test_torch_state_persists_for_the_next_generation(port_world, tmp_path,
                                                      monkeypatch):
    """Each commit persists ``state-<host>-<lrank>.pkl`` atomically; the
    first in-memory snapshot does not, so a respawned worker adopts the
    previous generation's file (the JAX ``TpuState`` rule)."""
    monkeypatch.setenv("HVD_ELASTIC_HOSTNAME", "hostA")
    monkeypatch.setenv("HVD_ELASTIC_LOCAL_RANK", "1")
    model, opt = _model_opt()
    sampler = elastic.ElasticSampler(dataset_size=16, shuffle=False, rank=0,
                                     num_replicas=1)
    st = elastic.TorchState(model=model, optimizer=opt, sampler=sampler,
                            checkpoint_dir=str(tmp_path), epoch=0)
    path = tmp_path / "state-hostA-1.pkl"
    assert not path.exists()
    _train(model, opt)
    sampler.record_batch(0, 4)
    st.epoch = 2
    st.commit()
    assert path.exists() and not (tmp_path / "state-hostA-1.pkl.tmp").exists()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    # the next generation: fresh objects, the committed state adopted
    model2, opt2 = _model_opt()
    sampler2 = elastic.ElasticSampler(dataset_size=16, shuffle=False,
                                      rank=0, num_replicas=1)
    st2 = elastic.TorchState(model=model2, optimizer=opt2, sampler=sampler2,
                             checkpoint_dir=str(tmp_path), epoch=0)
    st2.sync()
    assert st2.epoch == 2
    assert sampler2.processed_indices == [0, 1, 2, 3]
    for k, v in model2.state_dict().items():
        assert torch.equal(v, want[k]), k
    for p, q in zip(model.parameters(), model2.parameters()):
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           opt2.state[q]["momentum_buffer"])


def test_state_sync_unions_all_ranks_sampler_progress(port_world, hvd_ctx,
                                                      monkeypatch):
    """Non-root ranks' processed_indices survive a sync: the snapshots are
    allgathered and unioned before the rank-0 broadcast (both packages,
    the other rank's snapshot injected)."""
    import horovod_tpu.functions as JF
    import horovod_tpu_torch.functions as F
    results = []
    for pkg, mod, cls in ((elastic, F, "TorchState"),
                          (jelastic, JF, "TpuState")):
        sampler = pkg.ElasticSampler(dataset_size=16, shuffle=False, rank=0,
                                     num_replicas=2)
        st = getattr(pkg, cls)(sampler=sampler, epoch=0)
        sampler.record_batch(0, 2)
        st.save()
        local = dict(st._sampler_snapshot)
        other = {"epoch": 0, "processed_indices": [1, 3]}
        monkeypatch.setattr(mod, "allgather_object",
                            lambda obj, **kw: [local, other])
        st.sync()
        results.append((st._sampler_snapshot, list(sampler.indices)))
    assert results[0] == results[1]
    merged = set(results[0][0]["processed_indices"])
    assert {0, 2, 1, 3} <= merged
    assert not merged & set(results[0][1])


def test_run_wrapper_recovers_from_internal_error(port_world, hvd_ctx):
    outs = []
    for pkg, is_init in ((elastic, htt.is_initialized),
                         (jelastic, hvd.is_initialized)):
        st = pkg.ObjectState(epoch=0, completed=[])
        calls = {"n": 0}

        @pkg.run
        def train(state):
            calls["n"] += 1
            for epoch in range(state.epoch, 4):
                if epoch == 2 and calls["n"] == 1:
                    raise pkg.HorovodInternalError("card lost")
                state.completed = state.completed + [epoch]
                state.epoch = epoch + 1
                state.commit()
            return state.completed

        outs.append((train(st), calls["n"], is_init()))
    assert outs[0] == outs[1] == ([0, 1, 2, 3], 2, True)
    from horovod_tpu_torch.runtime.context import get_context
    assert get_context().device.type == "cpu"     # reset on the same device


def test_run_wrapper_resets_resolve_outstanding_handles(port_world):
    """The reset resolves a handle not yet waited on with ResizeInterrupt
    (its wait raises at once) instead of leaving it on the destroyed
    process group."""
    h = htt.allreduce_async(torch.ones(3), name="pre-reset")
    from horovod_tpu_torch.elastic.state import _reset_runtime
    _reset_runtime()
    with pytest.raises(elastic.ResizeInterrupt):
        h.wait()
    assert htt.is_initialized()


def test_run_wrapper_hosts_updated_and_reset_limit(port_world, hvd_ctx):
    for pkg in (elastic, jelastic):
        st = pkg.ObjectState(epoch=0)
        fired = []
        st.register_reset_callbacks([lambda: fired.append(1)])

        @pkg.run
        def always_interrupt(state):
            state.on_hosts_updated(time.time(),
                                   disc.HostUpdateResult.REMOVED)
            state.commit()

        with pytest.raises(RuntimeError, match="reset limit"):
            always_interrupt(st, reset_limit=2)
        assert len(fired) == 2


def test_elastic_end_to_end_training(port_world):
    """In process: a torch model + TorchState + ElasticSampler; a pushed
    topology change interrupts mid-epoch, training resumes from committed
    state with the remaining samples, and every sample is processed
    exactly once (tests/test_elastic.py's end-to-end scenario)."""
    torch.manual_seed(0)
    model = torch.nn.Linear(8, 10)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    rng = np.random.RandomState(0)
    data_x = torch.tensor(rng.rand(32, 8).astype(np.float32))
    data_y = torch.tensor(rng.randint(0, 10, (32,)))
    sampler = elastic.ElasticSampler(dataset_size=32, shuffle=False, rank=0,
                                     num_replicas=1)
    state = elastic.TorchState(model=model, optimizer=opt, sampler=sampler,
                               epoch=0, batch_idx=0, seen=[])
    interrupted = {"done": False}
    batch_size = 8

    @elastic.run
    def train(state):
        n_batches = len(state.sampler) // batch_size
        for b in range(state.batch_idx, n_batches):
            if b == 2 and not interrupted["done"]:
                interrupted["done"] = True
                state.on_hosts_updated(time.time(),
                                       disc.HostUpdateResult.REMOVED)
                state.commit()          # raises HostsUpdatedInterrupt
            idx = np.asarray(state.sampler.indices[
                b * batch_size:(b + 1) * batch_size])
            opt.zero_grad()
            torch.nn.functional.cross_entropy(
                model(data_x[idx]), data_y[idx]).backward()
            opt.step()
            state.seen = state.seen + [int(i) for i in idx]
            state.sampler.record_batch(b, batch_size)
            state.batch_idx = b + 1
            state.commit()
        return state.seen

    seen = train(state)
    assert interrupted["done"]
    assert sorted(seen) == list(range(32))


# -- the small repairs: chaos faults and knobs --------------------------------

def test_resize_faults_are_no_longer_unported():
    """host_loss, slice_loss and host_return reach ResizeCoordinator.poll
    now, replica_kill and replica_slow the serving fleet's router, and
    store_corrupt the artifact store's read (its first read here is
    refused as corrupt); the data service's fault still waits for
    A.13b."""
    from horovod_tpu_torch.resilience import chaos
    try:
        chaos.install({"host_loss": {"host": 1, "at_step": 2},
                       "slice_loss": {"slice": 1, "at_step": 3},
                       "host_return": {"host": 1, "at_step": 4},
                       "replica_kill": {"replica": 0},
                       "replica_slow": {"replica": 1, "delay": 0.1},
                       "store_corrupt": {"fail_first": 1},
                       "data_worker_kill": {"worker": 0}})
        assert chaos.unported_faults() == [("data_worker_kill", "A.13b")]
        assert [chaos.on_store_load("entry") for _ in range(2)] == [
            True, False]
        assert [chaos.resize_notice(s) for s in range(6)] == [
            None, None, {"kind": "host_loss", "host": 1},
            {"kind": "slice_loss", "slice": 1},
            {"kind": "host_return", "host": 1}, None]
    finally:
        chaos.install(None)


@pytest.mark.parametrize("name", ["HOROVOD_AUTO_RESUME",
                                  "HOROVOD_ELASTIC_GRACE_SECONDS",
                                  "HOROVOD_ELASTIC_RESIZE_MARGIN",
                                  "HOROVOD_ELASTIC_RESIZE_TIMEOUT",
                                  "HOROVOD_ELASTIC"])
def test_launcher_and_elastic_knobs_match_jax(name, monkeypatch):
    from horovod_tpu.config import knobs as jknobs
    from horovod_tpu_torch.config import knobs
    monkeypatch.delenv(name, raising=False)
    assert knobs.get(name) == jknobs.get(name)
    assert type(knobs.get(name)) is type(jknobs.get(name))
    monkeypatch.setenv(name, "3")
    assert knobs.get(name) == jknobs.get(name)


# -- the elastic launcher's pre-spawn probe -----------------------------------

def _slot(host, rank, size):
    return tdriver.SlotInfo(hostname=host, rank=rank, local_rank=0,
                            cross_rank=rank, size=size, local_size=1,
                            cross_size=size)


def _probe_launcher(tmp_path):
    from horovod_tpu_torch.runner.elastic_run import ElasticLauncher
    return ElasticLauncher(["true"], disc.FixedHosts(
        {"remote-a": 1, "remote-b": 1}), min_np=1, state_dir=str(tmp_path))


def test_elastic_probe_blacklists_unreachable(monkeypatch, tmp_path):
    from horovod_tpu_torch.runner import probe as probe_mod
    launcher = _probe_launcher(tmp_path)
    launcher.host_manager.update_available_hosts()

    def fail(hosts, **kw):
        raise probe_mod.ProbeError("no route", failed_hosts=["remote-b"])
    monkeypatch.setattr(probe_mod, "probe_hosts", fail)
    slots = [_slot("remote-a", 0, 2), _slot("remote-b", 1, 2)]
    assert launcher._probe_generation(slots) is None
    assert launcher.host_manager.is_blacklisted("remote-b")
    assert not launcher.host_manager.is_blacklisted("remote-a")


def test_elastic_probe_feeds_advertise_addresses(monkeypatch, tmp_path):
    import socket
    from horovod_tpu_torch.runner import probe as probe_mod
    launcher = _probe_launcher(tmp_path)
    monkeypatch.setattr(probe_mod, "probe_hosts",
                        lambda hosts, **kw: {0: "10.0.0.7", 1: "10.0.0.8"})
    slots = [_slot("remote-a", 0, 2), _slot("remote-b", 1, 2)]
    assert launcher._probe_generation(slots) == {"remote-a": "10.0.0.7",
                                                 "remote-b": "10.0.0.8"}
    # a mixed world: the driver host's workers get its address too
    monkeypatch.setattr(probe_mod, "probe_hosts",
                        lambda hosts, **kw: {0: "10.0.0.9"})
    monkeypatch.setattr(probe_mod, "driver_candidate_addresses",
                        lambda: ["10.0.0.1", "127.0.0.1"])
    slots = [_slot(socket.gethostname(), 0, 2), _slot("remote-a", 1, 2)]
    assert launcher._probe_generation(slots) == {
        "remote-a": "10.0.0.9", socket.gethostname(): "10.0.0.1"}


def test_elastic_probe_skips_local_spawn(tmp_path):
    from horovod_tpu_torch.runner.elastic_run import ElasticLauncher
    launcher = ElasticLauncher(["true"], disc.FixedHosts({"h": 2}),
                               min_np=1, force_local_spawn=True,
                               state_dir=str(tmp_path))
    assert launcher._probe_generation([_slot("h", 0, 1)]) == {}


def test_elastic_probe_failure_counts_against_reset_limit(tmp_path):
    """A permanently unreachable host must not churn forever: probe
    failures trip --reset-limit like failed generations."""
    import subprocess
    from unittest import mock
    from horovod_tpu_torch.runner import probe as probe_mod
    from horovod_tpu_torch.runner.elastic_run import ElasticLauncher
    launcher = ElasticLauncher(["true"], disc.FixedHosts(
        {"unreachable-host": 1}), min_np=1, reset_limit=2,
        start_timeout=5.0, state_dir=str(tmp_path))
    calls = {"n": 0}

    def fail(hosts, **kw):
        calls["n"] += 1
        raise probe_mod.ProbeError("no route", failed_hosts=list(hosts))

    with mock.patch.object(probe_mod, "probe_hosts", fail), \
         mock.patch.object(disc._Cooldown, "BASE_SECONDS", 0.0), \
         mock.patch.object(disc._Cooldown, "MAX_SECONDS", 0.0), \
         mock.patch.object(subprocess, "Popen",
                           side_effect=AssertionError("must not spawn")):
        rc = launcher.run()
    assert rc == 1 and calls["n"] == 3


def test_elastic_launcher_mirror_lands_in_the_workers_store_view(
        tmp_path, monkeypatch):
    """A push that fails is mirrored into the generation's store under the
    key a worker reads through its default store (an ``env://`` client of
    the launcher's store, TORCHELASTIC_USE_AGENT_STORE=True, whose keys
    torch prefixes): ``kvstore.root_store`` of it."""
    import torch.distributed as dist
    from horovod_tpu_torch.runner.elastic_run import ElasticLauncher
    from horovod_tpu_torch.runner.launch import bind_store, rank_env
    from horovod_tpu_torch.utils.kvstore import root_store
    launcher = ElasticLauncher(["true"], disc.FixedHosts({}), min_np=1,
                               state_dir=str(tmp_path))
    launcher._store = bind_store()
    launcher._mirror_hosts_updated(7.0, disc.HostUpdateResult.REMOVED)
    for k, v in rank_env(0, 1, 0, 1, "127.0.0.1",
                         launcher._store.port).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TORCHELASTIC_USE_AGENT_STORE", "True")
    monkeypatch.setenv("TORCHELASTIC_RESTART_COUNT", "0")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method="env://")
    try:
        view = dist.distributed_c10d._get_default_store()
        assert not view.check(["hvd/elastic/hosts_updated"])  # prefixed
        raw = root_store(view).get("hvd/elastic/hosts_updated")
    finally:
        dist.destroy_process_group()
    msg = json.loads(raw)
    assert msg["timestamp"] == 7.0
    assert msg["res"] == disc.HostUpdateResult.REMOVED


def test_elastic_launcher_gives_each_local_worker_its_own_card(tmp_path,
                                                               monkeypatch):
    """Under --elastic-local every fake host's worker has LOCAL_RANK 0:
    each local worker gets CUDA_VISIBLE_DEVICES = its index among the
    generation's local workers (through the launcher's own
    CUDA_VISIBLE_DEVICES when set); none under --virtual."""
    from horovod_tpu_torch.runner.elastic_run import ElasticLauncher
    launcher = ElasticLauncher(["true"], disc.FixedHosts({}), min_np=1,
                               force_local_spawn=True,
                               state_dir=str(tmp_path))
    slots = [_slot(h, r, 3) for r, h in enumerate(["n0", "n1", "n3"])]
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert launcher._local_cards(slots) == {0: "0", 1: "1", 2: "2"}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert launcher._local_cards(slots) == {0: "4", 1: "5", 2: "6"}
    launcher.virtual = True
    assert launcher._local_cards(slots) == {}
