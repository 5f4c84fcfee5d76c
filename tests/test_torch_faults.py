"""The port's fault-domain runtime against the JAX package, on the CPU.

Replays the cases of ``tests/test_faults.py`` that need no unported
subsystem (the data service, the metrics server, the autotuner wait for
later slices): retry policies and their deterministic jitter, the retry
engine, ``RetryingKV`` semantics, the fault-domain state machine, the
chaos matrix's injection points and transient-fs retry on the checkpoint
commit path. Where both packages take the same input (a site and an
attempt, a chaos spec, a failing call) both run, and the backoff schedules
and injection patterns must be equal bit for bit.

The KV store under test is a real c10d store: a ``HashStore`` (the port's
world of one) behind a wrapper that scripts failures, and a two-client
``TCPStore`` (the multi-rank transport) for write-once, timeouts that are
not retried, ``kv_unavailable`` retried, and the checkpoint commit barrier
between two simulated ranks.

The whole module runs under a time limit of its own (``LIMIT_S``).
"""

import datetime
import errno
import signal
import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from horovod_tpu.resilience import chaos as jchaos
from horovod_tpu.resilience import faults as jfaults
from horovod_tpu.config import knobs as jknobs
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.resilience import chaos, faults
from horovod_tpu_torch.utils import schedhooks
from horovod_tpu_torch.utils.kvstore import (DistributedKV,
                                             KVDeadlineExceeded,
                                             distributed_kv)

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
def _fresh_fault_state():
    for mod in (faults, jfaults):
        mod.reset_for_tests()
    chaos.install(None)
    jchaos.install(None)
    yield
    for mod in (faults, jfaults):
        mod.reset_for_tests()
    chaos.install(None)
    jchaos.install(None)
    for reg in (knobs, jknobs):
        for name in list(reg.knobs()):
            if name.startswith("HOROVOD_FAULT"):
                reg.clear_override(name)


def fast_policy(site, mod=faults, **kw):
    base = dict(deadline_s=5.0, base_backoff_s=0.001, max_backoff_s=0.002,
                max_attempts=3, jitter=0.0, critical=True)
    base.update(kw)
    return mod.register_policy(mod.RetryPolicy(site=site, **base))


class FlakyStore:
    """A c10d HashStore whose first ``fail`` operations raise the store's
    network error (what a TCPStore whose server went away raises)."""

    def __init__(self, fail=0):
        self.inner = dist.HashStore()
        self.calls = 0
        self.fail = fail

    def _op(self, name, *args):
        self.calls += 1
        if self.calls <= self.fail:
            raise dist.DistNetworkError("Connection reset by peer")
        return getattr(self.inner, name)(*args)

    def set(self, key, value):
        return self._op("set", key, value)

    def get(self, key):
        return self._op("get", key)

    def compare_set(self, key, expected, desired):
        return self._op("compare_set", key, expected, desired)

    def check(self, keys):
        return self._op("check", keys)

    def wait(self, keys, timeout):
        return self._op("wait", keys, timeout)

    def delete_key(self, key):
        return self._op("delete_key", key)


def rkv(store, site="t", **kw):
    fast_policy(site, **kw)
    return faults.RetryingKV(DistributedKV(store), site=site)


class _RecordingHooks(schedhooks.SchedulerHooks):
    """Production hooks that record every backoff sleep."""

    def __init__(self):
        self.sleeps = []

    def sleep(self, seconds):
        self.sleeps.append(seconds)


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

class TestRetryPolicy:
    def test_backoff_caps_and_grows(self):
        p = faults.RetryPolicy(site="s", deadline_s=60, base_backoff_s=0.1,
                               max_backoff_s=0.5, jitter=0.0)
        assert p.backoff_s(0) == pytest.approx(0.1)
        assert p.backoff_s(1) == pytest.approx(0.2)
        assert p.backoff_s(10) == pytest.approx(0.5)

    @pytest.mark.parametrize("site", ["checkpoint_commit", "preemption",
                                      "straggler", "metrics", "x"])
    def test_jitter_schedule_is_the_jax_schedule_bit_for_bit(self, site):
        kw = dict(site=site, deadline_s=60, base_backoff_s=0.05,
                  max_backoff_s=1.0, jitter=0.25)
        p, j = faults.RetryPolicy(**kw), jfaults.RetryPolicy(**kw)
        got = [p.backoff_s(a) for a in range(12)]
        assert got == [j.backoff_s(a) for a in range(12)]
        assert all(0.75 * min(0.05 * 2 ** a, 1.0) <= g
                   <= min(0.05 * 2 ** a, 1.0) for a, g in enumerate(got))

    def test_jitter_is_deterministic_and_decorrelates_sites(self):
        p = faults.RetryPolicy(site="s", deadline_s=60, base_backoff_s=1.0,
                               max_backoff_s=1.0, jitter=0.25)
        q = faults.RetryPolicy(site="other", deadline_s=60,
                               base_backoff_s=1.0, max_backoff_s=1.0,
                               jitter=0.25)
        assert p.backoff_s(3) == p.backoff_s(3) != q.backoff_s(3)

    def test_defaults_come_from_knobs_as_in_jax(self):
        for reg in (knobs, jknobs):
            reg.set_override("HOROVOD_FAULT_RETRY_DEADLINE", 7.5)
            reg.set_override("HOROVOD_FAULT_RETRIES", 9)
        got = []
        for mod in (faults, jfaults):
            mod.reset_for_tests()
            got.append([mod.policy_for(s) for s in
                        ("checkpoint_commit", "metrics", "straggler")])
        assert [p.__dict__ for p in got[0]] == [p.__dict__ for p in got[1]]
        crit, opt, strag = got[0]
        assert crit.deadline_s == 7.5 and crit.max_attempts == 9
        assert crit.critical and not opt.critical and not strag.critical

    def test_env_policy_overrides(self):
        knobs.set_override(
            "HOROVOD_FAULT_POLICIES",
            '{"straggler": {"deadline_s": 1.25, "max_attempts": 2}}')
        faults.reset_for_tests()
        p = faults.policy_for("straggler")
        assert p.deadline_s == 1.25 and p.max_attempts == 2
        assert not p.critical

    def test_register_policy_wins(self):
        fast_policy("x", deadline_s=42.0)
        assert faults.policy_for("x").deadline_s == 42.0

    def test_site_catalog_is_the_jax_catalog(self):
        assert faults.KV_CONSUMER_SITES == jfaults.KV_CONSUMER_SITES
        assert faults.SHEDDABLE_SITES == jfaults.SHEDDABLE_SITES
        for site in faults.KV_CONSUMER_SITES:
            assert faults.policy_for(site).site == site
        assert faults.registered_sites() == jfaults.registered_sites()


# ---------------------------------------------------------------------------
# retry_call / retry_fs
# ---------------------------------------------------------------------------

class TestRetryCall:
    def test_retries_transient_until_success(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionResetError("reset")
            return "ok"

        fast_policy("t", max_attempts=5)
        assert faults.retry_call("t", flaky) == "ok"
        assert len(calls) == 3

    def test_retry_delay_schedule_equals_jax(self):
        """The sleeps of a failing call, through each package's seam, are
        the same floats."""
        from horovod_tpu.utils import schedhooks as jschedhooks
        schedules = []
        for mod, hooks_mod in ((faults, schedhooks), (jfaults, jschedhooks)):
            rec = _RecordingHooks() if mod is faults else type(
                "R", (jschedhooks.SchedulerHooks,),
                {"sleep": lambda self, s: self.sleeps.append(s)})()
            rec.sleeps = []
            prev = hooks_mod.install(rec)
            try:
                mod.register_policy(mod.RetryPolicy(
                    site="sched", deadline_s=1e6, base_backoff_s=0.01,
                    max_backoff_s=0.3, max_attempts=8, jitter=0.3))
                with pytest.raises(mod.RetryBudgetExhausted):
                    mod.retry_call("sched", lambda: (_ for _ in ()).throw(
                        ConnectionError("UNAVAILABLE")))
            finally:
                hooks_mod.install(prev)
            schedules.append(rec.sleeps)
        assert len(schedules[0]) == 7 and schedules[0] == schedules[1]

    def test_non_transient_propagates_immediately(self):
        calls = []

        def bad():
            calls.append(1)
            raise ValueError("ALREADY_EXISTS: k")

        fast_policy("t")
        with pytest.raises(ValueError):
            faults.retry_call("t", bad)
        assert len(calls) == 1

    def test_exhaustion_raises_with_cause(self):
        fast_policy("t", max_attempts=2)
        with pytest.raises(faults.RetryBudgetExhausted) as ei:
            faults.retry_call("t", lambda: (_ for _ in ()).throw(
                ConnectionError("UNAVAILABLE")))
        assert ei.value.site == "t" and ei.value.attempts == 2
        assert isinstance(ei.value.__cause__, ConnectionError)

    def test_deadline_budget_bounds_total_wait(self):
        fast_policy("t", deadline_s=0.02, base_backoff_s=0.5,
                    max_backoff_s=0.5, max_attempts=100)
        t0 = time.monotonic()
        with pytest.raises(faults.RetryBudgetExhausted):
            faults.retry_call("t", lambda: (_ for _ in ()).throw(
                ConnectionError("UNAVAILABLE")))
        assert time.monotonic() - t0 < 0.4

    def test_retry_fs_retries_eio_not_enospc(self):
        fast_policy("fs", max_attempts=4)
        calls = []

        def eio_then_ok():
            calls.append(1)
            if len(calls) < 2:
                raise OSError(errno.EIO, "io error")
            return "done"

        assert faults.retry_fs("fs", eio_then_ok) == "done"
        with pytest.raises(OSError) as ei:
            faults.retry_fs("fs", lambda: (_ for _ in ()).throw(
                OSError(errno.ENOSPC, "disk full")))
        assert ei.value.errno == errno.ENOSPC

    @pytest.mark.parametrize("exc,transient", [
        (ConnectionResetError("reset"), True),
        (OSError(errno.EIO, "io"), True),
        (OSError(errno.ENOSPC, "full"), False),
        (RuntimeError("UNAVAILABLE: down"), True),
        (RuntimeError("NOT_FOUND: k"), False),
        (RuntimeError("DEADLINE_EXCEEDED: k"), False),
        (KVDeadlineExceeded("DEADLINE_EXCEEDED: k"), False),
        (ValueError("ALREADY_EXISTS: k"), False)])
    def test_transient_classification_matches_jax(self, exc, transient):
        assert faults.is_transient(exc) is transient
        assert jfaults.is_transient(exc) is transient


# ---------------------------------------------------------------------------
# RetryingKV over a c10d store
# ---------------------------------------------------------------------------

class TestRetryingKV:
    def test_set_retries_transient(self):
        kv = rkv(FlakyStore(fail=2))
        kv.set("a", "1")
        assert kv.get("a", 1.0) == "1"

    def test_already_exists_propagates_and_overwrite_works(self):
        kv = rkv(FlakyStore())
        kv.set("a", "1")
        kv.set("a", "1")                    # the value it holds: a no-op
        with pytest.raises(ValueError, match="ALREADY_EXISTS"):
            kv.set("a", "2")
        kv.set("a", "2", overwrite=True)
        assert kv.get("a", 1.0) == "2"

    def test_blocking_get_timeout_propagates_unretried(self):
        store = FlakyStore()
        kv = rkv(store)
        t0 = time.monotonic()
        with pytest.raises(KVDeadlineExceeded, match="DEADLINE_EXCEEDED"):
            kv.get("missing", 0.05)
        assert store.calls == 1 and time.monotonic() - t0 < 1.0

    def test_try_get_not_found_is_none_and_transient_retried(self):
        kv = rkv(FlakyStore(fail=1))
        assert kv.try_get("missing") is None
        kv.set("k", "v")
        assert kv.try_get("k") == "v"

    def test_delete_stays_best_effort_but_counted(self):
        from horovod_tpu_torch import metrics as M
        kv = rkv(FlakyStore(fail=10 ** 6))
        kv.delete("hvd/divcheck/g0/p1")
        kv.delete("hvd/divcheck/g0/p2")
        snap = M.metrics_snapshot()["hvd_kvstore_delete_failures_total"]
        vals = {s["labels"]["key_class"]: s["value"]
                for s in snap["series"]}
        assert vals.get("hvd/divcheck/g0", 0) >= 2
        good = rkv(FlakyStore())
        good.set("k", "v")
        good.delete("k")
        assert good.try_get("k") is None

    def test_distributed_kv_wraps_injected_store_and_needs_peers(self):
        class Hooks(schedhooks.SchedulerHooks):
            def __init__(self, store):
                self._store = store

            def kv_client(self):
                return self._store

        assert distributed_kv(site="preemption") is None   # no world
        store = dist.HashStore()
        prev = schedhooks.install(Hooks(store))
        try:
            kv = distributed_kv(site="preemption")
            assert isinstance(kv, faults.RetryingKV)
            assert kv.site == "preemption"
            kv.set("k", "v")
            assert store.get("k") == b"v"
        finally:
            schedhooks.install(prev)


# ---------------------------------------------------------------------------
# the KV store over a two-client TCPStore
# ---------------------------------------------------------------------------

@pytest.fixture()
def tcp_pair():
    """Rank 0's TCPStore (the server) and rank 1's client on it."""
    timeout = datetime.timedelta(seconds=10)
    master = dist.TCPStore("localhost", 0, 2, True, timeout=timeout,
                           wait_for_workers=False)
    client = dist.TCPStore("localhost", master.port, 2, False,
                           timeout=timeout)
    yield master, client


class TestTCPStore:
    def test_write_once_across_ranks(self, tcp_pair):
        a, b = (rkv(s, site="preemption") for s in tcp_pair)
        a.set("hvd_preempt/stop_step/0", "7")
        with pytest.raises(ValueError, match="ALREADY_EXISTS"):
            b.set("hvd_preempt/stop_step/0", "9")
        assert b.get("hvd_preempt/stop_step/0", 1.0) == "7"

    def test_timeout_is_not_retried(self, tcp_pair):
        _, client = tcp_pair
        fast_policy("checkpoint_commit", max_attempts=5)
        kv = faults.RetryingKV(DistributedKV(client),
                               site="checkpoint_commit")
        t0 = time.monotonic()
        with pytest.raises(KVDeadlineExceeded):
            kv.get("never/set", 0.2)
        assert time.monotonic() - t0 < 1.0          # one wait, not five
        assert faults.fault_domain().snapshot()["exhausted_budgets"] == {}

    def test_kv_unavailable_is_retried(self, tcp_pair):
        master, client = tcp_pair
        chaos.install({"kv_unavailable": {"count": 2}})
        kv = rkv(client, site="t", max_attempts=5)
        kv.set("k", "v")
        assert DistributedKV(master).get("k", 1.0) == "v"

    def test_commit_barrier_between_two_ranks(self, tcp_pair, tmp_path):
        """Two ranks (threads, each its own store client and identity)
        save the same step: each writes its shard, rank 0 commits once
        both digests are in; a rank that never shows up times rank 0's
        barrier out and the attempt is abandoned uncommitted."""
        from horovod_tpu_torch.resilience import async_checkpoint as ac
        tls = threading.local()

        class Hooks(schedhooks.SchedulerHooks):
            def kv_client(self):
                return tls.store

            def world(self):
                return tls.world

        def rank(r, store, steps, errors):
            tls.store, tls.world = store, (r, 2)
            ck = ac.AsyncCheckpointer(str(tmp_path), interval=0,
                                      commit_timeout=1.0)
            try:
                for s in steps:
                    state = {"w": np.full(3, float(s)), "r": r}
                    try:
                        ck.save(s, state, sync=True)
                    except ac.CheckpointCommitError as e:
                        errors.append((r, s, str(e)))
            finally:
                ck.close()

        # the writer thread takes the identity of the rank that made it
        real_init = ac.AsyncCheckpointer.__init__
        real_worker_loop = ac.AsyncCheckpointer._worker_loop

        def init(self, *a, **kw):
            self._rank_tls = (tls.store, tls.world)
            real_init(self, *a, **kw)

        def worker_loop(self):
            tls.store, tls.world = self._rank_tls
            real_worker_loop(self)

        prev = schedhooks.install(Hooks())
        ac.AsyncCheckpointer.__init__ = init
        ac.AsyncCheckpointer._worker_loop = worker_loop
        try:
            errors = []
            ts = [threading.Thread(target=rank,
                                   args=(r, s, [2], errors))
                  for r, s in enumerate(tcp_pair)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
            assert not errors
            m = ac.read_manifest(str(tmp_path / ac.step_dirname(2)))
            assert m["shards"] == 2 and len(set(m["shard_digests"])) == 2
            assert m["layout"] == "rank0" and m["per_rank_leaves"] == 0
            assert m["world_size"] == 2
            # rank 1 never shows up for step 4: abandoned, step 2 stays
            rank(0, tcp_pair[0], [4], errors)
            assert len(errors) == 1 and "rank 1 did not write" in \
                errors[0][2]
            assert ac.list_committed_steps(str(tmp_path)) == [2]
        finally:
            ac.AsyncCheckpointer.__init__ = real_init
            ac.AsyncCheckpointer._worker_loop = real_worker_loop
            schedhooks.install(prev)


    def test_commit_barrier_waits_on_its_own_connection(self, tcp_pair,
                                                        tmp_path):
        """Rank 1's writer waits in the commit barrier for a commit that
        never comes, on a clone of the store: a c10d client runs one
        operation at a time, and the step path's calls on the store (the
        preemption poll) must not queue behind that wait."""
        from horovod_tpu_torch.resilience import async_checkpoint as ac
        from horovod_tpu_torch.utils import kvstore
        _, client = tcp_pair

        class Hooks(schedhooks.SchedulerHooks):
            def kv_client(self):
                return client

            def world(self):
                return (1, 2)

        prev = schedhooks.install(Hooks())
        try:
            ck = ac.AsyncCheckpointer(str(tmp_path), interval=0,
                                      commit_timeout=3.0)
            try:
                ck.save(2, {"w": np.ones(3)})
                time.sleep(0.5)              # the writer is in its wait
                kv = kvstore.distributed_kv(site="preemption")
                t0 = time.monotonic()
                assert kv.try_get("hvd_preempt/stop_step/0") is None
                assert time.monotonic() - t0 < 0.5
            finally:
                ck.close()
            assert ac.list_committed_steps(str(tmp_path)) == []
        finally:
            schedhooks.install(prev)


# ---------------------------------------------------------------------------
# the fault domain
# ---------------------------------------------------------------------------

class TestFaultDomain:
    def _exhaust(self, site, critical, mod=faults):
        fast_policy(site, mod=mod, max_attempts=1, critical=critical)
        with pytest.raises(mod.RetryBudgetExhausted):
            mod.retry_call(site, lambda: (_ for _ in ()).throw(
                ConnectionError("UNAVAILABLE")))

    def test_optional_exhaustion_degrades_and_sheds_as_in_jax(self):
        views = []
        for mod in (faults, jfaults):
            self._exhaust("metrics", critical=False, mod=mod)
            dom = mod.fault_domain()
            views.append((dom.state(), dom.shed_sites(),
                          mod.should_shed("metrics"),
                          mod.should_shed("straggler"),
                          dom.snapshot()["exhausted_budgets"],
                          dom.retry_summary()))
        assert views[0] == views[1]
        assert views[0][:4] == (faults.DEGRADED, ["metrics"], True, False)

    def test_critical_exhaustion_does_not_shed(self):
        self._exhaust("checkpoint_commit", critical=True)
        dom = faults.fault_domain()
        assert dom.state() == faults.HEALTHY and dom.shed_sites() == []
        assert dom.snapshot()["exhausted_budgets"] == {
            "checkpoint_commit": 1}

    def test_probe_after_interval_then_success_heals(self):
        self._exhaust("metrics", critical=False)
        knobs.set_override("HOROVOD_FAULT_PROBE_SECONDS", 0.0)
        assert not faults.should_shed("metrics")
        faults.retry_call("metrics", lambda: "ok")
        dom = faults.fault_domain()
        assert dom.state() == faults.HEALTHY and dom.shed_sites() == []

    def test_draining_outranks_degraded(self):
        from horovod_tpu_torch.resilience.preemption import PreemptionHandler
        self._exhaust("metrics", critical=False)
        handler = PreemptionHandler(checkpointer=None, sentinel="",
                                    install_signals=False)
        try:
            handler.request("maintenance")
            assert faults.fault_domain().state() == faults.DRAINING
        finally:
            handler.close()

    def test_straggler_exchange_sheds(self):
        from horovod_tpu_torch.tracing.straggler import StragglerDetector
        self._exhaust("straggler", critical=False)

        class NeverKV:
            def set(self, *a, **k):
                raise AssertionError("shed site must not touch transport")

            def try_get(self, k):
                raise AssertionError("shed site must not touch transport")

        det = StragglerDetector(NeverKV(), 0, 2, window=4, publish_every=1)
        det.observe_step(0.1)
        assert det.snapshot()["skew_seconds"] == 0.0


# ---------------------------------------------------------------------------
# the chaos matrix
# ---------------------------------------------------------------------------

class _JaxFakeClient:
    """The JAX wrapper's client (the coordination-service API)."""

    def __init__(self):
        self.store = {}

    def key_value_set(self, key, value, allow_overwrite=False):
        self.store[key] = value

    def blocking_key_value_get(self, key, timeout_ms):
        return self.store[key]

    def key_value_try_get(self, key):
        return self.store[key]

    def key_value_delete(self, key):
        self.store.pop(key, None)


class TestChaosMatrix:
    def test_kv_unavailable_count_then_recovers_via_retry(self):
        chaos.install({"kv_unavailable": {"count": 2}})
        kv = rkv(FlakyStore(), site="t", max_attempts=5)
        kv.set("k", "v")
        assert kv.get("k", 1.0) == "v"

    def test_kv_unavailable_probabilistic_pattern_equals_jax(self):
        from horovod_tpu.utils.kvstore import DistributedKV as JKV

        def run(mod, raw):
            mod.install({"kv_unavailable": {"p": 0.5, "seed": 11}})
            out = []
            for i in range(40):
                try:
                    raw.set(f"k{i}", "v", overwrite=True)
                    out.append("ok")
                except ConnectionError:
                    out.append("fail")
            return out

        a = run(chaos, DistributedKV(FlakyStore()))
        b = run(chaos, DistributedKV(FlakyStore()))
        j = run(jchaos, JKV(_JaxFakeClient()))
        assert a == b == j and "fail" in a and "ok" in a

    def test_kv_slow_injects_latency(self):
        chaos.install({"kv_slow": {"delay": 0.05}})
        raw = DistributedKV(FlakyStore())
        t0 = time.monotonic()
        raw.set("k", "v")
        assert time.monotonic() - t0 >= 0.05

    def test_net_partition_scopes_to_host_set(self):
        chaos.install({"net_partition": {"hosts": [3]}})
        raw = DistributedKV(FlakyStore())
        raw.set("k", "v")
        chaos.install({"net_partition": {"hosts": [0]}})
        with pytest.raises(ConnectionError, match="net_partition"):
            raw.set("k2", "v")

    def test_window_gates_by_elapsed_time(self):
        chaos.install({"kv_unavailable": {"window": [10.0, 20.0]}})
        raw = DistributedKV(FlakyStore())
        raw.set("k", "v")

    def test_clock_skew_scoped(self):
        chaos.install({"clock_skew": {"offset": 2.5}})
        assert chaos.clock_skew_s() == 2.5
        chaos.install({"clock_skew": {"offset": 2.5, "hosts": [7]}})
        assert chaos.clock_skew_s() == 0.0

    def test_unported_subsystem_hooks_behave_as_in_jax(self):
        spec = {"data_worker_kill": {"worker": 1, "after_batches": 2},
                "replica_kill": {"replica": 0, "after_requests": 1},
                "replica_slow": {"replica": 2, "delay": 0.3},
                "store_corrupt": {"fail_first": 1},
                "host_loss": {"host": 1, "at_step": 4}}
        got = []
        for mod in (chaos, jchaos):
            mod.install(spec)
            got.append((mod.on_data_request(1, 1), mod.on_data_request(1, 2),
                        mod.on_replica_dispatch(0, 1),
                        mod.replica_slow_s(2, 0), mod.on_store_load("p"),
                        mod.on_store_load("p"), mod.resize_notice(3),
                        mod.resize_notice(4), mod.resize_notice(5)))
        assert got[0] == got[1]
        assert got[0][-2] == {"kind": "host_loss", "host": 1}

    def test_fs_transient_absorbed_by_checkpoint_commit(self, tmp_path):
        from horovod_tpu_torch.resilience.async_checkpoint import (
            AsyncCheckpointer, list_committed_steps)
        fast_policy("checkpoint_fs", max_attempts=5)
        chaos.install({"fs_transient": {"fail_first": 2}})
        ckpt = AsyncCheckpointer(str(tmp_path), interval=1)
        ckpt.save(1, {"w": 1.0}, sync=True)
        ckpt.close()
        assert list_committed_steps(str(tmp_path)) == [1]

    def test_fs_transient_beyond_budget_abandons_commit(self, tmp_path):
        from horovod_tpu_torch.resilience.async_checkpoint import (
            AsyncCheckpointer, CheckpointWriteError, list_committed_steps)
        fast_policy("checkpoint_fs", max_attempts=2)
        chaos.install({"fs_transient": {"fail_first": 50}})
        ckpt = AsyncCheckpointer(str(tmp_path), interval=1)
        with pytest.raises(CheckpointWriteError):
            ckpt.save(1, {"w": 1.0}, sync=True)
        assert ckpt.maybe_save(2, {"w": 1.0})      # raised once, then on
        with pytest.raises(CheckpointWriteError):
            ckpt.wait()                            # the next write failed
        ckpt.close()
        assert list_committed_steps(str(tmp_path)) == []
