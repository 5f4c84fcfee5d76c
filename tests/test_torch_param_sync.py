"""The tuner across ranks: ``autotune.ParameterSynchronizer`` over the c10d
store in a two-rank gloo world, against the JAX package's protocol.

The JAX counterparts are ``tests/test_coordinator.py:662-744`` (the
leader tunes and the follower applies, the generation prefix) and
``tests/test_faults.py:340-400`` (the shed freeze, the publish-failure
freeze); ``tests/test_bucket_auto.py``'s broadcast case is the
``broadcast`` drill. The JAX package runs the protocol over an in-memory
KV double in one process; here the same protocol runs in one gloo world
(``test_torch_workers`` scenario kind ``autotune``), started once for the
module, and the in-process cases run on both packages side by side.

The whole module runs under a time limit of its own (``LIMIT_S``).
"""

import json
import signal
import threading

import numpy as np
import pytest

from horovod_tpu import autotune as jautotune
from horovod_tpu.config import knobs as jknobs
from horovod_tpu.resilience import faults as jfaults
from horovod_tpu_torch import autotune
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.resilience import faults
import test_torch_workers as workers

LIMIT_S = 120
MIB = 1 << 20
TUNE_STEPS = 6
TUNE_KNOBS = {"HOROVOD_AUTOTUNE": True,
              "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": 0,
              "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": 1,
              "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": 3}
LEAVES = [((64, 32), "float32"), ((32,), "float32")]


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
def _clean_registries():
    for reg in (knobs, jknobs):
        reg.clear_all_overrides()
    for mod in (faults, jfaults):
        mod.reset_for_tests()
    yield
    for reg in (knobs, jknobs):
        reg.clear_all_overrides()
    for mod in (faults, jfaults):
        mod.reset_for_tests()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("param_sync")
    caches = [str(out / f"cache{r}.json") for r in range(2)]
    phases = [
        {"knobs": {**TUNE_KNOBS,
                   "HOROVOD_AUTOTUNE_LOG": str(out / "tune.csv")},
         "scenarios": [{"kind": "autotune", "name": "tune", "drill": "tune",
                        "steps": TUNE_STEPS}]},
        {"knobs": {"HOROVOD_AUTOTUNE": True}, "init": {"mesh_shape": (2, 1)},
         "scenarios": [{"kind": "autotune", "name": "dims",
                        "drill": "dims"}]},
        {"scenarios": [
            {"kind": "autotune", "name": "prefix", "drill": "prefix"},
            {"kind": "autotune", "name": "shed", "drill": "shed",
             "prefix": "t/shed"},
            {"kind": "autotune", "name": "timeout", "drill": "timeout",
             "prefix": "t/timeout", "timeout_s": 2.0},
            {"kind": "autotune", "name": "broadcast", "drill": "broadcast",
             "sig": "sig/n2", "local": [50 * MIB, 25 * MIB],
             "caches": caches, "leaves": LEAVES, "cached": 16 * MIB}]}]
    load = workers.run_phases(2, phases, out)
    load.log = out / "tune.csv"
    return load


def _both(world, name):
    return [world(name, r) for r in range(2)]


# ---------------------------------------------------------------------------
# the two-rank world
# ---------------------------------------------------------------------------

def test_leader_tunes_and_follower_applies(world):
    """tests/test_coordinator.py::test_autotune_synchronizes_across_
    controllers, over the c10d store: the same (cycle, knobs) trajectory
    on both ranks, converged after three samples, then both quiet."""
    lead, fol = _both(world, "tune")
    assert str(lead["history"]) == str(fol["history"])
    history = json.loads(str(lead["history"]))
    assert [c for c, _ in history] == [1, 2, 3]
    assert bool(lead["is_leader"]) and not bool(fol["is_leader"])
    assert bool(lead["tuning"]) and not bool(fol["tuning"])
    assert bool(lead["converged"]) and int(lead["samples"]) == 3
    assert bool(lead["done"]) and bool(fol["done"])
    assert str(lead["knobs"]) == str(fol["knobs"])
    assert json.loads(str(lead["knobs"])) == history[-1][1]
    want = np.stack([np.full(4, 2.0 * s + 1) for s in range(TUNE_STEPS)])
    for r in (lead, fol):
        np.testing.assert_array_equal(r["sums"], want)
    # one log path for both ranks: only the leader writes (and opens) it
    rows = world.log.read_text().strip().splitlines()
    assert [int(r.split(",")[0]) for r in rows] == [0, 1, 2]


def test_generation_prefix_is_fresh_and_the_same_on_every_rank(world):
    """tests/test_coordinator.py::test_param_sync_generation_prefix_avoids_
    stale_keys: each synchronizer takes the next generation, the same on
    every rank (the coordinators of the tuned phases took g0 and g1)."""
    ranks = [list(r["prefixes"]) for r in _both(world, "prefix")]
    assert ranks[0] == ranks[1]
    assert str(world("tune", 0)["prefix"]) == "hvd/autotune/g0"
    assert ranks[0] == ["hvd/autotune/g2", "hvd/autotune/g3"]


def test_tuner_gains_the_cross_dimension_on_a_hierarchical_mesh(world):
    """tests/test_coordinator.py::test_autotune_gains_cross_dim_on_
    hierarchical: on a (2, 1) mesh the coordinator's tuner has the
    cross-axis threshold as a third continuous dimension, as JAX's."""
    for r in _both(world, "dims"):
        assert bool(r["hierarchical"])
        assert [str(n) for n in r["continuous"]] == [
            d[0] for d in jautotune.continuous_dims(True)]
        assert int(r["dims"]) == len(autotune.continuous_dims(True)) + 2


def test_shed_site_freezes_by_publishing_final(world):
    """tests/test_faults.py::test_autotune_shed_freezes_by_publishing_final
    across two ranks: the shed leader publishes a final marker at its
    snapshot and freezes; the follower, not shed, lands on the same
    values and stops applying."""
    lead, fol = _both(world, "shed")
    assert bool(lead["shed"]) and not bool(fol["shed"])
    assert bool(lead["done"]) and bool(lead["frozen"])
    assert bool(fol["done"]) and not bool(fol["frozen"])
    assert float(fol["cycle_time"]) == 7.5
    assert str(lead["history"]) == str(fol["history"])


def test_follower_of_a_dead_leader_raises_not_hangs(world):
    """A leader that never publishes surfaces on the follower as the
    descriptive RuntimeError after its timeout."""
    fol = world("timeout", 1)
    assert "leader (rank 0) never published knob values for cycle 1" in \
        str(fol["error"])
    assert 2.0 <= float(fol["seconds"]) < 20.0


def test_broadcast_resolution_leader_wins(world):
    """Rank 0's bucket resolution is every rank's: the broadcast adopts
    rank 0's value, and under 'auto' rank 1, whose cache misses, resolves
    rank 0's cached winner (with its one miss warning)."""
    lead, fol = _both(world, "broadcast")
    assert int(lead["adopted"]) == int(fol["adopted"]) == 50 * MIB
    assert int(lead["resolved"]) == int(fol["resolved"]) == 16 * MIB
    assert int(lead["missed"]) == 0 and int(fol["missed"]) == 1


# ---------------------------------------------------------------------------
# in process, both packages
# ---------------------------------------------------------------------------

class _MemKV:
    """tests/test_coordinator.py's in-memory KV double, write-once."""

    def __init__(self):
        self._d = {}
        self._cv = threading.Condition()

    def set(self, key, value, overwrite=False):
        with self._cv:
            if key in self._d and not overwrite:
                raise ValueError(f"ALREADY_EXISTS: {key}")
            self._d[key] = value
            self._cv.notify_all()

    def get(self, key, timeout_s):
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._d,
                                     timeout=timeout_s):
                raise TimeoutError(key)
            return self._d[key]


def _protocol(mod, reg):
    """A leader publishing three cycles (the last converged) and a
    follower applying them; returns both histories and the KV's
    payloads."""
    kv = _MemKV()
    lead = mod.ParameterSynchronizer(kv, leader=True, prefix="p")
    fol = mod.ParameterSynchronizer(kv, leader=False, prefix="p")
    for cycle, ms in ((1, 5.0), (2, 42.0), (3, 7.0)):
        reg.set_override("HOROVOD_CYCLE_TIME", ms)
        reg.set_override("HOROVOD_FUSION_THRESHOLD", cycle * MIB)
        lead.publish(cycle, converged=cycle == 3)
    reg.clear_all_overrides()
    for cycle in (1, 2, 3, 4):
        fol.apply(cycle)                   # 4: done, fetches nothing
    return (lead.history, fol.history,
            {k: json.loads(v) for k, v in kv._d.items()}, fol.done)


def test_protocol_payloads_equal_jax():
    """The same publications give the same payloads, histories and final
    marker in both packages (the tunable snapshot of each registry)."""
    got = _protocol(autotune, knobs)
    want = _protocol(jautotune, jknobs)
    assert got == want
    assert got[0] == got[1] and got[3]


@pytest.mark.parametrize("exc,raises", [
    (ConnectionError("UNAVAILABLE"), False),
    (ValueError("ALREADY_EXISTS: hvd/autotune/g0/1"), True)])
def test_publish_failure_freezes_or_raises_as_jax(exc, raises):
    """tests/test_faults.py::test_autotune_publish_failure_freezes_loudly_
    not_raises: a transport failure freezes the leader; a semantic error
    propagates."""
    class DeadKV:
        def set(self, *a, **k):
            raise exc

    for mod in (autotune, jautotune):
        leader = mod.ParameterSynchronizer(DeadKV(), leader=True, prefix="t")
        if raises:
            with pytest.raises(ValueError, match="ALREADY_EXISTS"):
                leader.publish(1, converged=False)
            assert not leader.done
        else:
            leader.publish(1, converged=False)
            assert leader.done and leader.frozen


def test_broadcast_timeout_keeps_the_local_value():
    """tests/test_bucket_auto.py::test_broadcast_resolution_leader_wins_and_
    timeout_keeps_local, on both packages: a follower that cannot fetch
    keeps its own value; the leader republishes by overwriting."""
    for mod in (autotune, jautotune):
        kv = _MemKV()
        assert mod._broadcast_resolution("s/n8", 50 * MIB, kv=kv,
                                         leader=True) == 50 * MIB
        assert mod._broadcast_resolution("s/n8", 16 * MIB, kv=kv,
                                         leader=True) == 16 * MIB
        kv.get = lambda key, timeout_s: (_ for _ in ()).throw(
            TimeoutError(key))
        assert mod._broadcast_resolution("o/n8", 25 * MIB, kv=kv,
                                         leader=False) == 25 * MIB
