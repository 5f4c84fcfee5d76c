"""The port's resilient training loop against the JAX package, on the CPU.

Each scenario of ``tests/test_resilience.py`` and ``tests/test_checkpoint.py``
that the port covers is replayed against ``horovod_tpu_torch``; where both
packages take the same input (a dict of numpy arrays and scalars, a chaos
spec, a cadence's measurements) both run and their results are compared:
the ``info`` dicts of ``train_loop``, the committed step lists and the
manifests (less ``wall_time``, and ``n_devices``, which is the JAX CPU
platform's 8 virtual devices against the port's one card per rank).

Trajectories (``train_loop`` preempted and resumed):

- the tiny flagship (d=64, 2 layers, f32) in a world of one: the resumed
  run equals its own uninterrupted run bitwise, and the JAX loop's resumed
  run within rtol/atol 1e-5 (the two frameworks sum in other orders; the
  tolerance of the training tests);
- the fused step at fp8_e4m3 with error feedback in a two-rank gloo world
  (a residual per rank): bitwise against its own uninterrupted run on
  every rank; against the JAX loop on a 2-device mesh with the rule of
  ``test_torch_grad_sync``'s fused fp8 test (the frameworks' f32 gradients
  differ in their last bits, so a value on an fp8 rounding boundary rounds
  the other way: at most 0.2% of a leaf's parameters differ by more than
  1e-6 of its largest value, all within 2e-4; the residual within 1e-5 on
  95% of each leaf);
- a small ResNet with running statistics through ``DistributedOptimizer``:
  bitwise against its own uninterrupted run, and the JAX loop within
  rtol/atol 1e-5;
- a chaos ``kill`` drill: a two-rank world loses rank 1 to SIGKILL at
  step 3 and is relaunched as the next incarnation, which resumes from the
  newest committed snapshot to the uninterrupted parameters, bitwise.

The whole module runs under a time limit of its own (``LIMIT_S``).
"""

import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.config import knobs as jknobs
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import trainer as jtrainer
from horovod_tpu.resilience import async_checkpoint as jac
from horovod_tpu.resilience import chaos as jchaos
from horovod_tpu.resilience import preemption as jpre
import horovod_tpu_torch as htt
from horovod_tpu_torch.callbacks import CheckpointCallback
from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                          restore_checkpoint,
                                          save_checkpoint)
from horovod_tpu_torch.resilience import (AsyncCheckpointer,
                                          CheckpointCadence,
                                          CheckpointMismatchError,
                                          PreemptionHandler, chaos,
                                          list_committed_steps,
                                          restore_latest)
from horovod_tpu_torch.resilience import async_checkpoint as ac
from horovod_tpu_torch.resilience.async_checkpoint import (MANIFEST_NAME,
                                                           step_dirname)
from horovod_tpu_torch.resilience.preemption import RESUMABLE_EXIT_CODE
from horovod_tpu_torch.utils import tree as tree_util
import test_torch_workers as workers

LIMIT_S = 300
TOL = dict(rtol=1e-5, atol=1e-5)
CFG_KW = dict(vocab_size=256, d_model=64, n_heads=4, head_dim=16,
              n_layers=2, d_ff=128, max_seq=256)
B, S = 4, 32


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
def _no_chaos():
    yield
    for mod in (chaos, jchaos):
        mod.install(None)
        mod._spec_loaded = False


def _no_time(manifest):
    return {k: v for k, v in manifest.items()
            if k not in ("wall_time", "n_devices")}


def test_port_and_chip_smoke_import_no_jax():
    """The resilience modules, the launchers (``runner.launch``,
    ``runner.elastic_run``, ``runner.interactive``) and ``elastic`` are
    part of the jax-free package (the package-wide import walk is
    test_torch_serving's), and chip_smoke.py imports neither jax nor the
    JAX package anywhere in its source."""
    import ast
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, horovod_tpu_torch as h\n"
            "import horovod_tpu_torch.checkpoint, horovod_tpu_torch.callbacks\n"
            "from horovod_tpu_torch.utils import kvstore\n"
            "import horovod_tpu_torch.runner.launch\n"
            "import horovod_tpu_torch.runner.elastic_run\n"
            "import horovod_tpu_torch.runner.interactive\n"
            "import horovod_tpu_torch.elastic\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'horovod_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tree = ast.parse(open(os.path.join(repo, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "horovod_tpu")]


# ---------------------------------------------------------------------------
# the commit protocol, against the JAX package on the same inputs
# ---------------------------------------------------------------------------

def test_async_roundtrip_and_manifest_match_jax(tmp_path):
    state = {"w": np.arange(6.0), "step": 7}
    manifests = []
    for pkg, Ck, d in ((ac, AsyncCheckpointer, tmp_path / "port"),
                       (jac, jac.AsyncCheckpointer, tmp_path / "jax")):
        with Ck(str(d), interval=0, fmt="pickle") as ck:
            ck.save(7, state, sync=True)
            assert ck.all_steps() == [7]
            step, back = ck.restore_latest()
            assert step == 7
            np.testing.assert_array_equal(np.asarray(back["w"]), state["w"])
            assert back["step"] == 7
        manifests.append(pkg.read_manifest(str(d / step_dirname(7))))
    port, jax_ = manifests
    assert port["committed"] and port["step"] == 7
    assert port["format"] == "pickle" and port["world_size"] == 1
    assert port["shards"] == 1 and port["shard_digests"][0]
    # the same pickle bytes: the digests agree too
    assert _no_time(port) == _no_time(jax_)


def test_templated_restore_writes_into_the_live_tensors(tmp_path):
    """The port's template is live: a restore copies into its tensors
    (the objects gradient hooks and bound residuals hold), loads module
    and optimizer state in place, and keeps scalars and numpy leaves."""
    w = torch.nn.Parameter(torch.arange(4.0))
    net = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD([w], lr=0.1, momentum=0.9)
    w.grad = torch.ones(4)
    opt.step()
    state = htt.TrainState(3, {"w": w, "net": net}, opt)
    with AsyncCheckpointer(str(tmp_path), interval=0) as ck:
        ck.save(3, state, sync=True)
        saved = (w.detach().clone(), net.weight.detach().clone(),
                 opt.state[w]["momentum_buffer"].clone())
        fresh_w = torch.nn.Parameter(torch.zeros(4))
        fresh_net = torch.nn.Linear(3, 2)
        fresh_opt = torch.optim.SGD([fresh_w], lr=0.1, momentum=0.9)
        template = htt.TrainState(0, {"w": fresh_w, "net": fresh_net},
                                  fresh_opt)
        step, back = ck.restore_latest(template=template)
    assert step == 3 and back.step == 3
    assert back.params["w"] is fresh_w and back.params["net"] is fresh_net
    assert back.opt_state is fresh_opt
    assert torch.equal(fresh_w.detach(), saved[0])
    assert torch.equal(fresh_net.weight.detach(), saved[1])
    assert torch.equal(fresh_opt.state[fresh_w]["momentum_buffer"],
                       saved[2])


def test_shards_round_trip_bf16_numpy_and_scalars_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    state = {"bf16": x.to(torch.bfloat16), "f32": x, "i64": torch.arange(9),
             "strided": x.t(), "empty": torch.zeros(0, 3),
             "np": rng.standard_normal(4), "np_bf": np.float16(1.5),
             "int": 3, "float": 0.1, "none": None, "str": "s",
             "nested": [torch.ones(2, dtype=torch.float16), (1, 2)]}
    with AsyncCheckpointer(str(tmp_path), interval=0) as ck:
        ck.save(1, state, sync=True)
        _, back = ck.restore_latest()
    for k in ("bf16", "f32", "i64", "strided", "empty"):
        assert back[k].dtype == state[k].dtype
        assert torch.equal(back[k], state[k]), k
    assert back["np"].tobytes() == state["np"].tobytes()
    assert back["np_bf"].dtype == np.float16 and back["np_bf"] == 1.5
    assert (back["int"], back["float"], back["none"], back["str"]) == (
        3, 0.1, None, "s")
    assert torch.equal(back["nested"][0], state["nested"][0])
    assert back["nested"][1] == (1, 2)


def test_restore_latest_skips_partial_and_uncommitted(tmp_path):
    results = []
    for pkg, d in ((ac, tmp_path / "port"), (jac, tmp_path / "jax")):
        d = str(d)
        with pkg.AsyncCheckpointer(d, interval=0, fmt="pickle") as ck:
            ck.save(3, {"w": np.ones(2)}, sync=True)
        os.makedirs(os.path.join(d, step_dirname(9)))
        os.makedirs(os.path.join(d, step_dirname(12)))
        with open(os.path.join(d, step_dirname(12), MANIFEST_NAME),
                  "w") as f:
            json.dump({"step": 12, "committed": False}, f)
        os.makedirs(os.path.join(d, step_dirname(15)))
        with open(os.path.join(d, step_dirname(15), MANIFEST_NAME),
                  "w") as f:
            f.write('{"step": 15, "comm')
        results.append((pkg.list_committed_steps(d),
                        pkg.restore_latest(d)[0]))
    assert results[0] == results[1] == ([3], 3)


def test_commit_deny_leaves_previous_snapshot_committed(tmp_path):
    """Crash-safe rotation: the newest committed checkpoint survives a
    denied successor, which stays an unrestorable tmp orphan until the
    next commit cleans it; the JAX package gives the same step lists."""
    seen = []
    for pkg, ch, d in ((ac, chaos, tmp_path / "port"),
                       (jac, jchaos, tmp_path / "jax")):
        d = str(d)
        with pkg.AsyncCheckpointer(d, interval=0, fmt="pickle",
                                   max_to_keep=1) as ck:
            ck.save(5, {"w": np.ones(2)}, sync=True)
            ch.install({"commit_deny": [9], "only_generation": 1})
            with pytest.raises(pkg.CheckpointCommitError):
                ck.save(9, {"w": np.zeros(2)}, sync=True)
            after_deny = ck.all_steps()
            step, back = ck.restore_latest()
            np.testing.assert_array_equal(np.asarray(back["w"]), [1, 1])
            ch.install(None)
            ck.save(11, {"w": np.full(2, 3.0)}, sync=True)
            seen.append((after_deny, step, ck.all_steps()))
        assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]
    assert seen[0] == seen[1] == ([5], 5, [11])


def test_rotation_keeps_newest_k_after_commit(tmp_path):
    got = []
    for pkg, d in ((ac, tmp_path / "port"), (jac, tmp_path / "jax")):
        with pkg.AsyncCheckpointer(str(d), interval=0, fmt="pickle",
                                   max_to_keep=2) as ck:
            for s in (1, 2, 3, 4):
                ck.save(s, {"w": np.full(2, float(s))}, sync=True)
            got.append(ck.all_steps())
    assert got[0] == got[1] == [3, 4]


def test_fingerprint_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    with AsyncCheckpointer(d, interval=0) as ck:
        ck.save(4, {"w": np.ones(2)}, sync=True)
    mpath = os.path.join(d, step_dirname(4), MANIFEST_NAME)
    manifest = json.load(open(mpath))
    manifest["world_size"] = 16
    manifest["shard_digests"] = ["a", "b"]      # per-rank shards differ
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(CheckpointMismatchError,
                       match="restore_checkpoint\\(template=...\\)"):
        restore_latest(d)


def test_world_mismatch_with_replicated_shards_restores_shard0(tmp_path):
    d = str(tmp_path / "ckpt")
    with AsyncCheckpointer(d, interval=0) as ck:
        ck.save(4, {"w": np.ones(2)}, sync=True)
    mpath = os.path.join(d, step_dirname(4), MANIFEST_NAME)
    manifest = json.load(open(mpath))
    manifest["world_size"] = 4
    json.dump(manifest, open(mpath, "w"))
    step, back = restore_latest(d)
    assert step == 4
    np.testing.assert_array_equal(back["w"], [1, 1])


def test_rank0_layout_fills_placeholders_and_guards_per_rank_leaves(
        tmp_path):
    """A several-rank snapshot keeps each replicated leaf once, in rank
    0's shard, and each per-rank leaf in its rank's shard: a rank's
    restore fills its placeholders from shard 0 and keeps its own
    residual. On another world a snapshot with per-rank leaves raises;
    one without restores from shard 0."""
    from horovod_tpu_torch.parallel.distributed import (
        DistributedApplyState, EpilogueOptState)

    def state(r):
        return htt.TrainState(
            5, {"w": torch.full((3,), 2.0)},
            DistributedApplyState(
                EpilogueOptState((), ({"w": torch.full((3,), 0.5)},)),
                {"w": torch.full((3,), float(r))}))

    host0 = ac.host_snapshot(state(0), owner=True)
    host1 = ac.host_snapshot(state(1), owner=False)
    assert host1.params["w"] is ac.ON_RANK0
    assert host1.opt_state.opt.slots[0]["w"] is ac.ON_RANK0
    merged = ac._merge_rank0(host1, host0)
    template = state(9)
    back = ac._place_tree(merged, template)
    assert back.params["w"] is template.params["w"]
    assert torch.equal(back.params["w"], torch.full((3,), 2.0))
    assert torch.equal(back.opt_state.opt.slots[0]["w"],
                       torch.full((3,), 0.5))
    assert torch.equal(back.opt_state.residual["w"], torch.ones(3))
    assert ac._count_per_rank(host0) == 1
    # the several-rank manifest on another world
    d = tmp_path / "ckpt" / step_dirname(5)
    os.makedirs(d)
    for r, h in ((0, host0), (1, host1)):
        with open(d / f"shard-{r:05d}.pkl", "wb") as f:
            for chunk in ac._serialize(h):
                f.write(chunk)
    manifest = {"step": 5, "format": "pickle", "committed": True,
                "shards": 2, "shard_digests": ["a", "b"], "world_size": 2,
                "n_devices": 2, "layout": "rank0", "per_rank_leaves": 1}
    (d / MANIFEST_NAME).write_text(json.dumps(manifest))
    with pytest.raises(CheckpointMismatchError, match="different topology"):
        restore_latest(str(tmp_path / "ckpt"))
    manifest["per_rank_leaves"] = 0
    (d / MANIFEST_NAME).write_text(json.dumps(manifest))
    step, back = restore_latest(str(tmp_path / "ckpt"))
    assert step == 5 and torch.equal(back.params["w"],
                                     torch.full((3,), 2.0))


def test_orbax_format_raises():
    with pytest.raises(ValueError, match="orbax"):
        AsyncCheckpointer("/nonexistent-unused", fmt="orbax")


def test_async_save_defers_while_inflight(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), interval=1, fmt="pickle")
    try:
        chaos.install({"commit_delay": {1: 0.5}, "only_generation": 1})
        assert ck.maybe_save(1, {"w": np.ones(2)})
        t0 = time.perf_counter()
        assert not ck.maybe_save(2, {"w": np.ones(2)})
        assert time.perf_counter() - t0 < 0.2
        ck.wait()
        assert ck.all_steps() == [1]
    finally:
        ck.close()


def test_save_waits_for_a_free_buffer_set(tmp_path):
    """Two snapshots in flight hold both buffer sets: a third save waits
    for the older write, so the snapshots held in memory stay at two."""
    ck = AsyncCheckpointer(str(tmp_path), interval=1, fmt="pickle")
    try:
        chaos.install({"commit_delay": {1: 0.6, 2: 0.6}})
        ck.save(1, {"w": np.ones(2)})
        ck.save(2, {"w": np.ones(2)})
        assert ck._pool.free_sets() == []
        t0 = time.perf_counter()
        ck.save(3, {"w": np.ones(2)})
        assert time.perf_counter() - t0 > 0.3
        ck.wait()
        assert ck.all_steps() == [1, 2, 3]
        assert len(ck._pool.free_sets()) == 2
    finally:
        chaos.install(None)
        ck.close()


# ---------------------------------------------------------------------------
# cadence: the formula, against the JAX package
# ---------------------------------------------------------------------------

def test_cadence_auto_formula_matches_jax():
    from horovod_tpu import metrics as JM
    from horovod_tpu.resilience import CheckpointCadence as JCadence
    from horovod_tpu_torch import metrics as M
    cads = [CheckpointCadence("auto", budget=0.05),
            JCadence("auto", budget=0.05)]
    for m in (M, JM):
        hist = m.histogram("hvd_step_duration_seconds",
                           "Wall time per training step")
        for _ in range(10):
            hist.observe(0.1)                   # mean step 100 ms
    intervals = []
    for cad in cads:
        cad.observe_snapshot_cost(0.02)         # 20 ms on-path snapshot
        first = cad.interval
        cad.observe_snapshot_cost(0.0)
        intervals.append((first, cad.interval))
    assert intervals[0] == intervals[1] == (4, 2)


def test_cadence_fixed_and_frozen():
    assert CheckpointCadence(25, budget=0.05).interval == 25
    cad = CheckpointCadence("auto", budget=0.05, frozen=True)
    start = cad.interval
    cad.observe_snapshot_cost(10.0)
    assert cad.interval == start


def test_async_checkpoint_overhead_under_budget(tmp_path):
    """Auto-cadence async checkpointing adds <5% to the StepStats mean
    step time (the JAX package's acceptance, same loop)."""
    from horovod_tpu_torch.callbacks import StepStats
    state = {"w": torch.zeros((128, 128)), "step": 0}

    def run_loop(ck):
        stats = StepStats()
        times = []
        stats.begin()
        for s in range(1, 41):
            time.sleep(0.01)
            times.append(stats.end()["step_time_s"])
            if ck is not None:
                ck.maybe_save(s, state)
        return float(np.mean(times))

    base = run_loop(None)
    ck = AsyncCheckpointer(str(tmp_path), interval="auto",
                           overhead_budget=0.05)
    try:
        with_ckpt = run_loop(ck)
    finally:
        ck.close()
    assert with_ckpt <= base * 1.05 + 0.001, (with_ckpt, base)


def test_failed_async_write_raises_at_the_next_call(tmp_path, monkeypatch):
    """A write that fails for another reason than the commit protocol's
    abandon is raised at the next maybe_save/wait, once; it is not only
    logged."""
    ck = AsyncCheckpointer(str(tmp_path), interval=1)
    try:
        real = ac._serialize

        def broken(host):
            raise OSError(28, "No space left on device")

        monkeypatch.setattr(ac, "_serialize", broken)
        assert ck.maybe_save(1, {"w": np.ones(2)})
        with pytest.raises(ac.CheckpointWriteError, match="No space"):
            ck.wait()
        ck.wait()                               # raised once
        monkeypatch.setattr(ac, "_serialize", real)
        assert ck.maybe_save(2, {"w": np.ones(2)})
        ck.wait()
        assert ck.all_steps() == [2]
    finally:
        ck.close()


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def test_preemption_sentinel_triggers_and_stale_ignored(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("HOROVOD_PREEMPTION_POLL_SECONDS", "0.05")
    sentinel = tmp_path / "notice"
    sentinel.write_text("old notice")
    past = time.time() - 3600
    os.utime(sentinel, (past, past))
    h = PreemptionHandler(sentinel=str(sentinel), install_signals=False)
    try:
        time.sleep(0.3)
        assert not h.requested
        sentinel.write_text("fresh notice")
        deadline = time.time() + 5
        while not h.requested and time.time() < deadline:
            time.sleep(0.05)
        assert h.requested
    finally:
        h.close()


def test_preemption_quiesce_margin_and_finalize_match_jax(tmp_path):
    seen = []
    for pkg, Pre, d in ((ac, PreemptionHandler, tmp_path / "port"),
                        (jac, jpre.PreemptionHandler, tmp_path / "jax")):
        ck = pkg.AsyncCheckpointer(str(d), interval=0, fmt="pickle")
        h = Pre(checkpointer=ck, margin=3, install_signals=False)
        try:
            trace = [h.check(5)]
            h.request("test notice")
            trace += [h.check(5), h.stop_step, h.check(7), h.check(8)]
            rc = h.finalize(8, {"w": np.ones(2), "step": 8})
            seen.append((trace, rc, ck.all_steps()))
        finally:
            h.close()
            ck.close()
    assert seen[0] == seen[1] == ([False, False, 8, False, True],
                                  RESUMABLE_EXIT_CODE, [8])


def test_preemption_signal_handler_installs_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler(install_signals=True)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not h.requested and time.time() < deadline:
            time.sleep(0.02)
        assert h.requested and "SIGTERM" in h.reason
    finally:
        h.close()
    assert signal.getsignal(signal.SIGTERM) == prev


# ---------------------------------------------------------------------------
# chaos spec
# ---------------------------------------------------------------------------

def test_chaos_spec_parse_and_generation_gate_match_jax(monkeypatch):
    monkeypatch.setenv("HOROVOD_CHAOS_SPEC", json.dumps(
        {"kill": {"1:17": 9}, "commit_deny": [5],
         "commit_delay": {"7": 0.25}, "only_generation": 2}))
    specs = []
    for mod in (chaos, jchaos):
        mod._spec_loaded = False
        monkeypatch.delenv("HVD_RESUME_ATTEMPT", raising=False)
        assert mod.active() is None              # generation 1: disarmed
        monkeypatch.setenv("HVD_RESUME_ATTEMPT", "1")   # generation 2
        spec = mod.active()
        assert spec is not None
        specs.append((spec.kill, spec.commit_deny, spec.commit_delay,
                      spec.only_generation))
        mod.on_step(3, rank=0)
        mod.on_commit(3)
    assert specs[0] == specs[1] == ({"1:17": 9}, {5}, {7: 0.25}, 2)


def test_chaos_deliver_preemption_writes_sentinel(tmp_path):
    p = chaos.deliver_preemption(str(tmp_path / "notice"))
    assert os.path.exists(p)


# ---------------------------------------------------------------------------
# integrations
# ---------------------------------------------------------------------------

def _mini_step(state, batch):
    return ({"w": state["w"] + batch, "step": state["step"] + 1},
            float(batch))


def _slow_mini_step(state, batch):
    """A step long enough for the previous tiny write to land, so no
    save is deferred and the cadence is the same in every run."""
    time.sleep(0.05)
    return _mini_step(state, batch)


def test_train_loop_checkpoints_restores_and_preempts_like_jax(tmp_path):
    """train_loop: snapshots at the cadence, restores into a fresh loop,
    and winds down resumable at the quiesce step; the info dicts and the
    committed step lists are the JAX loop's on the same mini state."""
    runs = []
    for loop, pkg, Pre, d in (
            (htt.train_loop, ac, PreemptionHandler, tmp_path / "port"),
            (jtrainer.train_loop, jac, jpre.PreemptionHandler,
             tmp_path / "jax")):
        d = str(d)
        state0 = {"w": np.zeros(2, np.float64), "step": 0}
        ck = pkg.AsyncCheckpointer(d, interval=2, fmt="pickle")
        state, info = loop(_slow_mini_step, dict(state0),
                           [np.float64(1.0)] * 6, checkpointer=ck)
        ck.close()
        first = (info, pkg.list_committed_steps(d))
        ck2 = pkg.AsyncCheckpointer(d, interval=2, fmt="pickle")
        h = Pre(checkpointer=ck2, margin=1, install_signals=False)
        h.request("drill")
        state2, info2 = loop(_slow_mini_step, dict(state0),
                             [np.float64(1.0)] * 6, checkpointer=ck2,
                             preemption=h)
        h.close()
        ck2.close()
        runs.append((first, info2, pkg.list_committed_steps(d),
                     np.asarray(state2["w"]).tolist()))
    port, jax_ = runs
    assert port[0][0]["status"] == "completed"
    assert port[0][0]["exit_code"] == 0 and port[0][0]["final_step"] == 6
    assert port[1]["restored"] and port[1]["status"] == "preempted"
    assert port[1]["exit_code"] == RESUMABLE_EXIT_CODE
    assert port[1]["final_step"] in port[2]
    assert port == jax_


def test_train_loop_honours_profile_and_numerics_with_checkpoints(
        monkeypatch, tmp_path):
    """The profile window and the numerics monitor beside the resilient
    loop's checkpoints: the mini step's NaN loss at step 3 is one anomaly,
    the snapshots still commit, and the window covers steps 2 and 3."""
    from horovod_tpu_torch.goodput import numerics
    monkeypatch.setenv("HOROVOD_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("HOROVOD_TRACE_PROFILE", "steps:2@2")
    monkeypatch.setenv("HOROVOD_NUMERICS", "1")
    monkeypatch.setenv("HOROVOD_NUMERICS_CHECK_EVERY", "1")
    numerics.reset_for_tests()
    try:
        ck = AsyncCheckpointer(str(tmp_path / "ckpt"), interval=2)
        state, info = htt.train_loop(
            _slow_mini_step, {"w": 0.0, "step": 0},
            [1.0, 2.0, float("nan"), 4.0], checkpointer=ck)
        ck.close()
        summary = numerics.get_monitor().summary()
    finally:
        numerics.reset_for_tests()
    assert info["final_step"] == 4 and info["status"] == "completed"
    assert summary["by_kind"] == {"nonfinite": 1}
    assert summary["last"]["step"] == 3
    assert list_committed_steps(str(tmp_path / "ckpt"))
    a = json.loads((tmp_path / "trace" / "profile" /
                    "profile_attribution.json").read_text())
    assert a["profiled_steps"] == 2


def test_train_loop_hooks_that_are_not_ported_raise(monkeypatch, tmp_path):
    """The step verifier's hook raises; the artifact store's is ported,
    so its knob runs the loop with the store (a cold store: the step
    misses and its manifest is published); so is the data service's, so
    its two knobs run the loop and tune its heartbeat and deadline."""
    from horovod_tpu_torch.resilience import faults
    from horovod_tpu_torch.store import artifact_store
    for knob, value in (("HOROVOD_VERIFY_STEP", "1"),
                        ("HOROVOD_VERIFY_STEP", "strict"),
                        ("HOROVOD_ARTIFACT_STORE", str(tmp_path / "store")),
                        ("HOROVOD_FAULT_HEARTBEAT_SECONDS", "1.5"),
                        ("HOROVOD_FAULT_WORKER_DEADLINE", "20")):
        monkeypatch.setenv(knob, value)
        if knob == "HOROVOD_ARTIFACT_STORE":
            artifact_store.reset_for_tests()
            try:
                _, info = htt.train_loop(_mini_step, {"w": 0.0, "step": 0},
                                         [1.0])
                stats = artifact_store.store_stats()
            finally:
                artifact_store.reset_for_tests()
            assert info["store_step"] == "miss" and info["final_step"] == 1
            assert stats["publishes"] == 1 and stats["entries"] == 1
        elif knob.startswith("HOROVOD_FAULT_"):
            _, info = htt.train_loop(_mini_step, {"w": 0.0, "step": 0},
                                     [1.0])
            assert info["final_step"] == 1 and info["status"] == "completed"
            assert (faults.heartbeat_interval_s(),
                    faults.worker_deadline_s()) == (
                (1.5, 10.0) if knob.endswith("SECONDS") else (2.0, 20.0))
        else:
            with pytest.raises(NotImplementedError, match=knob):
                htt.train_loop(_mini_step, {"w": 0.0, "step": 0}, [1.0])
        monkeypatch.delenv(knob)


def test_train_loop_reserves_once_the_optimizer_has_its_state(tmp_path):
    """train_loop makes the snapshots' buffers once, after the first step:
    torch.optim makes its momentum lazily, so before that step the state
    is not complete and the first save would pay for the rest."""
    seen = []

    class Recording(AsyncCheckpointer):
        def reserve(self, state):
            seen.append(len(state["opt"].state))
            super().reserve(state)

    w = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.SGD([w], lr=0.1, momentum=0.9)

    def step(state, x):
        opt.zero_grad()
        (state["w"] * x).sum().backward()
        opt.step()
        return state, 0.0

    ck = Recording(str(tmp_path), interval=2)
    try:
        _, info = htt.train_loop(step, {"w": w, "opt": opt},
                                 [torch.ones(3)] * 3, checkpointer=ck)
    finally:
        ck.close()
    assert info["final_step"] == 3 and seen == [1]


def test_train_loop_chaos_faults_of_unported_subsystems_raise():
    """No fault's subsystem is left unported: the serving fleet's replica
    faults fire on its router's dispatch path, the artifact store's
    (``store_corrupt``, ``fs_transient`` with scope store) in the store
    (tests/test_torch_artifact_store.py) and ``data_worker_kill`` in a
    ``DataWorker`` of the data service, so train_loop runs with each
    armed, as the JAX loop does; the armed kill then fires in a worker,
    which its consumer declares dead."""
    from horovod_tpu_torch.data.compute_service import (
        DataWorker, ResilientDataIterator)
    from horovod_tpu_torch.elastic.sampler import ElasticSampler
    for fault, value in (
            ("store_corrupt", {"fail_first": 1}),
            ("data_worker_kill", {"worker": 0, "after_batches": 1}),
            ("replica_kill", {"replica": 0, "after_requests": 1}),
            ("fs_transient", {"fail_first": 1, "scope": "store"})):
        chaos.install({fault: value})
        try:
            assert chaos.unported_faults() == []
            _, info = htt.train_loop(_mini_step, {"w": 0.0, "step": 0},
                                     [1.0])
            assert info["final_step"] == 1
            if fault == "data_worker_kill":
                workers = [DataWorker(lambda i, n: list(range(8)), i, 2,
                                      random_access=True) for i in range(2)]
                addrs = [w.start() for w in workers]
                try:
                    with ResilientDataIterator(
                            addrs, ElasticSampler(8, shuffle=False, rank=0,
                                                  num_replicas=1),
                            batch_size=4) as it:
                        batches = list(it)
                finally:
                    for w in workers:
                        w.stop()
                assert batches == [[0, 1, 2, 3], [4, 5, 6, 7]]
                assert workers[0]._dead and not workers[1]._dead
        finally:
            chaos.install(None)
    # not armed in this incarnation: it could not fire, nothing skipped
    chaos.install({"replica_kill": {"replica": 0}, "only_generation": 2})
    try:
        _, info = htt.train_loop(_mini_step, {"w": 0.0, "step": 0}, [1.0])
        assert info["final_step"] == 1
    finally:
        chaos.install(None)


def test_train_loop_builds_checkpointer_and_handler_from_knobs(
        tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_CKPT_DIR", str(tmp_path / "ck"))
    monkeypatch.setenv("HOROVOD_CKPT_INTERVAL", "2")
    monkeypatch.setenv("HOROVOD_PREEMPTION_FILE", str(tmp_path / "notice"))
    state, info = htt.train_loop(_mini_step,
                                 {"w": np.zeros(2), "step": 0},
                                 [np.float64(1.0)] * 3)
    assert info["final_step"] == 3 and not info["restored"]
    assert list_committed_steps(str(tmp_path / "ck"))
    from horovod_tpu_torch.resilience import active_handler
    assert active_handler() is None              # closed with the loop


def test_checkpoint_callback_drives_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), interval=2)
    cb = CheckpointCallback(ck)
    logs = {"state": {"w": np.zeros(2)}}
    cb.on_train_begin(logs)
    for b in range(6):
        logs["state"] = {"w": logs["state"]["w"] + 1.0}
        cb.on_batch_end(b, logs)
    ck.wait()
    assert ck.all_steps()
    h = PreemptionHandler(checkpointer=ck, margin=0, install_signals=False)
    h.request("drill")
    cb2 = CheckpointCallback(ck, preemption=h)
    logs2 = {"state": {"w": np.ones(2)}}
    cb2.on_train_begin(logs2)
    assert logs2["restored_step"] == max(ck.all_steps())
    cb2.on_batch_end(0, logs2)
    assert logs2.get("stop_training") is True
    assert logs2.get("exit_code") == RESUMABLE_EXIT_CODE
    h.close()
    ck.close()


def test_checkpoint_manager_skips_partial_and_rotates_safely(tmp_path):
    with CheckpointManager(str(tmp_path / "runs"), max_to_keep=2) as mgr:
        for i in range(3):
            mgr.save(i, {"w": torch.full((2,), float(i))}, wait=True)
        assert mgr.all_steps() == [1, 2]
        os.makedirs(os.path.join(str(tmp_path / "runs"), step_dirname(9)))
        assert mgr.latest_step() == 2
        assert torch.equal(mgr.restore()["w"], torch.full((2,), 2.0))


def test_checkpoint_manager_errors_name_legacy_layout_and_step(tmp_path):
    with CheckpointManager(str(tmp_path / "runs")) as mgr:
        mgr.save(10, {"w": torch.ones(2)}, wait=True)
        with pytest.raises(FileNotFoundError, match="step 5"):
            mgr.restore(step=5)
    legacy = tmp_path / "legacy"
    (legacy / "42").mkdir(parents=True)
    with CheckpointManager(str(legacy)) as mgr:
        with pytest.raises(FileNotFoundError, match="legacy orbax"):
            mgr.restore()


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, replayed
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4),
                        "b": torch.zeros((4,))},
             "step": torch.tensor(7)}
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    back = restore_checkpoint(path)
    for a, b in ((back["params"]["w"], state["params"]["w"]),
                 (back["params"]["b"], state["params"]["b"]),
                 (back["step"], state["step"])):
        assert torch.equal(a, b)
    template = {"params": {"w": torch.zeros(3, 4), "b": torch.ones(4)},
                "step": torch.tensor(0)}
    w = template["params"]["w"]
    back = restore_checkpoint(path, template=template)
    assert back["params"]["w"] is w and torch.equal(w, state["params"]["w"])


def test_manager_rotation_and_resume(tmp_path):
    def state(i):
        return {"w": torch.full((4,), float(i)), "step": i}

    with CheckpointManager(str(tmp_path / "runs"), max_to_keep=2) as mgr:
        for i in range(5):
            mgr.save(i, state(i))
        assert mgr.latest_step() == 4
        assert mgr.all_steps() == [3, 4]
        back = mgr.restore()
        assert torch.equal(back["w"], state(4)["w"]) and back["step"] == 4
        back3 = mgr.restore(step=3, template=state(0))
        assert torch.equal(back3["w"], state(3)["w"]) and back3["step"] == 3


def test_manager_restore_empty_raises(tmp_path):
    with CheckpointManager(str(tmp_path / "empty")) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore()


def test_save_checkpoint_refuses_overwrite_without_force(tmp_path):
    path = str(tmp_path / "once")
    save_checkpoint(path, {"w": torch.ones((2,))})
    with pytest.raises(ValueError):
        save_checkpoint(path, {"w": torch.zeros((2,))})
    save_checkpoint(path, {"w": torch.zeros((2,))}, force=True)
    assert torch.equal(restore_checkpoint(path)["w"], torch.zeros(2))


def test_remote_uri_paths_not_mangled():
    from horovod_tpu_torch.checkpoint import _normalize
    assert _normalize("gs://bucket/run/ckpt") == "gs://bucket/run/ckpt"
    assert _normalize("relative/dir").startswith("/")


# ---------------------------------------------------------------------------
# trajectories: preempted and resumed, against the uninterrupted run and
# the JAX loop
# ---------------------------------------------------------------------------

def _jcfg(**kw):
    return jtfm.TransformerConfig(**{**CFG_KW, "dtype": jnp.float32,
                                     "dp_axis": "dp", "remat": False,
                                     "mlp_recompute": False, **kw})


def _cfg_kw(**kw):
    return {**CFG_KW, "dtype": torch.float32, "dp_axis": "dp",
            "remat": False, "mlp_recompute": False, **kw}


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray,
                        jtfm.init_params(_jcfg(), jax.random.PRNGKey(0)))


def _batches(n, b=B, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG_KW["vocab_size"], (b, S)).astype(np.int32),
             rng.integers(0, CFG_KW["vocab_size"], (b, S)).astype(np.int32))
            for _ in range(n)]


def _jax_preempt_resume(make_state, step, batches, d, preempt_at=2):
    """The JAX loop preempted at ``preempt_at`` (chaos preempt_at, margin
    0) into ``d``, then a fresh state resumed to the end; returns the
    resumed state and both info dicts."""
    ck = jac.AsyncCheckpointer(d, interval=1, fmt="pickle")
    h = jpre.PreemptionHandler(checkpointer=ck, margin=0,
                               install_signals=False)
    jchaos.install({"preempt_at": preempt_at})
    try:
        _, info = jtrainer.train_loop(step, make_state(), batches,
                                      checkpointer=ck, preemption=h)
    finally:
        jchaos.install(None)
        h.close()
        ck.close()
    ck = jac.AsyncCheckpointer(d, interval=1, fmt="pickle")
    try:
        state, info2 = jtrainer.train_loop(
            step, make_state(), batches[preempt_at:], checkpointer=ck)
    finally:
        ck.close()
    return state, [info, info2]


def _port_preempt_resume(make_state, step, batches, d, preempt_at=2):
    ck = AsyncCheckpointer(d, interval=1)
    h = PreemptionHandler(checkpointer=ck, margin=0, install_signals=False)
    chaos.install({"preempt_at": preempt_at})
    try:
        _, info = htt.train_loop(step, make_state(), batches,
                                 checkpointer=ck, preemption=h)
    finally:
        chaos.install(None)
        h.close()
        ck.close()
    ck = AsyncCheckpointer(d, interval=1)
    try:
        state, info2 = htt.train_loop(step, make_state(),
                                      batches[preempt_at:],
                                      checkpointer=ck)
    finally:
        ck.close()
    return state, [info, info2]


def _want_infos(n, preempt_at=2):
    return [{"status": "preempted", "exit_code": 75, "restored": False,
             "start_step": 0, "final_step": preempt_at},
            {"status": "completed", "exit_code": 0, "restored": True,
             "start_step": preempt_at, "final_step": n}]


def test_flagship_preempted_and_resumed_is_bitwise_and_matches_jax(
        np_params, tmp_path):
    batches = _batches(4)
    cfg = htt.TransformerConfig(**_cfg_kw())
    htt.init(device="cpu")
    try:
        init_fn, step = htt.make_transformer_train_step(
            cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
            device="cpu")

        def fresh():
            return init_fn(htt.params_from_numpy(np_params, device="cpu"))

        ref, info = htt.train_loop(step, fresh(), batches)
        assert info["final_step"] == 4
        state, infos = _port_preempt_resume(fresh, step, batches,
                                            str(tmp_path / "port"))
    finally:
        htt.shutdown()
    assert infos == _want_infos(4)
    ref_leaves = tree_util.tree_leaves(ref.params)
    got_leaves = tree_util.tree_leaves(state.params)
    for a, b in zip(got_leaves, ref_leaves):
        assert torch.equal(a, b)
    for a, b in zip(got_leaves, ref_leaves):
        assert torch.equal(state.opt_state.state[a]["momentum_buffer"],
                           ref.opt_state.state[b]["momentum_buffer"])
    # the JAX loop, preempted and resumed on a 1-device mesh
    jcfg = _jcfg()
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    opt = optax.sgd(0.01, momentum=0.9)
    _, jstep = jtrainer.make_transformer_train_step(jcfg, opt, mesh)

    def jfresh():
        params = jax.device_put(jax.tree.map(jnp.asarray, np_params),
                                NamedSharding(mesh, P()))
        return jtrainer.TrainState(jnp.zeros((), jnp.int32), params,
                                   opt.init(params))

    jstate, jinfos = _jax_preempt_resume(jfresh, jstep, batches,
                                         str(tmp_path / "jax"))
    assert [{k: v for k, v in i.items() if k != "verify_step_reused"}
            for i in jinfos] == infos
    for a, b in zip(got_leaves, jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def test_resnet_preempted_and_resumed_is_bitwise_and_matches_jax(tmp_path):
    """A small ResNet (plain BN, running statistics) through
    DistributedOptimizer and data_parallel_train_step in a world of one."""
    import torch.nn.functional as F
    from flax.core import unfreeze
    from flax.traverse_util import flatten_dict
    from horovod_tpu.models import resnet as jresnet
    from horovod_tpu_torch.models import resnet
    kw = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8)
    jmodel = jresnet.ResNet(block_cls=jresnet.BottleneckBlock,
                            dtype=jnp.float32, fused_conv_bn=False, **kw)
    variables = unfreeze(jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), train=True)))
    rng = np.random.RandomState(5)
    batches = [(rng.randn(2, 32, 32, 3).astype(np.float32),
                rng.randint(0, 10, (2,)).astype(np.int64))
               for _ in range(4)]
    htt.init(device="cpu")
    try:
        def fresh():
            model = resnet.variables_from_numpy(htt.ResNet(
                block_cls=resnet.BottleneckBlock, dtype=torch.float32,
                fused_conv_bn=False, device="cpu", **kw), variables)
            opt = htt.DistributedOptimizer(torch.optim.SGD(
                model.parameters(), lr=0.01, momentum=0.9))
            return init_fn(model, opt)

        def init_fn(model, opt):
            return htt.TrainState(0, model, opt)

        # the step reads the optimizer from the state it is given
        _, step, put = htt.data_parallel_train_step(
            lambda m, x, y: F.cross_entropy(m(x, train=True), y),
            htt.DistributedOptimizer(torch.optim.SGD(
                [torch.nn.Parameter(torch.zeros(1))], lr=0.01)),
            device="cpu")
        pbatches = [put(b) for b in batches]
        ref, _ = htt.train_loop(step, fresh(), pbatches)
        state, infos = _port_preempt_resume(fresh, step, pbatches,
                                            str(tmp_path / "port"))
    finally:
        htt.shutdown()
    assert infos == _want_infos(4)
    got = resnet.variables_to_numpy(state.params)
    want = resnet.variables_to_numpy(ref.params)
    for coll in ("params", "batch_stats"):
        for k, v in flatten_dict(want[coll]).items():
            assert np.array_equal(flatten_dict(got[coll])[k], v), (coll, k)
    for a, b in zip(state.params.parameters(), ref.params.parameters()):
        assert torch.equal(state.opt_state.optimizer.state[a][
            "momentum_buffer"], ref.opt_state.optimizer.state[b][
            "momentum_buffer"])
    # the JAX loop: bench.py build_step's math with the statistics carried
    opt = optax.sgd(0.01, momentum=0.9)

    @jax.jit
    def jstep(state, x, y):
        def go(params):
            logits, upd = jmodel.apply(
                {"params": params, "batch_stats": state.params[
                    "batch_stats"]}, x, train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), upd["batch_stats"]
        (loss, stats), grads = jax.value_and_grad(go, has_aux=True)(
            state.params["params"])
        updates, opt_state = opt.update(grads, state.opt_state,
                                        state.params["params"])
        params = optax.apply_updates(state.params["params"], updates)
        return jtrainer.TrainState(
            state.step + 1, {"params": params, "batch_stats": stats},
            opt_state), loss

    def jfresh():
        v = jax.tree.map(jnp.asarray, variables)
        return jtrainer.TrainState(jnp.zeros((), jnp.int32), v,
                                   opt.init(v["params"]))

    jbatches = [(x, y.astype(np.int32)) for x, y in batches]
    jstate, jinfos = _jax_preempt_resume(jfresh, jstep, jbatches,
                                         str(tmp_path / "jax"))
    assert [{k: v for k, v in i.items() if k != "verify_step_reused"}
            for i in jinfos] == infos
    for coll in ("params", "batch_stats"):
        flat = flatten_dict(got[coll])
        for k, v in flatten_dict(unfreeze(jstate.params[coll])).items():
            np.testing.assert_allclose(flat[k], np.asarray(v), **TOL,
                                       err_msg=f"{coll} {'/'.join(k)}")


def _run_spec(world, spec, out_dir):
    procs = workers.start_world(workers.resilient_worker, world, spec,
                                str(out_dir))
    workers.join_world(procs)


def _load(out_dir, name, rank):
    out = dict(np.load(os.path.join(out_dir, f"{name}-rank{rank}.npz")))
    out["info"] = json.loads(str(out["info"]))
    return out


def _assert_bitwise(got, want, what):
    keys = [k for k in want if "|" in k]
    assert keys and set(keys) == {k for k in got if "|" in k}
    for k in keys:
        assert np.array_equal(got[k], want[k]), f"{what} {k}"


def test_two_rank_fused_fp8_preempted_and_resumed(np_params, tmp_path):
    """Two gloo ranks, the fused step at fp8_e4m3 with error feedback:
    every rank writes its own shard (its own residual), rank 0 commits
    behind the c10d-store barrier; the resumed run equals the
    uninterrupted one bitwise on both ranks, residuals included, and the
    JAX loop on a 2-device mesh within the fp8 rule of the module
    docstring."""
    batches = _batches(4)
    spec = dict(model="fused", cfg=_cfg_kw(), np_params=np_params,
                batches=batches,
                knobs={"HOROVOD_GRADIENT_COMPRESSION": "fp8_e4m3"},
                phases=[
                    dict(name="uninterrupted", dir=str(tmp_path / "u")),
                    dict(name="preempted", dir=str(tmp_path / "p"),
                         preempt=True, chaos={"preempt_at": 2}),
                    dict(name="resumed", dir=str(tmp_path / "p"),
                         resume=True)])
    procs = workers.start_world(workers.resilient_worker, 2, spec,
                                str(tmp_path))
    try:
        jcfg = _jcfg()
        mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
        jknobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
        try:
            from horovod_tpu.parallel import distributed as JD
            da = JD.distributed_apply(JD.EpilogueSGD(0.01, momentum=0.9),
                                      sync_axes=jtfm.grad_sync_axes(jcfg),
                                      mesh=mesh)
            _, jstep = jtrainer.make_transformer_train_step_fused(
                jcfg, da, mesh)
            pspecs = jtfm.param_specs(jcfg)

            def jfresh():
                params = jax.tree.map(
                    lambda a, s: jax.device_put(jnp.asarray(a),
                                                NamedSharding(mesh, s)),
                    np_params, pspecs,
                    is_leaf=lambda x: isinstance(x, np.ndarray))
                return jtrainer.TrainState(jnp.zeros((), jnp.int32), params,
                                           da.init(params))

            jstate, jinfos = _jax_preempt_resume(jfresh, jstep, batches,
                                                 str(tmp_path / "jax"))
        finally:
            jknobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
    finally:
        workers.join_world(procs)
    jparams = jax.tree.leaves(jstate.params)
    jres = jax.tree.leaves(jstate.opt_state.residual)
    residual_sums = []
    for r in range(2):
        ref = _load(tmp_path, "uninterrupted", r)
        pre = _load(tmp_path, "preempted", r)
        got = _load(tmp_path, "resumed", r)
        assert [pre["info"], got["info"]] == _want_infos(4)
        assert 2 in pre["committed"].tolist()
        _assert_bitwise(got, ref, f"rank {r}")
        n_res = sum(k.startswith("res|") for k in got)
        assert n_res == len(jparams)
        residual_sums.append(sum(float(np.abs(got[f"res|{i}"]).sum())
                                 for i in range(n_res)))
        for i, jl in enumerate(jparams):
            jl = np.asarray(jl)
            top = max(1.0, float(np.max(np.abs(jl))))
            diff = np.abs(got[f"param|{i}"] - jl)
            assert np.mean(diff > 1e-6 * top) <= 2e-3, (r, i)
            assert np.all(diff <= 2e-4 * top), (r, i)
            rdiff = np.abs(got[f"res|{i}"] - np.asarray(jres[i])[r])
            assert np.mean(rdiff <= 1e-5) >= 0.95, (r, i)
    assert residual_sums[0] != residual_sums[1]      # one residual per rank
    assert [{k: v for k, v in i.items() if k != "verify_step_reused"}
            for i in jinfos] == _want_infos(4)


def test_two_rank_save_one_rank_cannot_make_is_deferred_on_both(
        np_params, tmp_path):
    """Rank 1 holds both of its pinned buffer sets through the save due at
    step 4, so it cannot take that snapshot: both ranks defer it together
    (one deferral each), and the saves after it still commit on both, in
    the same store namespaces."""
    batches = _batches(6)
    spec = dict(model="transformer", cfg=_cfg_kw(), np_params=np_params,
                batches=batches,
                phases=[dict(name="held", dir=str(tmp_path / "h"),
                             interval=2, keep=5, hold=[1, 4])])
    _run_spec(2, spec, tmp_path)
    for r in range(2):
        got = _load(tmp_path, "held", r)
        assert got["info"]["final_step"] == 6
        assert got["committed"].tolist() == [2, 6], r
        assert int(got["deferred"]) == 1, r


def test_chaos_kill_drill_resumes_to_the_uninterrupted_parameters(
        np_params, tmp_path):
    """Rank 1 of a two-rank world is SIGKILLed at step 3 (chaos kill,
    first incarnation only); the launcher's part, done here, is to stop
    the survivor and relaunch as the next incarnation, which restores the
    newest committed snapshot and runs to the end: bitwise the
    parameters and momentum of an uninterrupted run of the same world."""
    batches = _batches(5)
    base = dict(model="transformer", cfg=_cfg_kw(), np_params=np_params,
                batches=batches)
    killed = dict(base, phases=[dict(name="killed", dir=str(tmp_path / "k"),
                                     chaos={"kill": {"1:3": 9}})])
    procs = workers.start_world(workers.resilient_worker, 2, killed,
                                str(tmp_path))
    deadline = time.time() + workers.TIMEOUT_S
    while procs[1].is_alive() and time.time() < deadline:
        time.sleep(0.05)
    assert procs[1].exitcode == -signal.SIGKILL
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    committed = list_committed_steps(str(tmp_path / "k"))
    assert committed and max(committed) <= 3
    resumed = dict(base, attempt=1, phases=[
        dict(name="resumed", dir=str(tmp_path / "k"), resume=True,
             chaos={"kill": {"1:3": 9}}),
        dict(name="uninterrupted", dir=str(tmp_path / "u"))])
    _run_spec(2, resumed, tmp_path)
    for r in range(2):
        got = _load(tmp_path, "resumed", r)
        ref = _load(tmp_path, "uninterrupted", r)
        assert got["info"]["restored"] and got["info"]["final_step"] == 5
        assert got["info"]["start_step"] == max(committed)
        _assert_bitwise(got, ref, f"rank {r}")
