"""The port's live resize (``horovod_tpu_torch/elastic/resize.py``) against
the JAX package's ``horovod_tpu/elastic/resize.py`` on the CPU.

- the error-feedback residual re-partition matrix of
  ``tests/test_resize.py`` (N -> N-1, N -> N+1, a slice loss; the
  sum-into-successor policy): the same numpy inputs through both
  packages, equal bit for bit, and the sum invariant; the port's tensor
  form equal to its numpy form;
- ``successor_map``, ``ResizePlan``'s JSON round trip (each package reads
  the other's), the plan commit/load, the agreement in a world of one,
  the plan barrier's follower and leader paths, ``merge_sampler_states``
  and ``SamplerCarryover``, index for index;
- a four-rank gloo world of the fused tiny flagship at fp8_e4m3 with error
  feedback, two hosts of two: chaos ``host_loss`` of host 1 at step 3,
  ranks 2-3 snapshot and leave, ranks 0-1 go on in process on a two-rank
  world, bitwise equal to a cold two-rank start from the committed
  snapshot and plan (the JAX chaos drill's contract,
  ``tests/test_resize.py:660``); a removal of rank 0's host is refused
  (rank 0 hosts the env:// store).

The whole module runs under a time limit of its own (``LIMIT_S``).
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from horovod_tpu.config import knobs as jknobs
from horovod_tpu.elastic import resize as JR
from horovod_tpu.elastic.sampler import ElasticSampler as JSampler
from horovod_tpu.parallel.distributed import WireState as JWireState
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.elastic import resize as R
from horovod_tpu_torch.elastic.sampler import ElasticSampler
from horovod_tpu_torch.parallel.distributed import WireState
import test_torch_launch_workers as lw
import test_torch_workers as workers

LIMIT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


# ---------------------------------------------------------------------------
# the residual re-partition matrix, both packages, bitwise
# ---------------------------------------------------------------------------

def _tree(world, width=3, dtype=np.float32):
    base = np.arange(world * width, dtype=dtype).reshape(world, width)
    return {"residual": base, "nested": {"residual": base * 2.0}}


MATRIX = [
    # (name, tree, old, new, dead, carried)
    ("shrink_successor", _tree(4), 4, 3, (1,), None),
    ("shrink_last_wraps", _tree(4), 4, 3, (3,), None),
    ("consecutive_dead_chain", _tree(8), 8, 6, (2, 3), None),
    ("slice_loss_wraps_whole_slice", _tree(8), 8, 4, (4, 5, 6, 7), None),
    ("grow_appends_zeros", _tree(3), 3, 5, (), None),
    ("grow_insertion", np.arange(4, dtype=np.float64).reshape(4, 1) + 1.0,
     4, 6, (), ((0, 0), (1, 1), (2, 4), (3, 5))),
    ("random_f32", np.random.RandomState(3).randn(8, 64).astype(np.float32),
     8, 5, (1, 4, 6), None),
    ("float16", np.random.RandomState(4).randn(4, 2).astype(np.float16),
     4, 3, (0,), None),
]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("case", MATRIX, ids=[c[0] for c in MATRIX])
def test_repartition_matrix_bitwise_against_jax(case):
    _, tree, old, new, dead, carried = case
    want = JR.repartition_residual(tree, old, new, dead, carried)
    got = R.repartition_residual(tree, old, new, dead, carried)
    as_tensors = R.repartition_residual(
        R._map(torch.from_numpy, tree), old, new, dead, carried)
    for w, g, t in zip(_leaves(want), _leaves(got), _leaves(as_tensors)):
        assert g.dtype == w.dtype and g.tobytes() == np.asarray(w).tobytes()
        assert t.numpy().tobytes() == g.tobytes()


def test_sum_invariance_no_quantization_debt_dropped():
    t = np.random.RandomState(7).randint(-50, 50, size=(8, 16)).astype(
        np.float32)
    for mod in (R, JR):
        out = mod.repartition_residual(t, 8, 6, dead_ranks=(2, 3))
        assert np.array_equal(out.sum(axis=0), t.sum(axis=0))
    lost = t[2] + t[3]
    assert np.abs(lost).max() > 0


def test_errors_match_jax():
    for mod in (R, JR):
        with pytest.raises(ValueError, match="leading"):
            mod.repartition_residual(np.zeros((5, 2)), 4, 3, (1,))
        with pytest.raises(ValueError, match="surviving"):
            mod.successor_map(2, (0, 1))


@pytest.mark.parametrize("world,dead", [(6, (1, 2)), (6, (5,)), (4, (0, 3)),
                                        (8, (0, 1, 2, 7))])
def test_successor_map_matches_jax(world, dead):
    assert R.successor_map(world, dead) == JR.successor_map(world, dead)


def test_reshard_wire_state_matches_jax():
    plan = R.ResizePlan(step=1, old_world=4, new_world=3, dead_ranks=(1,))
    jplan = JR.ResizePlan(step=1, old_world=4, new_world=3, dead_ranks=(1,))
    res = np.arange(8, dtype=np.float32).reshape(4, 2)
    got = R.reshard_wire_state({"opt": (WireState(residual={"w": res}),),
                                "plain": np.ones((4, 2)),
                                "residual": np.zeros((6, 2))}, plan)
    want = JR.reshard_wire_state({"opt": (JWireState(residual={"w": res}),),
                                  "plain": np.ones((4, 2)),
                                  "residual": np.zeros((6, 2))}, jplan)
    assert got["opt"][0].residual["w"].tobytes() == \
        np.asarray(want["opt"][0].residual["w"]).tobytes()
    assert got["plain"].shape == (4, 2)        # not under "residual"
    assert got["residual"].shape == (6, 2)     # not the old world


# ---------------------------------------------------------------------------
# plan, commit, agreement, barrier, sampler carryover
# ---------------------------------------------------------------------------

def test_plan_json_round_trip_across_packages():
    kw = dict(step=9, old_world=8, new_world=6, dead_ranks=(2, 3),
              old_dcn=2, new_dcn=1, notice={"kind": "host_loss", "host": 1},
              generation=3)
    p, jp = R.ResizePlan(**kw), JR.ResizePlan(**kw)
    assert p.to_json() == jp.to_json()
    assert R.ResizePlan.from_json(jp.to_json()) == p
    assert p.carried == ((0, 0), (1, 1), (4, 2), (5, 3), (6, 4), (7, 5))
    with pytest.raises(ValueError, match="overlap"):
        R.ResizePlan(step=0, old_world=4, new_world=4, dead_ranks=(1,),
                     carried=((0, 0), (1, 1), (2, 2), (3, 3)))


def test_commit_load_and_torn_part_files(tmp_path):
    d = str(tmp_path)
    p = R.ResizePlan(step=7, old_world=4, new_world=3, dead_ranks=(0,))
    R.commit_plan(d, p)
    assert R.load_plan(d, 7) == p and R.load_plan(d) == p
    assert R.load_plan(d, 8) is None
    assert JR.load_plan(d, 7).to_json() == p.to_json()    # same file
    with open(R.plan_path(d, 9) + ".part", "w") as f:
        f.write("{")
    assert R.load_plan(d, 9) is None and R.load_plan(d) == p
    state = {"residual": np.ones((4, 2))}
    assert R.adopt_plan_on_restore(str(tmp_path / "none"), state) is state
    got = R.adopt_plan_on_restore(d, {"residual": np.arange(8.0).reshape(
        4, 2)})
    want = JR.adopt_plan_on_restore(d, {"residual": np.arange(8.0).reshape(
        4, 2)})
    assert np.array_equal(got["residual"], np.asarray(want["residual"]))


def test_agreement_in_a_world_of_one_matches_jax():
    outs = []
    for mod, reg in ((R, knobs), (JR, jknobs)):
        reg.set_override("HOROVOD_ELASTIC_RESIZE_MARGIN", 3)
        try:
            a = mod.ResizeAgreement()
            seq = [a.check(5)]
            a.propose({"kind": "host_loss", "host": 0})
            seq += [a.check(5), a.check(7), a.check(8), a.check(9)]
            outs.append(seq)
        finally:
            reg.clear_override("HOROVOD_ELASTIC_RESIZE_MARGIN")
    assert outs[0] == outs[1]
    assert outs[0][3] == {"stop_step": 8,
                          "notice": {"kind": "host_loss", "host": 0}}
    assert R.ResizeAgreement(0).key == JR.ResizeAgreement(0).key
    assert R.ResizeAgreement(0).key != R.ResizeAgreement(1).key


class _DeadKV:
    def set(self, *a, **k):
        raise ConnectionError("UNAVAILABLE")

    def get(self, *a, **k):
        raise TimeoutError("DEADLINE_EXCEEDED")


def test_commit_barrier_paths_match_jax(tmp_path):
    plan = R.ResizePlan(step=4, old_world=4, new_world=3, dead_ranks=(1,))
    jplan = JR.ResizePlan(step=4, old_world=4, new_world=3, dead_ranks=(1,))
    for mod, p, sub in ((R, plan, "port"), (JR, jplan, "jax")):
        empty, with_plan = str(tmp_path / sub / "a"), str(tmp_path / sub /
                                                          "b")
        mod.commit_plan(with_plan, p)
        # a follower whose commit record was lost reads the plan file
        assert mod.commit_plan_after_snapshot(
            with_plan, p, kv=_DeadKV(), pidx=1, nproc=2, timeout=0.01)
        assert not mod.commit_plan_after_snapshot(
            empty, p, kv=_DeadKV(), pidx=1, nproc=2, timeout=0.01)
        # the leader abandons on missing acks without committing
        assert not mod.commit_plan_after_snapshot(
            empty, p, kv=_DeadKV(), pidx=0, nproc=2, timeout=0.01)
        assert mod.load_plan(empty, 4) is None


def test_merge_sampler_states_matches_jax():
    snaps = [{"epoch": 1, "processed_indices": [1, 2]},
             {"epoch": 2, "processed_indices": [2, 5]}]
    assert R.merge_sampler_states(snaps) == JR.merge_sampler_states(snaps)
    assert R.merge_sampler_states(snaps) == {"epoch": 2,
                                             "processed_indices": [1, 2, 5]}


def test_sampler_carryover_matches_jax_index_for_index():
    shards = []
    for Sampler in (ElasticSampler, JSampler):
        old = [Sampler(40, shuffle=True, seed=5, rank=r, num_replicas=4)
               for r in range(4)]
        for s in old:                       # synchronous batches
            for b in range(2):
                s.record_batch(b, 2)
        shards.append(old)
    plan = R.ResizePlan(step=1, old_world=8, new_world=6, dead_ranks=(2, 3))
    jplan = JR.ResizePlan(step=1, old_world=8, new_world=6,
                          dead_ranks=(2, 3))
    carry = R.SamplerCarryover(shards[0], replicas_fn=lambda p: 3)
    jcarry = JR.SamplerCarryover(shards[1], replicas_fn=lambda p: 3)
    carry.gather(plan)             # a world of one: its own shards
    carry.reshard(plan)
    jcarry.reshard(jplan)
    assert [list(s.indices) for s in carry.samplers] == \
        [list(s.indices) for s in jcarry.samplers]
    processed = set()
    for s in shards[0]:
        processed.update(s.processed_indices)
    served = [i for s in carry.samplers for i in s.indices]
    assert set(served) == set(range(40)) - processed
    assert 0 <= len(served) - (40 - len(processed)) < 3


def test_resize_needs_init_and_an_agreed_plan():
    import horovod_tpu_torch as htt
    assert not htt.is_initialized()
    with pytest.raises(RuntimeError, match="init"):
        R.ResizeCoordinator()
    htt.init(device="cpu")
    try:
        rc = R.ResizeCoordinator(host_size=1)
        with pytest.raises(RuntimeError, match="no agreed plan"):
            rc.resize(0, {})
        assert rc.alive_ranks() == [0]
        with pytest.raises(ValueError, match="unknown resize notice"):
            rc._notice_effect({"kind": "bogus"})
    finally:
        htt.shutdown()


# ---------------------------------------------------------------------------
# the four-rank gloo shrink against a cold two-rank start
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=256, d_model=64, n_heads=4, head_dim=16, n_layers=2,
           d_ff=128, max_seq=256)


def test_four_rank_shrink_bitwise_equal_to_cold_two_rank_start(tmp_path):
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.utils import tree as tree_util
    cfg = htt.TransformerConfig(**CFG)
    params = htt.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    np_params = tree_util.tree_map(lambda t: t.detach().numpy(), params)
    spec = {"cfg": CFG, "np_params": np_params, "b": 2, "steps": 6,
            "at": 3, "dir": str(tmp_path / "ckpt")}
    out = tmp_path / "out"
    out.mkdir()
    workers.join_world(workers.start_world(
        lw.resize_worker, 4, dict(spec, mode="live"), str(out)))
    workers.join_world(workers.start_world(
        lw.resize_worker, 2, dict(spec, mode="cold"), str(out)))
    for r in (2, 3):
        left = np.load(out / f"left-rank{r}.npz")
        assert int(left["step"]) == 3 and not bool(left["world"])
    live = [np.load(out / f"live-rank{r}.npz") for r in (0, 1)]
    cold = [np.load(out / f"cold-rank{r}.npz") for r in (0, 1)]
    metas = [json.loads(str(x["meta"])) for x in live]
    for r, m in enumerate(metas):
        assert m["resized_at"] == 3 and m["world_after"] == 2
        assert m["rank_after"] == r and m["resize_seconds"] == 1
        assert "rank 0's host" in m["host0_refusal"]
        plan = R.ResizePlan.from_json(m["plan"])
        assert plan.dead_ranks == (2, 3) and plan.new_world == 2
    assert json.loads(str(cold[0]["meta"]))["restored_step"] == 3
    keys = [k for k in live[0].files if k.split("|")[0] in
            ("param", "mom", "res")]
    assert any(k.startswith("res|") for k in keys)
    for r in (0, 1):
        for k in keys:
            assert live[r][k].tobytes() == cold[r][k].tobytes(), (r, k)
    # each survivor's residual is its own after the merge
    assert any(live[0][k].tobytes() != live[1][k].tobytes()
               for k in keys if k.startswith("res|"))

