"""The port's fused flagship step on every mesh axis, against the JAX
package, on the CPU.

``make_transformer_train_step_fused`` (hook-launched buckets, one set per
group of sync axes, the update in each bucket's epilogue) on the four
meshes (dp 2, tp 2), (dp 2, sp 2) with ring attention, (dp 2, ep 2) and
(dp 2, pp 2), and on (tp 4), where the leaves sharded over tp sync over
no axis: ONE 4-rank gloo world (``test_torch_workers.run_phases``, a
phase per mesh) takes the same ``BASE`` configuration, weights and
batches as the JAX side on ``jax.devices()[:4]``, for two steps of
``EpilogueSGD(0.05, momentum=0.9)``.

The port is held to the UNFUSED step's semantics: every leaf's sum is
divided by W, the product of the mesh axes. The JAX fused step divides a
leaf by its own sync group's size instead
(``horovod_tpu/parallel/distributed.py:1099``), so on tp, ep and pp its
update of a leaf sharded over that axis is 2x the unfused step's; a test
here holds that fault of the reference, and fails once it is repaired.

- Tier none, each mesh (local leaves included: they too divide by W):
  losses and every parameter after each step
  (gathered through ``gather_params``) within rtol 1e-4, atol 1e-5 of the
  JAX unfused step with ``optax.sgd(0.05, momentum=0.9)``; on (dp 2, sp
  2), where every leaf syncs over the whole mesh, of the JAX fused step
  too.
- fp8_e4m3 with error feedback on (dp 2, tp 2) and (dp 2, sp 2), after
  the first step: each rank's residual against its slice of the JAX
  fused step's residual, and each leaf's update against the JAX fused
  update times (its sync world / W), to the tolerances
  ``tests/test_torch_grad_sync.py`` states for the fused fp8 step (the
  two frameworks' f32 gradients differ in their last bits, so a value on
  an fp8 rounding boundary may round the other way); the losses of both
  steps finite, and on (dp 2, sp 2) within that file's loss tolerance of
  the JAX fused step's.
"""

import functools
import signal

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.config import knobs as jknobs
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import distributed as JD
from horovod_tpu.parallel import trainer as jtrainer
import horovod_tpu_torch as htt
import test_torch_workers as workers
import test_transformer_parallel as jtp

LIMIT_S = 170
LR, MOMENTUM = 0.05, 0.9
RTOL, ATOL = 1e-4, 1e-5
# the fused fp8 step's limits of tests/test_torch_grad_sync.py
F32, NARROW = 1e-5, 1e-6
FLIP_SHARE, FLIP_REL = 2e-3, 2e-4
RESIDUAL_SHARE = 0.95
MESHES = {"tp": ((2, 2), ("dp", "tp")), "sp": ((2, 2), ("dp", "sp")),
          "ep": ((2, 2), ("dp", "ep")), "pp": ((2, 2), ("dp", "pp")),
          "tp4": ((4,), ("tp",))}
CASES = {
    "tp": dict(dp_axis="dp", tp_axis="tp"),
    "tp4": dict(dp_axis=None, tp_axis="tp"),
    "sp": dict(dp_axis="dp", sp_axis="sp", attention="ring"),
    "ep": dict(dp_axis="dp", ep_axis="ep", num_experts=4,
               capacity_factor=4.0, moe_aux_weight=0.0),
    "pp": dict(dp_axis="dp", pp_axis="pp", n_microbatches=2, n_layers=4),
}
FP8_CASES = ("tp", "sp")
N_STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def _limit():
    def expired(*_):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")
    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _jkw(case):
    return {**jtp.BASE, **CASES[case]}


def _params(case):
    cfg = jtfm.TransformerConfig(**_jkw(case))
    return jax.tree.map(np.asarray, jtfm.init_params(cfg,
                                                     jax.random.PRNGKey(0)))


def _batches():
    return [tuple(np.asarray(a) for a in jtp.make_batch(t))
            for t in range(N_STEPS)]


def _knobs(tier):
    return {"HOROVOD_GRADIENT_COMPRESSION": tier}


def _phases():
    phases = []
    for case in CASES:
        cfg = htt.TransformerConfig(**{**_jkw(case),
                                       "dtype": torch.float32})
        tiers = ("none", "fp8_e4m3") if case in FP8_CASES else ("none",)
        phases.append(dict(
            threads=1, init=dict(mesh_shape=MESHES[case][0],
                                 axis_names=MESHES[case][1]),
            scenarios=[dict(name=f"{case}_{tier}", kind="mp_fused", cfg=cfg,
                            params=_params(case), batches=_batches(),
                            knobs=_knobs(tier)) for tier in tiers]))
    return phases


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    """One 4-rank gloo world runs every mesh while the tests compute the
    JAX side; ``load(name, rank)`` joins it on first use."""
    load = workers.run_phases(4, _phases(),
                              tmp_path_factory.mktemp("fused_mesh"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


@functools.lru_cache(maxsize=None)
def _jax_run(case, fused, tier="none"):
    """Two steps of the JAX flagship step on the case's mesh of
    ``jax.devices()[:4]``: the unfused step with optax.sgd, or the fused
    one with distributed_apply(EpilogueSGD). Returns the initial
    parameters, the losses, the parameters after each step and, at a
    lossy tier, each rank's slice of the residual after the first."""
    cfg = jtfm.TransformerConfig(**_jkw(case))
    mesh = jtp.mesh_for(*MESHES[case])
    for k, v in _knobs(tier).items():
        jknobs.set_override(k, v)
    try:
        if fused:
            da = JD.distributed_apply(JD.EpilogueSGD(LR, momentum=MOMENTUM),
                                      sync_axes=jtfm.grad_sync_axes(cfg),
                                      mesh=mesh)
            init_fn, step = jtrainer.make_transformer_train_step_fused(
                cfg, da, mesh)
        else:
            init_fn, step = jtrainer.make_transformer_train_step(
                cfg, optax.sgd(LR, momentum=MOMENTUM), mesh)
        state = init_fn(jax.random.PRNGKey(0))
        out = {"initial": [np.asarray(x) for x in
                           jax.tree.leaves(state.params)],
               "losses": [], "params": [], "residual": None}
        for t, (tokens, labels) in enumerate(_batches()):
            state, loss = step(state, jnp.asarray(tokens),
                               jnp.asarray(labels))
            out["losses"].append(float(loss))
            out["params"].append([np.asarray(x) for x in
                                  jax.tree.leaves(state.params)])
            if t == 0 and tier != "none":
                out["residual"] = [_per_rank(r) for r in jax.tree.leaves(
                    state.opt_state.residual)]
    finally:
        for k in _knobs(tier):
            jknobs.clear_override(k)
    return out


def _per_rank(arr):
    """Rank r's residual: the one row of the shard on ``jax.devices()[r]``
    (the leading dim is the leaf's sync world, sharded over its sync
    axes; the rest follows the parameter's own sharding)."""
    devs = jax.devices()[:4]
    rows = {devs.index(s.device): np.asarray(s.data)
            for s in arr.addressable_shards}
    assert all(r.shape[0] == 1 for r in rows.values())
    return [rows[r][0] for r in range(4)]


def _sync_worlds(case):
    """Each leaf's sync world: the product of its sync axes' sizes."""
    cfg = jtfm.TransformerConfig(**_jkw(case))
    size = dict(zip(MESHES[case][1], MESHES[case][0]))
    sync = jax.tree.leaves(jtfm.grad_sync_axes(cfg),
                           is_leaf=lambda x: isinstance(x, tuple))
    return [int(np.prod([size[a] for a in axes])) for axes in sync]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _port_params(out, t, n):
    return [out[f"p{t}|{i}"] for i in range(n)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_step_matches_jax_unfused_step(port_world, case):
    ref = _jax_run(case, False)
    n = len(ref["initial"])
    for rank in range(4):
        out = port_world(f"{case}_none", rank)
        _close(out["losses"], ref["losses"], f"{case} losses, rank {rank}")
        for t in range(N_STEPS):
            for i, (g, w) in enumerate(zip(_port_params(out, t, n),
                                           ref["params"][t])):
                _close(g, w, f"{case} step {t} leaf {i}, rank {rank}")
        # one autograd graph a step: every leaf's hook fired once
        assert out["hook_fires"].tolist() == [1] * n, out["hook_fires"]


def test_fused_step_on_sequence_parallelism_matches_jax_fused_step(
        port_world):
    """On (dp 2, sp 2) every leaf syncs over the whole mesh, so the JAX
    fused step's divisor is W and the two fused steps agree."""
    ref = _jax_run("sp", True)
    n = len(ref["initial"])
    for rank in range(4):
        out = port_world("sp_none", rank)
        _close(out["losses"], ref["losses"], f"losses, rank {rank}")
        for t in range(N_STEPS):
            for i, (g, w) in enumerate(zip(_port_params(out, t, n),
                                           ref["params"][t])):
                _close(g, w, f"step {t} leaf {i}, rank {rank}")


def test_jax_fused_step_doubles_tensor_parallel_updates():
    """A fault of the reference, held so that a repair shows: on (dp 2,
    tp 2) the JAX fused step's first update of every leaf sharded over tp
    (synced over dp alone) is exactly twice the JAX unfused step's, and
    equal to it on the leaves synced over both axes. Both take their
    first SGD-with-momentum step, ``-lr * g``."""
    fused, plain = _jax_run("tp", True), _jax_run("tp", False)
    worlds = _sync_worlds("tp")
    assert sorted(set(worlds)) == [2, 4]
    for i, (w, p0, pf, pu) in enumerate(zip(
            worlds, plain["initial"], fused["params"][0],
            plain["params"][0])):
        np.testing.assert_allclose(
            pf - p0, (pu - p0) * (4 // w), rtol=1e-4,
            atol=1e-3 * float(np.max(np.abs(pu - p0))),
            err_msg=f"leaf {i}, synced over {w} ranks")


def _assert_flips(got, want, what):
    """The fused fp8 step's limits: at most FLIP_SHARE of the values
    differ by more than NARROW of the leaf's largest value (at least 1),
    all within FLIP_REL of it."""
    top = max(1.0, float(np.max(np.abs(want))))
    diff = np.abs(got - want)
    assert np.mean(diff > NARROW * top) <= FLIP_SHARE, what
    assert float(diff.max()) <= FLIP_REL * top, (what, float(diff.max()))


@pytest.mark.parametrize("case", FP8_CASES)
def test_fused_fp8_step_matches_jax_fused_wire(port_world, case):
    ref = _jax_run(case, True, "fp8_e4m3")
    n = len(ref["initial"])
    worlds = _sync_worlds(case)
    for rank in range(4):
        out = port_world(f"{case}_fp8_e4m3", rank)
        assert np.all(np.isfinite(out["losses"])), out["losses"]
        if case == "sp":
            np.testing.assert_allclose(out["losses"], ref["losses"],
                                       rtol=F32, atol=F32,
                                       err_msg=f"losses, rank {rank}")
        for i in range(n):
            diff = np.abs(out[f"r|{i}"] - ref["residual"][i][rank])
            assert np.mean(diff <= F32) >= RESIDUAL_SHARE, (rank, i)
            p0 = ref["initial"][i]
            want = p0 + (ref["params"][0][i] - p0) * (worlds[i] / 4)
            _assert_flips(out[f"p0|{i}"], want,
                          f"{case} leaf {i} (sync world {worlds[i]}), "
                          f"rank {rank}")
