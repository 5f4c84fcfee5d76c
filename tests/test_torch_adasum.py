"""Adasum in the port (``ops/adasum.py``, ``op=Adasum`` in the eager API
and the gradient sync, ``DistributedAdasumOptimizer``) against the JAX
package's, on the CPU.

The pairwise combination is compared in one process. Everything else runs
in ONE spawned 8-rank gloo world (``test_torch_workers.phase_worker``):
on the flat mesh the eager cases of ``tests/test_collectives.py``
(``test_allreduce_adasum_matches_pairwise_reference``) and
``tests/test_join.py::test_join_with_adasum``, a grouped Adasum, and the
optimizer cases of ``tests/test_distributed_optimizer.py``
(``test_distributed_adasum_optimizer_delta_trick``, and a small MLP
trained two steps through ``DistributedAdasumOptimizer`` and through
``DistributedOptimizer(op=Adasum)``); on the (cross 2, local 4) mesh
``test_adasum_eager_on_2d_mesh`` and the hierarchical join cases of
``tests/test_join.py`` (ranks 3, 4 and 6 joined; a fully joined local
group), held to the JAX package's active-count rule. The JAX side runs
the same calls (``test_torch_eager.run_jax``, or the JAX test's
shard_map). Tolerance: 1e-5 of the largest value of each result (dot
products summed in another order); every rank's result is bitwise the
same as every other's.
"""

import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.eager import shard_map
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu_torch.ops import adasum
import test_torch_workers as workers
from test_torch_eager import check, port_outs, run_jax

W = 8
LIMIT_S = 150
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _x(cols=5, seed=0):
    return np.random.RandomState(seed).randn(W, cols).astype(np.float32)


FLAT = {
    "adasum": [dict(fn="allreduce", args=[_x()], kw={"op": "ADASUM"},
                    out="adasum", tol=TOL)],
    "join_adasum": [dict(fn="join", kw={"rank": r}, out=f"j{r}")
                    for r in (2, 5, 7)] + [
        dict(fn="allreduce", args=[_x(6)], kw={"op": "ADASUM"},
             out="adasum", tol=TOL),
        dict(fn="join", out="last"),
        dict(fn="allreduce", args=[_x(6)], kw={"op": "SUM"}, out="sum",
             tol=1e-6)],
    "grouped_adasum": [dict(fn="grouped_allreduce", args=[
        _x(5, 1), _x(3, 2), _x(4, 3)], as_list=True,
        kw={"op": "ADASUM"}, out="grouped", tol=TOL)],
}
MESH2 = {
    "adasum_2d": [dict(fn="allreduce", args=[_x(6)], kw={"op": "ADASUM"},
                       out="adasum", tol=TOL)],
    "join_adasum_2d": [dict(fn="join", kw={"rank": r}, out=f"j{r}")
                       for r in (3, 4, 6)] + [
        dict(fn="allreduce", args=[_x(6)], kw={"op": "ADASUM"},
             out="joined", tol=TOL),
        dict(fn="join", out="last"),
        dict(fn="allreduce", args=[_x(6)], kw={"op": "ADASUM"},
             out="after", tol=TOL)],
    "join_adasum_2d_full": [dict(fn="join", kw={"rank": r}, out=f"j{r}")
                            for r in range(4)] + [
        dict(fn="allreduce", args=[_x(5, 1)], kw={"op": "ADASUM"},
             out="joined", tol=TOL),
        dict(fn="join", out="last")],
}
LR, MOMENTUM = 0.1, 0.9


def _opt_case():
    rng = np.random.RandomState(4)
    params = {"w1": rng.randn(4, 8).astype(np.float32) * 0.5,
              "b1": rng.randn(8).astype(np.float32) * 0.1,
              "w2": rng.randn(8, 3).astype(np.float32) * 0.5,
              "b2": rng.randn(3).astype(np.float32) * 0.1}
    return dict(grads=rng.randn(W, 6).astype(np.float32), params=params,
                xs=rng.randn(W, 2, 5, 4).astype(np.float32),
                ys=rng.randn(W, 2, 5, 3).astype(np.float32),
                lr=LR, momentum=MOMENTUM)


OPT = _opt_case()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    def eager(cases):
        return [dict(kind="eager", name=n, steps=s) for n, s in cases.items()]

    phases = [dict(scenarios=eager(FLAT) + [
                   dict(kind="adasum_opt", name="opt", **OPT)]),
              dict(init={"mesh_shape": (2, 4)}, scenarios=eager(MESH2))]
    load = workers.run_phases(W, phases, tmp_path_factory.mktemp("adasum"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


def _same_on_every_rank(port, key):
    for r in range(1, W):
        np.testing.assert_array_equal(port[r][key], port[0][key],
                                      err_msg=f"{key}: rank {r} != rank 0")


def _case(world, cases, name, mesh_shape=None):
    port = port_outs(world, name)
    check(port, run_jax(cases[name], mesh_shape=mesh_shape), cases[name])
    return port


# ---------------------------------------------------------------------------
# the pairwise combination, in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pairwise_adasum_equals_jax(dtype):
    rng = np.random.RandomState(7)
    a, b = (rng.randn(33).astype(dtype) for _ in range(2))
    for x, y in ((a, b), (a, -a), (a, 2 * a), (a, np.zeros_like(a)),
                 (np.zeros_like(a), np.zeros_like(a))):
        got = adasum._pairwise_adasum(torch.from_numpy(x),
                                      torch.from_numpy(y)).numpy()
        with jax.enable_x64(dtype == "float64"):
            want = np.asarray(jadasum._pairwise_adasum(jnp.asarray(x),
                                                       jnp.asarray(y)))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * max(np.abs(want).max(), 1e-30))
    # orthogonal vectors add, equal ones average, zero is the identity
    e0, e1 = torch.eye(2, dtype=torch.float64)
    assert adasum._pairwise_adasum(e0, e1).tolist() == [1.0, 1.0]
    assert adasum._pairwise_adasum(e0, e0).tolist() == [1.0, 0.0]
    assert adasum._pairwise_adasum(e0, 0 * e0).tolist() == [1.0, 0.0]


def test_adasum_rejects_other_sets_and_axis_specs():
    """The checks before any exchange: a non-global process set raises
    as the JAX package's does (adasum.py:72-75), and so does an axis spec
    that is neither one axis nor a (cross, local) pair."""
    ps = type("PS", (), {"process_set_id": 3})()
    with pytest.raises(NotImplementedError, match="non-global"):
        adasum.adasum_allreduce(torch.ones(2), process_set=ps)
    with pytest.raises(ValueError, match="one mesh axis"):
        adasum.adasum_allreduce(torch.ones(2), axis=("a", "b", "c"))


# ---------------------------------------------------------------------------
# the flat butterfly
# ---------------------------------------------------------------------------

def test_allreduce_adasum_matches_jax(world):
    port = _case(world, FLAT, "adasum")
    _same_on_every_rank(port, "adasum")


def test_join_with_adasum(world):
    """Joined ranks contribute zeros, Adasum's identity on the flat
    butterfly; the next epoch sums over everyone."""
    port = _case(world, FLAT, "join_adasum")
    _same_on_every_rank(port, "adasum")
    assert int(port[0]["last"]) == 6


def test_grouped_adasum_combines_each_dtype_buffer(world):
    port = _case(world, FLAT, "grouped_adasum")
    for i in range(3):
        _same_on_every_rank(port, f"grouped|{i}")


def test_distributed_adasum_optimizer_delta_trick(world):
    """The inner SGD's local delta is Adasum-combined: from zero, the
    parameter after one step is the combined -lr * g of every rank."""
    opt = hvd.DistributedAdasumOptimizer(optax.sgd(LR), axis="hvd")
    mesh = Mesh(np.array(jax.devices()[:W]), ("hvd",))

    def per_shard(g):
        g = g.reshape((6,))
        delta, _ = opt.update(g, opt.init(jnp.zeros((6,))), jnp.zeros((6,)))
        return delta.reshape((1, 6))

    want = np.asarray(jax.jit(shard_map(per_shard, mesh, in_specs=P("hvd"),
                                        out_specs=P("hvd")))(
        jnp.asarray(OPT["grads"])))
    port = port_outs(world, "opt")
    for r in range(W):
        np.testing.assert_allclose(port[r]["delta"], want[r], rtol=0,
                                   atol=TOL * np.abs(want).max())
    _same_on_every_rank(port, "delta")


def test_distributed_adasum_optimizer_requires_axis():
    sgd = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    import horovod_tpu_torch as htt
    for make in (lambda: htt.DistributedAdasumOptimizer(sgd, axis=None),
                 lambda: hvd.DistributedAdasumOptimizer(optax.sgd(0.1),
                                                        axis=None)):
        with pytest.raises(ValueError, match="explicit mesh axis"):
            make()


def _jax_mlp(kind):
    """Two steps of the MLP per rank under shard_map on the 8-device
    ``hvd`` mesh: the parameters and the momentum trace after."""
    sgd = optax.sgd(LR, momentum=MOMENTUM)
    opt = (hvd.DistributedAdasumOptimizer(sgd, axis="hvd")
           if kind == "delta_opt"
           else hvd.DistributedOptimizer(sgd, op=hvd.Adasum, axis="hvd"))
    mesh = Mesh(np.array(jax.devices()[:W]), ("hvd",))
    params = jax.tree.map(jnp.asarray, OPT["params"])

    def per_shard(xs, ys):
        p, state = params, opt.init(params)
        for t in range(2):
            g = jax.grad(workers.mlp_loss)(p, xs[0, t], ys[0, t])
            upd, state = opt.update(g, state, p)
            p = optax.apply_updates(p, upd)
        trace = next(s.trace for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda n: hasattr(n, "trace"))
            if hasattr(s, "trace"))
        return jax.tree.map(lambda v: v[None], (p, trace))

    return jax.tree.map(np.asarray, jax.jit(shard_map(
        per_shard, mesh, in_specs=(P("hvd"), P("hvd")),
        out_specs=P("hvd")))(jnp.asarray(OPT["xs"]), jnp.asarray(OPT["ys"])))


@pytest.mark.parametrize("kind", ["delta_opt", "grad_opt"])
def test_mlp_two_steps_through_adasum(world, kind):
    """DistributedAdasumOptimizer (deltas combined) and
    DistributedOptimizer(op=Adasum) (gradients combined, per leaf), each
    over SGD with momentum: the parameters and momentum after two steps,
    bitwise the same on every rank."""
    want_p, want_m = _jax_mlp(kind)
    port = port_outs(world, "opt")
    for k in sorted(OPT["params"]):
        for what, want in (("param", want_p[k]), ("momentum", want_m[k])):
            key = f"{kind}|{what}|{k}"
            for r in range(W):
                np.testing.assert_allclose(
                    port[r][key], want[r], rtol=0,
                    atol=TOL * np.abs(want).max(), err_msg=f"{key} rank {r}")
            if what == "param":
                _same_on_every_rank(port, key)


# ---------------------------------------------------------------------------
# the hierarchical form on (cross 2, local 4)
# ---------------------------------------------------------------------------

def test_adasum_eager_on_2d_mesh(world):
    port = _case(world, MESH2, "adasum_2d", (2, 4))
    _same_on_every_rank(port, "adasum")


def test_join_with_adasum_hierarchical_mesh(world):
    """Each local group's mean divides by its ACTIVE count (the JAX
    package's adasum.py:93-111; ranks 3 | 4, 6 joined), not the diluted
    full-size mean; the next epoch combines everyone again."""
    port = _case(world, MESH2, "join_adasum_2d", (2, 4))
    x = _x(6).astype(np.float64)
    pair = jadasum._pairwise_adasum
    diluted = np.asarray(pair(jnp.asarray(x[[0, 1, 2]].sum(0) / 4),
                              jnp.asarray(x[[5, 7]].sum(0) / 4)))
    assert np.abs(port[0]["joined"] - diluted).max() > 1e-3
    _same_on_every_rank(port, "joined")


def test_join_with_adasum_hierarchical_fully_joined_group(world):
    """A local group whose every rank joined contributes zeros, which the
    cross butterfly's zero-norm guard passes over: the surviving group's
    mean comes back."""
    port = _case(world, MESH2, "join_adasum_2d_full", (2, 4))
    np.testing.assert_allclose(port[0]["joined"], _x(5, 1)[4:].mean(0),
                               rtol=0, atol=1e-6)
