"""The rest of Horovod's PyTorch API in the port against the JAX package,
on the CPU: the shape-changing collectives on ragged process sets, the
state and object broadcasts, ``SyncBatchNorm`` and the callbacks.

One spawned 8-rank gloo world (``test_torch_workers.phase_worker``) runs
every multi-rank case: the eager process-set cases of
``tests/test_process_sets.py`` and ragged ones ([0, 1, 2], which the JAX
package's eager layer runs host-mediated) against the same calls on the
JAX eager API (``test_torch_eager.run_jax``); ``tests/test_distributed_
optimizer.py::test_broadcast_parameters_and_objects``, with optimizer
state that only the root has; the four cases of
``tests/test_sync_batch_norm.py`` on each rank's rows against the JAX
functions under shard_map on 8 devices; the callback cases of
``tests/test_callbacks_data.py`` (l.17-57); and
``distributed_value_and_grad`` (``tests/test_distributed_optimizer.py:
124``). The pure schedules are
compared in one process. Tolerances: data movement, integers and the
broadcasts bitwise; the batch-norm statistics and outputs within 1e-5 of
the largest value.
"""

import json
import signal

import flax.core
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu import callbacks as jcb
from horovod_tpu.eager import shard_map
from horovod_tpu.sync_batch_norm import (SyncBatchNorm, sync_batch_norm,
                                         sync_batch_norm_stats)
from horovod_tpu_torch import callbacks as cb
import test_torch_workers as workers
from test_torch_eager import check, port_outs, run_jax

W = 8
LIMIT_S = 150
TOL = 1e-5
SETS = [[0, 1, 2], [0, 2], [2, 5, 7], [0, 1, 2, 3], [1, 3, 5, 7]]
BATCHES = [3, 3, 3, 2, 3, 3, 3, 2]


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
# inputs
# ---------------------------------------------------------------------------

def _rows(width=2):
    return np.stack([np.full((width,), r, np.float32) for r in range(W)])


def _a2a(k):
    x = np.zeros((W, k, 2), np.float32)
    for r in range(W):
        for d in range(k):
            x[r, d] = r * 10 + d
    return x


def _rs(rows):
    return np.random.RandomState(0).randint(-9, 9, (W, rows, 2)).astype(
        np.float32)


def _splits():
    """Rank r of [0, 1, 2] sends (r + d) % 3 + 1 rows to member d: the
    port's per-rank vectors and the JAX package's world matrix."""
    m = np.zeros((W, W), np.int64)
    for r in range(3):
        for d in range(3):
            m[r, d] = (r + d) % 3 + 1
    rows = [np.zeros((int(m[r].sum()), 2), np.float32) + 100 * r
            + np.arange(int(m[r].sum()))[:, None] for r in range(W)]
    return [m[r, :3] for r in range(W)], m, rows


SPLIT_ROWS, SPLIT_MATRIX, SPLIT_PARTS = _splits()
RAGGED = {
    "ag_ragged": [dict(fn="allgather", ps=0, args=[_rows()], out="o",
                       cmp="members", members=SETS[0])],
    "ag_ragged_async": [dict(fn="allgather_async", ps=0, args=[_rows(3)],
                             save="h"),
                        dict(fn="synchronize", ref="h", out="o",
                             cmp="members", members=SETS[0],
                             own=[_rows(3)])],
    "ag_02": [dict(fn="allgather", ps=1, args=[_rows()], out="o",
                   cmp="members", members=SETS[1])],
    "a2a_ragged": [dict(fn="alltoall", ps=0, args=[_a2a(3)], out="o",
                        cmp="set", members=SETS[0])],
    "a2a_uniform": [dict(fn="alltoall", ps=3, args=[_a2a(4)], out="o",
                         cmp="set", members=SETS[3], others="skip")],
    "rs_ragged_sum": [dict(fn="reducescatter", ps=0, args=[_rs(6)],
                           kw={"op": "SUM"}, out="o", cmp="set",
                           members=SETS[0])],
    "rs_ragged_uneven": [dict(fn="reducescatter_async", ps=0,
                              args=[_rs(7)], kw={"op": "AVERAGE"},
                              save="h"),
                         dict(fn="synchronize", ref="h", out="o", cmp="set",
                              members=SETS[0], own=[_rs(7)], tol=1e-6)],
    "rs_1357": [dict(fn="reducescatter", ps=4, args=[_rs(8)],
                     kw={"op": "SUM"}, out="o", cmp="set",
                     members=SETS[4])],
    "bc_257": [dict(fn="broadcast", ps=2, args=[_rows()],
                    kw={"root_rank": 1}, out="o", cmp="rank")],
}
SPLITS_STEP = dict(fn="alltoall", ps=0, args=[SPLIT_PARTS],
                   rank_kw={"splits": SPLIT_ROWS},
                   jax_kw={"splits": SPLIT_MATRIX}, out="o")
RAGGED["a2a_ragged_splits"] = [SPLITS_STEP]


def _bn_inputs():
    rng = np.random.RandomState(0)
    glob = (rng.randn(W * 4, 3).astype(np.float32) * 3 + 1.5)
    rng = np.random.RandomState(1)
    counts = np.arange(1, W + 1)
    padded = np.zeros((W, 8, 2), np.float32)
    for r in range(W):
        padded[r, :counts[r]] = rng.randn(counts[r], 2) * 2 + 1
    module = np.random.RandomState(2).randn(W * 2, 4).astype(
        np.float32) * 2 + 3
    rng = np.random.RandomState(3)
    grad = rng.randn(W, 2, 3).astype(np.float32)
    cot = rng.randn(W, 2, 3).astype(np.float32)
    return dict(global_=glob.reshape(W, 4, 3), padded=padded,
                counts=counts, module=module.reshape(W, 2, 4),
                grad=grad, cot=cot)


BN = _bn_inputs()
VG_X = np.arange(W, dtype=np.float32).reshape(W, 1) + 1.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("api")
    scenarios = [dict(kind="eager", name=n, steps=s)
                 for n, s in RAGGED.items()]
    scenarios += [
        dict(kind="objects", name="objects", batches=BATCHES),
        dict(kind="sync_bn", name="sync_bn", **{
            "global": BN["global_"], "padded": BN["padded"],
            "counts": BN["counts"], "module": BN["module"],
            "grad": BN["grad"], "cot": BN["cot"]}),
        dict(kind="callbacks", name="callbacks", dir=str(out)),
        dict(kind="value_and_grad", name="value_and_grad", x=VG_X)]
    load = workers.run_phases(W, [dict(sets=SETS, scenarios=scenarios)], out)
    yield load
    if not load.joined:
        workers.join_world(load.procs)


# ---------------------------------------------------------------------------
# ragged process sets
# ---------------------------------------------------------------------------

RAGGED_CASES = sorted(k for k in RAGGED if k != "a2a_ragged_splits")


@pytest.mark.parametrize("name", RAGGED_CASES)
def test_shape_changing_collectives_on_process_sets(world, name):
    """Members get the JAX eager result (set-stacked results by member
    index), the other ranks of a ragged set their own value; on the
    aligned [0, 1, 2, 3] the members' results only (the other ranks run
    in their sibling group)."""
    check(port_outs(world, name), run_jax(RAGGED[name], SETS), RAGGED[name])


def test_alltoall_with_splits_on_a_ragged_set(world):
    outs, recv = run_jax([SPLITS_STEP], SETS)["o"]
    port = port_outs(world, "a2a_ragged_splits")
    for j, r in enumerate(SETS[0]):
        np.testing.assert_array_equal(port[r]["o|0"], np.asarray(outs[j]))
        np.testing.assert_array_equal(port[r]["o|1"], np.asarray(recv)[j])
    for r in range(3, W):
        np.testing.assert_array_equal(port[r]["o|0"], SPLIT_PARTS[r])


# ---------------------------------------------------------------------------
# broadcasts and objects (tests/test_distributed_optimizer.py:144)
# ---------------------------------------------------------------------------

def test_broadcast_parameters_and_objects(world):
    """Every rank ends with root's tree (root 0), root's module
    parameters and buffers (root 1), root's Adam state (keys, shapes and
    values, which only root had) and learning rate, root's object (root
    2), and every rank's object in rank order. The JAX package's
    single-process forms (the object itself, ``[obj]``) are rank-local
    because it has one process."""
    hvd.init(devices=jax.devices()[:W])
    try:
        st = optax.adam(1e-3).init({"w": jnp.ones((2,))})
        out_st = hvd.broadcast_optimizer_state(st)
        assert jax.tree.structure(out_st) == jax.tree.structure(st)
        obj = {"epoch": 3, "name": "x"}
        assert hvd.broadcast_object(obj) == obj
        assert hvd.allgather_object(obj) == [obj]
    finally:
        hvd.shutdown()
    port = port_outs(world, "objects")
    root1 = workers._seeded_module(1).state_dict()
    for r in range(W):
        res = port[r]
        np.testing.assert_array_equal(res["tree|a"], np.zeros(3))
        np.testing.assert_array_equal(res["tree|b|c"], np.full((2, 2), 0.5))
        for k, v in root1.items():
            np.testing.assert_array_equal(res[f"module|{k}"], v.numpy())
        assert float(res["opt|lr"]) == 0.05
        keys = sorted(k for k in res if k.startswith("opt|") and k != "opt|lr")
        assert keys == sorted(k for k in port[0] if k.startswith("opt|")
                              and k != "opt|lr")
        assert {k.split("|")[2] for k in keys} == {"exp_avg", "exp_avg_sq",
                                                   "step"}
        for k in keys:
            np.testing.assert_array_equal(res[k], port[0][k], err_msg=k)
        assert json.loads(str(res["object"])) == {"epoch": 3, "name": "x",
                                                  "rank": 2}
        assert json.loads(str(res["gathered"])) == [
            {"rank": q, "batches": BATCHES[q]} for q in range(W)]


# ---------------------------------------------------------------------------
# SyncBatchNorm (tests/test_sync_batch_norm.py)
# ---------------------------------------------------------------------------

def _mesh():
    return Mesh(np.array(jax.devices()[:W]), ("hvd",))


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


def test_sync_bn_matches_global_batch(world):
    f = jax.jit(shard_map(lambda xs: sync_batch_norm(xs[0], "hvd"),
                          _mesh(), in_specs=P("hvd"),
                          out_specs=(P("hvd"), P(), P())))
    y, mean, var = f(jnp.asarray(BN["global_"]))
    y = np.asarray(y).reshape(W, 4, 3)
    for r in range(W):
        res = world("sync_bn", r)
        _close(res["global|y"], y[r], f"y rank {r}")
        _close(res["global|mean"], mean, f"mean rank {r}")
        _close(res["global|var"], var, f"var rank {r}")


def test_sync_bn_count_aware_uneven_batches(world):
    def per_shard(xs, cnt):
        return sync_batch_norm_stats(xs[0], "hvd", reduce_dims=(0,),
                                     count=cnt[0])

    mean, var = jax.jit(shard_map(per_shard, _mesh(),
                                  in_specs=(P("hvd"), P("hvd")),
                                  out_specs=(P(), P())))(
        jnp.asarray(BN["padded"]), jnp.asarray(BN["counts"], jnp.float32))
    valid = np.concatenate([BN["padded"][r, :BN["counts"][r]]
                            for r in range(W)])
    np.testing.assert_allclose(np.asarray(mean), valid.mean(0), rtol=1e-5)
    for r in range(W):
        res = world("sync_bn", r)
        _close(res["counts|mean"], mean, f"mean rank {r}")
        _close(res["counts|var"], var, f"var rank {r}")


def test_sync_bn_module_train_and_eval(world):
    model = SyncBatchNorm(axis_name="hvd", momentum=0.5)
    x = jnp.asarray(BN["module"].reshape(W * 2, 4))
    mesh = _mesh()
    variables = jax.jit(shard_map(
        lambda xs: model.init(jax.random.PRNGKey(0), xs), mesh,
        in_specs=P("hvd"), out_specs=P()))(x)
    y, mut = jax.jit(shard_map(
        lambda v, xs: model.apply(v, xs, mutable=["batch_stats"]), mesh,
        in_specs=(P(), P("hvd")), out_specs=(P("hvd"), P())))(variables, x)
    variables = flax.core.unfreeze(variables)
    variables["batch_stats"] = mut["batch_stats"]
    y_eval = jax.jit(shard_map(
        lambda v, xs: model.apply(v, xs, use_running_average=True), mesh,
        in_specs=(P(), P("hvd")), out_specs=P("hvd")))(variables, x)
    y, y_eval = (np.asarray(a).reshape(W, 2, 4) for a in (y, y_eval))
    for r in range(W):
        res = world("sync_bn", r)
        _close(res["module|y"], y[r], f"y rank {r}")
        _close(res["module|mean"], mut["batch_stats"]["mean"], "mean")
        _close(res["module|var"], mut["batch_stats"]["var"], "var")
        _close(res["module|y_eval"], y_eval[r], f"y_eval rank {r}")


def test_sync_bn_differentiable(world):
    """Gradients flow through the cross-rank statistics. The JAX test's
    loss, the sum over ranks of sum(y^2), is invariant to a rescale of x,
    so its gradient is finite and orthogonal to x (rounding noise, as in
    JAX); the gradient of sum(y * cot), which is not, is held to the JAX
    gradient of each rank's rows."""
    mesh = _mesh()
    x, cot = jnp.asarray(BN["grad"]), jnp.asarray(BN["cot"])

    def loss(xs):
        per = shard_map(lambda a, c: jnp.sum(sync_batch_norm(
            a[0], "hvd")[0] * c[0])[None], mesh, in_specs=(P("hvd"),
                                                       P("hvd")),
            out_specs=P("hvd"))(xs, cot)
        return jnp.sum(per)

    g = np.asarray(jax.jit(jax.grad(loss))(x))
    for r in range(W):
        res = world("sync_bn", r)
        assert np.all(np.isfinite(res["grad|x"]))
        _close(res["grad|xc"], g[r], f"grad rank {r}")
    inner = sum(float(np.sum(world("sync_bn", r)["grad|x"] * BN["grad"][r]))
                for r in range(W))
    assert abs(inner) < 1e-2, inner


# ---------------------------------------------------------------------------
# callbacks (tests/test_callbacks_data.py:17-57)
# ---------------------------------------------------------------------------

def test_warmup_schedule_ramps():
    for mod in (cb, jcb):
        sched = mod.warmup_schedule(0.8, warmup_steps=10,
                                    initial_multiplier=1 / 8)
        assert float(sched(0)) == pytest.approx(0.1)
        assert float(sched(10)) == pytest.approx(0.8)
        assert float(sched(100)) == pytest.approx(0.8)
        assert float(sched(5)) == pytest.approx(0.8 * (1 / 8) ** 0.5)
    port, jax_ = (mod.warmup_schedule(0.8, 10) for mod in (cb, jcb))
    for step in range(12):
        assert port(step) == pytest.approx(float(jax_(step)), rel=1e-6)


def test_scaled_lr(world):
    hvd.init(devices=jax.devices()[:W])
    try:
        want = jcb.scaled_lr(0.1)
    finally:
        hvd.shutdown()
    for r in range(W):
        assert float(world("callbacks", r)["scaled_lr"]) == \
            pytest.approx(want)


def test_metric_average_callback(world):
    """A metric all ranks share stays (the JAX test's 4.0); one that
    differs becomes the mean over the ranks."""
    hvd.init(devices=jax.devices()[:W])
    try:
        logs = {"metrics": {"loss": 4.0}}
        jcb.MetricAverageCallback().on_epoch_end(0, logs)
        want = float(np.asarray(logs["metrics"]["loss"]))
    finally:
        hvd.shutdown()
    for r in range(W):
        res = world("callbacks", r)
        assert float(res["loss"]) == want == 4.0
        assert float(res["acc"]) == pytest.approx(np.mean(range(W)))


def test_lr_warmup_callback():
    for mod in (cb, jcb):
        c = mod.LearningRateWarmupCallback(1.0, warmup_epochs=4,
                                           initial_multiplier=1 / 16)
        logs = {}
        c.on_epoch_begin(0, logs)
        assert logs["lr"] == pytest.approx(1 / 16)
        c.on_epoch_begin(4, logs)
        assert logs["lr"] == pytest.approx(1.0)


def test_best_model_checkpoint(world):
    """Rank 0 alone saves on improvement and keeps the file on a worse
    value."""
    for r in range(W):
        res = world("callbacks", r)
        assert bool(res["best|saved"]) == (r == 0)
        assert bool(res["best|unchanged"])


def test_broadcast_callback(world):
    """Rank 0's module and learning rate on every rank."""
    w0 = workers._seeded_module(0).weight.detach().numpy()
    for r in range(W):
        res = world("callbacks", r)
        np.testing.assert_array_equal(res["broadcast|weight"], w0)
        assert float(res["broadcast|lr"]) == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# distributed_value_and_grad (tests/test_distributed_optimizer.py:124)
# ---------------------------------------------------------------------------

def test_distributed_value_and_grad(world):
    """The loss and gradient averaged over ``hvd``, against the JAX
    transform under shard_map; with ``sync_axes`` a leaf marked () keeps
    this rank's gradient and the loss stays this rank's."""
    hvd.init(devices=jax.devices()[:W])
    try:
        mesh = hvd.mesh()
        vg = hvd.distributed_value_and_grad(
            lambda w, x: jnp.mean((x * w) ** 2), axis="hvd")
        loss, grad = jax.jit(shard_map(vg, mesh, in_specs=(P(), P("hvd")),
                                       out_specs=(P(), P())))(
            jnp.asarray(2.0), jnp.asarray(VG_X))
        vg2 = hvd.distributed_value_and_grad(
            lambda p, x: (jnp.mean((x * p["a"] + p["b"]) ** 2), x.sum()),
            sync_axes={"a": ("hvd",), "b": ()}, has_aux=True)
        (loss2, aux), g2 = jax.jit(shard_map(
            lambda p, x: jax.tree.map(lambda v: v[None], vg2(p, x)), mesh,
            in_specs=(P(), P("hvd")), out_specs=P("hvd")))(
            {"a": jnp.asarray(1.5), "b": jnp.asarray(-0.5)},
            jnp.asarray(VG_X))
    finally:
        hvd.shutdown()
    for r in range(W):
        res = world("value_and_grad", r)
        for got, want in ((res["loss"], loss), (res["grad"], grad),
                          (res["loss2"], loss2[r]), (res["aux"], aux[r]),
                          (res["grad|a"], g2["a"][r]),
                          (res["grad|b"], g2["b"][r])):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
