"""The port's model parallelism against the JAX package, on the CPU.

Every mesh of ``tests/test_transformer_parallel.py`` (DP, TP, SP ring and
Ulysses, EP, PP and dp x tp x sp) replayed against the port: the same
``BASE`` configuration, the same batch and the JAX weights, f32. The
port's side is ONE 8-rank gloo world (``test_torch_workers.run_phases``:
a phase per mesh shape, each ``init(mesh_shape=, axis_names=)`` on the
same process group) in which every rank takes its shard of the weights
(``shard_params``) and its block of the batch (``shard_batch``), binds
the configuration's axes and runs ``loss_fn``, the backward and
``sync_gradients``; the gradients come back whole through
``gather_params``. They are held leaf by leaf against the JAX sharded
step under ``shard_map`` and against the unsharded step, within the JAX
file's own tolerances (loss rtol 1e-5, 1e-4 for EP; gradients atol 2e-4,
5e-4 for EP, rtol 2e-3). The same world holds ``moe_ffn`` and
``pipeline_apply`` alone against the JAX functions under ``shard_map``,
and eight Adam steps of ``make_transformer_train_step`` on the (dp 2, tp
4) mesh against the JAX trainer's.
"""

import functools
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as JP

from horovod_tpu.eager import shard_map
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import moe as jmoe
from horovod_tpu.parallel import pipeline as jpipe
from horovod_tpu.parallel import trainer as jtrainer
import horovod_tpu_torch as htt
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.utils import tree as tree_util
import test_torch_workers as workers
import test_transformer_parallel as jtp

LIMIT_S = 170
MESHES = {
    "dp": ((8,), ("dp",)),
    "tp": ((2, 4), ("dp", "tp")),
    "sp": ((2, 4), ("dp", "sp")),
    "ep": ((2, 4), ("dp", "ep")),
    "pp": ((2, 4), ("dp", "pp")),
    "dp_tp_sp": ((2, 2, 2), ("dp", "tp", "sp")),
}
# name -> (mesh, config kwargs beyond BASE, loss rtol, grad atol)
EP_KW = dict(num_experts=4, capacity_factor=4.0, moe_aux_weight=0.0)
CASES = {
    "dp": ("dp", dict(dp_axis="dp"), 1e-5, 2e-4),
    "tp": ("tp", dict(dp_axis="dp", tp_axis="tp"), 1e-5, 2e-4),
    "sp_ring": ("sp", dict(dp_axis="dp", sp_axis="sp", attention="ring"),
                1e-5, 2e-4),
    "sp_ulysses": ("sp", dict(dp_axis="dp", sp_axis="sp",
                              attention="ulysses"), 1e-5, 2e-4),
    "ep": ("ep", dict(dp_axis="dp", ep_axis="ep", **EP_KW), 1e-4, 5e-4),
    "pp": ("pp", dict(dp_axis="dp", pp_axis="pp", n_microbatches=2,
                      n_layers=4), 1e-5, 2e-4),
    "dp_tp_sp": ("dp_tp_sp", dict(dp_axis="dp", tp_axis="tp",
                                  sp_axis="sp"), 1e-5, 2e-4),
}
TRAIN_STEPS, TRAIN_LR = 8, 1e-2


@pytest.fixture(scope="module", autouse=True)
def _limit():
    def expired(*_):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")
    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _kw(case):
    """(JAX kwargs, port kwargs) of a case: BASE plus its own fields."""
    _, extra, _, _ = CASES[case]
    jkw = {**jtp.BASE, **extra}
    pkw = {**jkw, "dtype": torch.float32}
    return jkw, pkw


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _global_params(jkw):
    cfg = jtfm.TransformerConfig(**{**jkw, "dp_axis": None, "tp_axis": None,
                                    "sp_axis": None, "ep_axis": None,
                                    "pp_axis": None})
    return _np(jtfm.init_params(cfg, jax.random.PRNGKey(7)))


def _moe_inputs():
    rng = np.random.RandomState(3)
    d, f, e = 16, 24, 8
    return dict(x=rng.randn(8, 6, d).astype(np.float32),
                ct=rng.randn(8, 6, d).astype(np.float32),
                router=rng.randn(d, e).astype(np.float32),
                w_in=(rng.randn(e, d, f) / 4).astype(np.float32),
                w_out=(rng.randn(e, f, d) / 5).astype(np.float32),
                capacity_factor=1.0)


def _pipe_inputs():
    rng = np.random.RandomState(4)
    return dict(x=rng.randn(3, 2, 8).astype(np.float32),
                w=(rng.randn(4, 8, 8) / 3).astype(np.float32),
                ct=rng.randn(3, 2, 8).astype(np.float32))


def _phases():
    tokens, labels = (np.asarray(a) for a in jtp.make_batch())
    phases = {m: [] for m in MESHES}
    for case, (mesh, _, _, _) in CASES.items():
        jkw, pkw = _kw(case)
        phases[mesh].append(dict(
            name=case, kind="mp_grads", cfg=htt.TransformerConfig(**pkw),
            params=_global_params(jkw), tokens=tokens, labels=labels))
    jkw, pkw = _kw("tp")
    phases["tp"].append(dict(
        name="train", kind="mp_train", cfg=htt.TransformerConfig(**pkw),
        params=_np(jtfm.init_params(jtfm.TransformerConfig(**jkw),
                                    jax.random.PRNGKey(0))),
        tokens=tokens, labels=labels, steps=TRAIN_STEPS, lr=TRAIN_LR))
    phases["ep"].append(dict(name="moe", kind="moe", axes=("dp", "ep"),
                             batch_axes=("dp", "ep"), **_moe_inputs()))
    phases["pp"].append(dict(name="pipeline", kind="pipeline",
                             **_pipe_inputs()))
    return [dict(threads=1, init=dict(mesh_shape=MESHES[m][0],
                                      axis_names=MESHES[m][1]),
                 scenarios=sc) for m, sc in phases.items()]


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    """One 8-rank gloo world runs every phase while the tests compute the
    JAX side; ``load(name, rank)`` joins it on first use."""
    load = workers.run_phases(8, _phases(),
                              tmp_path_factory.mktemp("model_parallel"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


@functools.lru_cache(maxsize=None)
def _reference(ref_items):
    """``jtp.reference_loss_and_grads`` under jit, once per configuration
    (the DP, TP, SP and dp x tp x sp cases share BASE's)."""
    kw = dict(ref_items)
    cfg = jtfm.TransformerConfig(dp_axis=None, **kw)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(7))
    tokens, labels = jtp.make_batch()
    return jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(cfg, p, tokens, labels)))(params)


def _assert_grads(ref, got, atol, rtol=2e-3, what=""):
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref), got):
        np.testing.assert_allclose(
            g, np.asarray(r), atol=atol, rtol=rtol,
            err_msg=f"{what} grad mismatch at {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_matches_jax_sharded_and_unsharded(port_world, case):
    mesh_name, extra, loss_rtol, atol = CASES[case]
    jkw, _ = _kw(case)
    ref_kw = {k: v for k, v in jkw.items()
              if k not in ("dp_axis", "tp_axis", "sp_axis", "ep_axis",
                           "pp_axis", "attention", "n_microbatches")}
    ref_loss, ref_grads = _reference(tuple(sorted(ref_kw.items())))
    shape, names = MESHES[mesh_name]
    loss, grads = jtp.sharded_loss_and_grads(
        jtfm.TransformerConfig(**jkw), jtp.mesh_for(shape, names))
    n_leaves = len(jax.tree.leaves(ref_grads))
    for rank in (0, 7):
        out = port_world(case, rank)
        got = [out[f"g|{i}"] for i in range(n_leaves)]
        np.testing.assert_allclose(float(out["loss"]), float(ref_loss),
                                   rtol=loss_rtol)
        np.testing.assert_allclose(float(out["loss"]), float(loss),
                                   rtol=loss_rtol)
        _assert_grads(ref_grads, got, atol, what=f"unsharded, rank {rank}")
        _assert_grads(grads, got, atol, what=f"sharded, rank {rank}")


def test_full_train_step_matches_jax_and_loss_decreases(port_world):
    jkw, _ = _kw("tp")
    cfg = jtfm.TransformerConfig(**jkw)
    init_fn, step = jtrainer.make_transformer_train_step(
        cfg, optax.adam(TRAIN_LR), jtp.mesh_for(*MESHES["tp"]))
    state = init_fn(jax.random.PRNGKey(0))
    tokens, labels = jtp.make_batch()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, tokens, labels)
        losses.append(float(loss))
    want = jax.tree.leaves(state.params)
    for rank in (0, 5):
        out = port_world("train", rank)
        assert int(out["step"]) == TRAIN_STEPS
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)
        assert out["losses"][-1] < out["losses"][0] - 0.5, out["losses"]
        for i, w in enumerate(want):
            np.testing.assert_allclose(out[f"p|{i}"], np.asarray(w),
                                       atol=2e-4, rtol=2e-3,
                                       err_msg=f"rank {rank} leaf {i}")


def _per_device(fn, mesh, in_specs, stack_axes):
    """fn under shard_map, every output stacked per device along a new
    leading dim (device order = rank order)."""
    def f(*args):
        return jax.tree.map(lambda y: y[None], fn(*args))
    return jax.jit(shard_map(f, mesh, in_specs=in_specs,
                             out_specs=JP(stack_axes)))


def test_moe_ffn_alone_matches_jax(port_world):
    inp = _moe_inputs()
    mesh = jtp.mesh_for(*MESHES["ep"])
    cf = inp["capacity_factor"]

    def local(x, ct, router, w_in, w_out):
        def loss(x, router, w_in, w_out):
            y, met = jmoe.moe_ffn(x, router, w_in, w_out, ep_axis="ep",
                                  capacity_factor=cf)
            return jnp.sum(y * ct) + met.aux_loss, (y, met)
        (_, (y, met)), g = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True)(x, router, w_in, w_out)
        return (y, met.aux_loss, met.dropped_fraction) + tuple(g)

    fn = _per_device(local, mesh, (JP(("dp", "ep")), JP(("dp", "ep")), JP(),
                                   JP("ep"), JP("ep")), ("dp", "ep"))
    res = fn(*(jnp.asarray(inp[k]) for k in ("x", "ct", "router", "w_in",
                                             "w_out")))
    names = ("out", "aux", "dropped", "d|x", "d|router", "d|w_in",
             "d|w_out")
    for rank in range(8):
        got = port_world("moe", rank)
        for n, want in zip(names, res):
            np.testing.assert_allclose(got[n], np.asarray(want[rank]),
                                       atol=1e-5, rtol=1e-4,
                                       err_msg=f"moe {n}, rank {rank}")
    assert float(port_world("moe", 0)["dropped"]) > 0   # capacity binds


def test_pipeline_apply_alone_matches_jax(port_world):
    inp = _pipe_inputs()
    mesh = jtp.mesh_for(*MESHES["pp"])

    def local(x, w, ct):
        def loss(x, w):
            y = jpipe.pipeline_apply(lambda mb: jnp.tanh(mb @ w[0]), x, "pp")
            return jnp.sum(y * ct), y
        (_, y), (dx, dw) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(x, w)
        return y, dx, dw[0]

    fn = _per_device(local, mesh, (JP(), JP("pp"), JP()), ("dp", "pp"))
    res = fn(*(jnp.asarray(inp[k]) for k in ("x", "w", "ct")))
    for rank in range(8):
        got = port_world("pipeline", rank)
        for n, want in zip(("out", "dx", "dw"), res):
            np.testing.assert_allclose(got[n], np.asarray(want[rank]),
                                       atol=1e-5, rtol=1e-4,
                                       err_msg=f"pipeline {n}, rank {rank}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_specs_and_sync_axes_match_jax(case):
    jkw, pkw = _kw(case)
    jcfg, cfg = jtfm.TransformerConfig(**jkw), htt.TransformerConfig(**pkw)
    jspecs = jax.tree.leaves(jtfm.param_specs(jcfg),
                             is_leaf=lambda x: isinstance(x, JP))
    specs = tree_util.tree_leaves(tfm.param_specs(cfg))
    assert [tuple(s) for s in jspecs] == [tuple(s) for s in specs]
    assert tuple(jtfm.batch_spec(jcfg)) == tuple(tfm.batch_spec(cfg))
    assert jax.tree.leaves(jtfm.grad_sync_axes(jcfg),
                           is_leaf=lambda x: isinstance(x, tuple)) == \
        tree_util.tree_leaves(tfm.grad_sync_axes(cfg))
    assert jtfm.mesh_axes(jcfg) == tfm.mesh_axes(cfg)


def test_fused_step_needs_its_axes_on_the_mesh():
    cfg = htt.TransformerConfig(**{**jtp.BASE, "dtype": torch.float32},
                                dp_axis="dp", tp_axis="tp")
    htt.init(device="cpu")
    try:
        da = htt.distributed_apply(htt.EpilogueSGD(0.1),
                                   sync_axes=tfm.grad_sync_axes(cfg))
        init_fn, _ = htt.make_transformer_train_step_fused(cfg, da,
                                                           device="cpu")
        params = htt.init_params(cfg, device="cpu")
        with pytest.raises(ValueError, match="axis_names"):
            init_fn(params)
    finally:
        htt.shutdown()


def test_a_model_parallel_step_needs_its_axes_on_the_mesh():
    cfg = htt.TransformerConfig(**{**jtp.BASE, "dtype": torch.float32},
                                dp_axis="dp", tp_axis="tp")
    htt.init(device="cpu")
    try:
        init_fn, _ = htt.make_transformer_train_step(
            cfg, lambda ps: torch.optim.SGD(ps, lr=0.1), device="cpu")
        params = htt.init_params(cfg, device="cpu")
        with pytest.raises(ValueError, match="axis_names"):
            init_fn(params)
    finally:
        htt.shutdown()
