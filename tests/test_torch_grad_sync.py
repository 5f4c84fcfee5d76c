"""The port's bucketed gradient sync against the JAX package, on the CPU.

Two-rank gloo worlds (``tests/test_torch_workers.py``, one spawned world
for every scenario) against the JAX package on a 2-device mesh with the
same numpy inputs: ``DistributedOptimizer`` at each wire tier on the
quadratic of ``tests/test_wire_compression.py`` (its ``w00 ... w07``
keys sort in definition order, so both plans agree), the epilogue
optimizers against ``distributed_apply``, ``backward_passes_per_step=2``
against ``optax.MultiSteps``, and ``make_transformer_train_step_fused``
on the tiny config. Then one-rank checks of the launch schedule.

Tolerances, relative to each leaf's largest value: f32 paths 1e-5; the
narrow tiers on the quadratic 1e-6 on the parameters, and on the
residuals 1e-6 of the leaf's largest gradient (the residual is the
compensated gradient minus its decode, so it carries the gradient's
rounding; the quadratic's gradient 2 sum(x) v is below 4 max|v|). One fp8
value off by one wire step would move a parameter by ~1e-3 of its
largest value, so 1e-6 holds only when every wire buffer is equal bit for
bit. The fused transformer's fp8 case is looser, see its test.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.config import knobs as jknobs
from horovod_tpu.eager import shard_map
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.ops.fusion import _plan_buckets_by_bytes as jplan
from horovod_tpu.parallel import distributed as JD
from horovod_tpu.parallel import trainer as jtrainer
import horovod_tpu_torch as htt
from horovod_tpu_torch import autotune
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.fusion import _plan_buckets_by_bytes
from horovod_tpu_torch.ops.reduce_ops import ReduceOp
from horovod_tpu_torch.parallel import distributed as D
import test_torch_workers as workers

F32 = 1e-5
NARROW = 1e-6
TIERS = ("none", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")


def _quad_params(n, base, seed):
    rng = np.random.RandomState(seed)
    return {f"w{i:02d}": rng.randn(base + i).astype(np.float32)
            for i in range(n)}


def _xs(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(2, 2).astype(np.float32) for _ in range(n)]


TINY = dict(vocab_size=256, d_model=64, n_heads=2, head_dim=32, n_layers=2,
            d_ff=128, max_seq=32)


def _tiny_params():
    cfg = jtfm.TransformerConfig(**TINY, dtype=jnp.float32, dp_axis="dp")
    return jax.tree.map(np.asarray, jtfm.init_params(cfg,
                                                     jax.random.PRNGKey(0)))


def _tiny_batches(n):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 256, (8, 32)).astype(np.int32),
             rng.randint(0, 256, (8, 32)).astype(np.int32))
            for _ in range(n)]


OPT_CASES = {f"opt_{t}": dict(tier=t) for t in TIERS}
OPT_CASES["opt_bf16_multibucket"] = dict(tier="bf16", bucket=2 * 48 * 4)
OPT_CASES["opt_fp8_e4m3_multibucket"] = dict(tier="fp8_e4m3",
                                             bucket=2 * 48 * 4)
EPI_CASES = {
    "epi_sgd": (("sgd", dict(lr=0.1, momentum=0.9)),
                lambda: JD.EpilogueSGD(0.1, momentum=0.9)),
    "epi_nesterov": (("sgd", dict(lr=0.1, momentum=0.9, nesterov=True)),
                     lambda: JD.EpilogueSGD(0.1, momentum=0.9,
                                            nesterov=True)),
    "epi_adam": (("adam", dict(lr=0.01)), lambda: JD.EpilogueAdam(0.01)),
}
FUSED_CASES = {"fused_none": "none", "fused_fp8_e4m3": "fp8_e4m3"}


def _knobs(tier, bucket=None):
    out = {"HOROVOD_GRADIENT_COMPRESSION": tier}
    if bucket is not None:
        out["HOROVOD_GRADIENT_BUCKET_BYTES"] = bucket
    return out


def _scenarios():
    quad, xs = _quad_params(8, 48, 0), _xs(3, 1)
    out = [dict(name=name, kind="optimizer", params=quad, xs=xs,
                knobs=_knobs(c["tier"], c.get("bucket")))
           for name, c in OPT_CASES.items()]
    out.append(dict(name="passes2", kind="optimizer", params=quad,
                    xs=_xs(4, 2), passes=2, momentum=0.9, knobs={}))
    epi_params = _quad_params(6, 40, 7)
    x = np.arange(4, dtype=np.float32).reshape(2, 2)
    out += [dict(name=name, kind="epilogue", params=epi_params, x=x,
                 steps=3, opt=port_opt)
            for name, (port_opt, _) in EPI_CASES.items()]
    cfg = htt.TransformerConfig(**TINY, dtype=torch.float32, dp_axis="dp")
    tiny, batches = _tiny_params(), _tiny_batches(2)
    out += [dict(name=name, kind="fused", cfg=cfg, params=tiny,
                 batches=batches, knobs=_knobs(tier))
            for name, tier in FUSED_CASES.items()]
    return out


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    """One two-rank gloo world runs every scenario while the tests compute
    the JAX side; ``load(name, rank)`` joins it on first use."""
    out = tmp_path_factory.mktemp("grad_sync")
    procs = workers.start_world(workers.grad_sync_worker, 2, _scenarios(),
                                str(out))
    joined = []

    def load(name, rank):
        if not joined:
            joined.append(True)
            workers.join_world(procs)
        return np.load(out / f"{name}-rank{rank}.npz")

    yield load
    if not joined:
        workers.join_world(procs)


def _mesh(axis="hvd"):
    return Mesh(np.array(jax.devices()[:2]), (axis,))


def _with_jknobs(settings, fn):
    for k, v in settings.items():
        jknobs.set_override(k, v)
    try:
        return fn()
    finally:
        for k in settings:
            jknobs.clear_override(k)


def _assert_rel(port, ref, rel, what, scale=None):
    """max |port - ref| <= rel * max(1, scale or max |ref|)."""
    ref = np.asarray(ref)
    lim = rel * max(1.0, scale or float(np.max(np.abs(ref))))
    err = float(np.max(np.abs(np.asarray(port) - ref)))
    assert err <= lim, f"{what}: max abs err {err} > {lim}"


def _jax_quad_step(opt, mesh, sspec):
    def step(params, opt_state, x):
        grads = jax.grad(lambda p: sum(jnp.sum(v * v) for v in p.values())
                         * jnp.sum(x))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state
    return jax.jit(shard_map(step, mesh=mesh,
                             in_specs=(P(), sspec, P("hvd")),
                             out_specs=(P(), sspec)))


# ---------------------------------------------------------------------------
# the bucket plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_plan_buckets_by_bytes_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 4096, int(rng.integers(1, 40)))]
    for bucket in (1, 512, 4096, 10_000, 1 << 30):
        assert _plan_buckets_by_bytes(sizes, bucket) == jplan(sizes, bucket)


# ---------------------------------------------------------------------------
# two ranks against a 2-device mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_distributed_optimizer_tiers_match_jax(port_world, name):
    """Three SGD steps of the quadratic at each tier (and two tiers with
    small buckets); fp8 carries the error-feedback residual, compared per
    rank with the JAX residual's row r."""
    case = OPT_CASES[name]
    params = {k: jnp.asarray(v) for k, v in _quad_params(8, 48, 0).items()}

    def run():
        mesh = _mesh()
        opt = hvd.DistributedOptimizer(optax.sgd(0.1), op=hvd.Average,
                                       axis="hvd", mesh=mesh)
        st = opt.init(params)
        fn = _jax_quad_step(opt, mesh, JD.wire_state_specs(st, axis="hvd"))
        p = params
        for x in _xs(3, 1):
            p, st = fn(p, st, jnp.asarray(x))
        return p, st, JD.last_wire_trace()

    jp, jst, trace = _with_jknobs(_knobs(case["tier"], case.get("bucket")),
                                  run)
    rel = F32 if case["tier"] == "none" else NARROW
    ef = isinstance(jst[0], JD.WireState)
    assert ef == case["tier"].startswith("fp8")
    for r in range(2):
        out = port_world(name, r)
        assert int(out["n_buckets"]) == trace["n_buckets"]
        for k in params:
            _assert_rel(out[f"param|{k}"], jp[k], rel, f"rank {r} {k}")
            if ef:
                _assert_rel(out[f"residual|{k}"],
                            np.asarray(jst[0].residual[k])[r], NARROW,
                            f"rank {r} residual {k}",
                            scale=4 * float(np.max(np.abs(jp[k]))))
        assert ef == any(f.startswith("residual|") for f in out.files)


def test_backward_passes_per_step_matches_optax_multisteps(port_world):
    """Two micro-batches per step, two steps, SGD with momentum: torch
    sums the micro-batch gradients and the sync divides by 2, as
    optax.MultiSteps averages them."""
    params = {k: jnp.asarray(v) for k, v in _quad_params(8, 48, 0).items()}
    mesh = _mesh()
    opt = hvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                   op=hvd.Average, axis="hvd", mesh=mesh,
                                   backward_passes_per_step=2)
    st = opt.init(params)
    fn = _jax_quad_step(opt, mesh, P())
    p = params
    for x in _xs(4, 2):
        p, st = fn(p, st, jnp.asarray(x))
    for r in range(2):
        out = port_world("passes2", r)
        for k in params:
            _assert_rel(out[f"param|{k}"], p[k], F32, f"rank {r} {k}")


@pytest.mark.parametrize("name", sorted(EPI_CASES))
def test_epilogue_optimizers_match_distributed_apply(port_world, name):
    """Three steps of EpilogueSGD (with and without Nesterov) and
    EpilogueAdam against the JAX distributed_apply."""
    mesh = _mesh()
    params = {k: jnp.asarray(v) for k, v in _quad_params(6, 40, 7).items()}
    da = JD.distributed_apply(EPI_CASES[name][1](), axis="hvd", mesh=mesh)
    st = da.init(params)
    sspec = da.state_specs(jax.tree.map(lambda _: P(), params))

    def fstep(params, st, x):
        grads = jax.grad(lambda p: sum(jnp.sum(v * v) for v in p.values())
                         * jnp.sum(x))(params)
        return da.apply(params, grads, st)

    fn = jax.jit(shard_map(fstep, mesh=mesh, in_specs=(P(), sspec,
                                                       P("hvd")),
                           out_specs=(P(), sspec)))
    x = jnp.arange(4, dtype=jnp.float32).reshape(2, 2)
    p = params
    for _ in range(3):
        p, st = fn(p, st, x)
    for r in range(2):
        out = port_world(name, r)
        for k in params:
            _assert_rel(out[f"param|{k}"], p[k], F32, f"rank {r} {k}")


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_transformer_step_matches_jax(port_world, name):
    """make_transformer_train_step_fused, two steps of the tiny config on
    a 2-device dp mesh, at tier none and at fp8_e4m3 with error feedback.

    At fp8 the wire cannot be equal bit for bit here: the two frameworks'
    f32 gradients differ in their last bits (sums in another order), and a
    value that lies on an fp8 rounding boundary rounds the other way (the
    quadratic's gradients are equal, and there every wire is). So at fp8:
    at most 0.2% of a leaf's parameters differ by more than 1e-6 of its
    largest value, all within 2e-4 (one wire step times the learning rate
    and momentum); and the residual per rank agrees within 1e-5 (it
    carries the gradients' rounding) on at least 95% of each leaf's values (a flipped value's residual, and its
    compensation in the next step, differ by one wire step).
    """
    tier = FUSED_CASES[name]
    cfg = jtfm.TransformerConfig(**TINY, dtype=jnp.float32, dp_axis="dp")

    def run():
        mesh = _mesh("dp")
        da = JD.distributed_apply(JD.EpilogueSGD(0.05, momentum=0.9),
                                  sync_axes=jtfm.grad_sync_axes(cfg),
                                  mesh=mesh)
        init_f, step_f = jtrainer.make_transformer_train_step_fused(
            cfg, da, mesh)
        state = init_f(jax.random.PRNGKey(0))
        losses = []
        for toks, labels in _tiny_batches(2):
            state, loss = step_f(state, jnp.asarray(toks),
                                 jnp.asarray(labels))
            losses.append(float(loss))
        return losses, state

    losses, state = _with_jknobs(_knobs(tier), run)
    params = jax.tree_util.tree_flatten_with_path(state.params)[0]
    residual = state.opt_state.residual
    for r in range(2):
        out = port_world(name, r)
        np.testing.assert_allclose(out["losses"], losses, rtol=F32,
                                   atol=F32, err_msg=f"rank {r} losses")
        for path, leaf in params:
            key = "/".join(p.key for p in path)
            if tier == "none":
                _assert_rel(out["param|" + key], leaf, F32, f"rank {r} {key}")
                continue
            top = max(1.0, float(np.max(np.abs(leaf))))
            diff = np.abs(out["param|" + key] - np.asarray(leaf))
            assert np.mean(diff > NARROW * top) <= 2e-3, (r, key)
            _assert_rel(out["param|" + key], leaf, 2e-4, f"rank {r} {key}")
        if tier != "none":
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    residual)[0]:
                key = "/".join(p.key for p in path)
                diff = np.abs(out["residual|" + key] - np.asarray(leaf)[r])
                assert np.mean(diff <= F32) >= 0.95, (r, key)


# ---------------------------------------------------------------------------
# one rank: the launch schedule
# ---------------------------------------------------------------------------

@pytest.fixture()
def world_of_one():
    htt.init(device="cpu")
    yield
    htt.shutdown()
    for k in ("HOROVOD_GRADIENT_BUCKET_BYTES", "HOROVOD_GRADIENT_COMPRESSION",
              "HOROVOD_GRADIENT_ERROR_FEEDBACK"):
        knobs.clear_override(k)


def _quad_model():
    return [torch.tensor(v, requires_grad=True)
            for v in _quad_params(8, 48, 0).values()]


@pytest.mark.parametrize("bucket,n_buckets", [(0, 1), (2 * 48 * 4, 8),
                                              (4 * 52 * 4, 3), (1 << 20, 1)])
def test_one_collective_per_bucket_launched_in_plan_order(
        world_of_one, monkeypatch, bucket, n_buckets):
    """Tier none: one allreduce per bucket and step, launched in plan
    order; with buckets > 0 the hooks launch every bucket before
    ``backward()`` returns (the last leaf is ready last, so the first
    bucket is launched while the backward still runs); with 0 the one
    bucket is launched by ``step()``."""
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", bucket)
    events = []
    real = collectives.allreduce_async

    def counting(buf):
        events.append(("allreduce", buf.numel()))
        return real(buf)

    monkeypatch.setattr(collectives, "allreduce_async", counting)
    ps = _quad_model()
    opt = htt.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1))
    assert len(opt.buckets) == n_buckets
    for _ in range(2):
        events.clear()
        _quadratic(ps).backward()
        events.append("backward returned")
        opt.step()
        opt.zero_grad()
        launches = [e for e in events if e != "backward returned"]
        assert len(launches) == n_buckets
        assert [k for k, _ in opt.launch_log] == list(range(n_buckets))
        assert [n for _, n in launches] == [
            sum(ps[i].numel() for i in b) for b in opt.buckets]
        in_backward = events.index("backward returned")
        assert in_backward == (n_buckets if bucket else 0)
        assert all(hook for _, hook in opt.launch_log) == bool(bucket)
    assert opt.buckets[0][0] == 7 or bucket == 0     # reverse order


def _quadratic(ps):
    return sum((p * p).sum() for p in ps) * 3.0


def test_hooks_fire_once_per_leaf_per_backward_under_recompute(
        world_of_one):
    """The flagship's mlp_recompute and remat re-run forwards inside the
    backward: every leaf's hook still fires once per backward, so every
    bucket is launched by the hooks, once."""
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", 64 * 64 * 4)
    for remat, recompute in ((False, True), (True, False)):
        cfg = htt.TransformerConfig(**TINY, dtype=torch.float32,
                                    dp_axis="dp", remat=remat,
                                    mlp_recompute=recompute)
        params = htt.params_from_numpy(_tiny_params(), device="cpu")
        da = htt.distributed_apply(htt.EpilogueSGD(0.05),
                                   sync_axes=tfm.grad_sync_axes(cfg))
        init_fn, step = htt.make_transformer_train_step_fused(
            cfg, da, device="cpu")
        state = init_fn(params)
        fired = []
        for p in tfm_leaves(state.params):
            p.register_post_accumulate_grad_hook(
                lambda t, fired=fired: fired.append(id(t)))
        toks, labels = _tiny_batches(1)[0]
        state, _ = step(state, toks[:2], labels[:2])
        leaves = tfm_leaves(state.params)
        assert sorted(fired) == sorted(id(p) for p in leaves)
        log = D.last_wire_trace()
        assert log["n_buckets"] > 3


def tfm_leaves(params):
    from horovod_tpu_torch.utils import tree as tree_util
    return tree_util.tree_leaves(params)


@pytest.mark.parametrize("dp_axis", ["dp", None])
def test_one_rank_fused_step_equals_unfused_step(world_of_one, dp_axis):
    """At tier none on a world of one the fused step (hooks, buckets,
    EpilogueSGD) gives the unfused step's (torch SGD) trajectory; with
    ``dp_axis=None`` every leaf is local: one bucket, no collective."""
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", 64 * 64 * 4)
    cfg = htt.TransformerConfig(**TINY, dtype=torch.float32, dp_axis=dp_axis)
    runs = []
    for fused in (False, True):
        params = htt.params_from_numpy(_tiny_params(), device="cpu")
        if fused:
            da = htt.distributed_apply(htt.EpilogueSGD(0.05, momentum=0.9),
                                       sync_axes=tfm.grad_sync_axes(cfg))
            init_fn, step = htt.make_transformer_train_step_fused(
                cfg, da, device="cpu")
        else:
            init_fn, step = htt.make_transformer_train_step(
                cfg, lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9),
                device="cpu")
        state = init_fn(params)
        losses = []
        for toks, labels in _tiny_batches(3):
            state, loss = step(state, toks[:2], labels[:2])
            losses.append(float(loss))
        runs.append((losses, [t.detach() for t in
                              tfm_leaves(state.params)]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=F32, atol=F32)
    for a, b in zip(runs[1][1], runs[0][1]):
        _assert_rel(a.numpy(), b.numpy(), F32, "params after 3 steps")


@pytest.mark.parametrize("bucket", [0, 2 * 48 * 4])
@pytest.mark.parametrize("passes", [1, 2])
def test_backward_pass_beyond_passes_per_step_raises(world_of_one, bucket,
                                                     passes):
    """A backward pass beyond ``backward_passes_per_step`` before
    ``step()`` raises, as the reference's ``torch/optimizer.py`` does,
    whether the buckets launch from the hooks or after the backward: its
    gradients would otherwise be dropped (hook-launched buckets are already
    packed) or summed into a mean over the wrong count."""
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", bucket)
    ps = _quad_model()
    opt = htt.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1),
                                   backward_passes_per_step=passes)
    for _ in range(2):                  # the count starts again after step()
        for _ in range(passes):
            _quadratic(ps).backward()
        opt.step()
        opt.zero_grad()
    for _ in range(passes):
        _quadratic(ps).backward()
    with pytest.raises(RuntimeError, match="backward_passes_per_step"):
        _quadratic(ps).backward()


def test_allreduce_gradients_local_filter_and_error_feedback(world_of_one):
    """allreduce_gradients over a dict tree: a local (empty-axes) group is
    never quantized, local_param_filter keeps a leaf's own gradient, and
    the fp8 residual is carried in the WireState."""
    knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    rng = np.random.RandomState(5)
    grads = {k: torch.from_numpy(rng.randn(32).astype(np.float32))
             for k in ("a", "b", "loc")}
    tx = htt.allreduce_gradients(sync_axes={"a": ("hvd",), "b": ("hvd",),
                                            "loc": ()},
                                 local_param_filter=lambda p: p == ("b",))
    state = tx.init(grads)
    assert isinstance(state, D.WireState)
    synced, state = tx.update(grads, state)
    assert torch.equal(synced["loc"], grads["loc"])
    assert synced["b"] is grads["b"]
    assert not torch.equal(synced["a"], grads["a"])       # quantized
    torch.testing.assert_close(synced["a"] + state.residual["a"],
                               grads["a"], rtol=0, atol=1e-6)
    assert not state.residual["loc"].any()
    trace = D.last_wire_trace()
    assert trace["tier"] == "fp8_e4m3" and trace["error_feedback"]
    assert 0 < trace["wire_bytes"] < trace["logical_bytes"]
    knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
    plain = htt.allreduce_gradients(compression=None)
    assert plain.init(grads) == ()
    out, _ = plain.update([g.clone() for g in grads.values()])
    assert all(torch.equal(o, g) for o, g in zip(out, grads.values()))


def test_construction_rejects_and_warns(world_of_one, monkeypatch):
    ps = _quad_model()
    sgd = torch.optim.SGD(ps, lr=0.1)
    with pytest.raises(ValueError, match="unknown wire-compression"):
        htt.DistributedOptimizer(sgd, compression="int4")
    with pytest.raises(NotImplementedError, match="Adasum"):
        htt.DistributedOptimizer(sgd, op=ReduceOp.ADASUM)
    with pytest.raises(TypeError):
        htt.DistributedOptimizer(sgd, bucket_bytes=1 << 20)
    with pytest.raises(ValueError, match="explicit mesh axis"):
        htt.distributed_apply(htt.EpilogueSGD(0.1))
    with pytest.raises(TypeError, match="DistributedApply"):
        htt.make_transformer_train_step_fused(
            htt.TransformerConfig(**TINY, dtype=torch.float32), sgd,
            device="cpu")
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", "auto")
    warnings = []

    class Logger:
        def warning(self, msg, *args):
            warnings.append(msg % args)

    monkeypatch.setattr(autotune, "get_logger", lambda name: Logger())
    monkeypatch.setattr(autotune, "_auto_warned", set())
    for _ in range(2):
        opt = htt.DistributedOptimizer(torch.optim.SGD(_quad_model(),
                                                       lr=0.1))
    assert len(opt.buckets) == 1                     # 25 MiB holds them all
    assert len(warnings) == 1 and "25 MiB default" in warnings[0]
