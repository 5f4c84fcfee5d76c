"""The port's ResNet training path against the JAX package, on the CPU.

The small ResNet of ``tests/test_fused_conv_bn.py`` (stage_sizes [1, 1],
8 filters, 10 classes, f32, 32x32 images) is built in both packages; the
JAX variables are carried across with ``variables_from_numpy``, and the
same numpy batches go through both. The JAX fused model runs its Pallas
kernels interpreted; the port's takes the kernels' plain versions.

Tolerances (f32; the two frameworks sum in other orders, and batch norm
over 2 x 4 x 4 positions in the second stage divides by small standard
deviations, which amplifies those differences):
- logits, running statistics: rtol/atol 1e-4;
- gradient leaves: rtol 1e-3 / atol 1e-4 (the JAX tests' fused-vs-plain
  comparison allows 5e-3 / 5e-4);
- parameters and running statistics after SGD steps: rtol/atol 1e-4.
"""

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from horovod_tpu.models import fused_block as jfused
from horovod_tpu.models import resnet as jresnet
import horovod_tpu_torch as htt
from horovod_tpu_torch.models import fused_block, resnet
from horovod_tpu_torch.ops import collectives, conv_bn
from horovod_tpu_torch.parallel import distributed
import test_torch_workers as workers

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
KW = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8)


def _jmodel(fused):
    return jresnet.ResNet(block_cls=jresnet.BottleneckBlock,
                          dtype=jnp.float32, fused_conv_bn=fused,
                          interpret=fused, **KW)


def _model(fused, **kw):
    return htt.ResNet(block_cls=resnet.BottleneckBlock, dtype=torch.float32,
                      fused_conv_bn=fused, device="cpu", **KW, **kw)


def _np(tree):
    """Nested dicts of numpy arrays (what a jax-free worker can unpickle)."""
    return unfreeze(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def jvars():
    """JAX variables of the plain model and the same arrays in the fused
    layout (the JAX tests' mapping)."""
    x = jnp.zeros((2, 32, 32, 3), jnp.float32)
    vp = _jmodel(False).init(jax.random.PRNGKey(0), x, train=True)
    vf = jfused.plain_to_fused_variables(
        _jmodel(True).init(jax.random.PRNGKey(0), x, train=True), vp)
    return {False: _np(vp), True: _np(vf)}


def _data(seed, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, (b,)).astype(np.int64))


def _jloss(model, variables, x, y):
    def go(params):
        logits, upd = model.apply({**variables, "params": params}, x,
                                  train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (logits, upd["batch_stats"])
    return go


def _assert_tree_close(flat_port, tree_jax, tol, what):
    flat_jax = flatten_dict(tree_jax)
    assert set(flat_port) == set(flat_jax), what
    for k, v in flat_jax.items():
        np.testing.assert_allclose(flat_port[k], np.asarray(v), **tol,
                                   err_msg=f"{what} {'/'.join(k)}")


def _port_flat(model, coll):
    return flatten_dict(resnet.variables_to_numpy(model)[coll])


@pytest.mark.parametrize("fused", [False, True])
def test_train_mode_logits_stats_and_gradients_match_jax(jvars, fused):
    x, y = _data(0)
    v = jvars[fused]
    (jl, (jlogits, jstats)), jgrads = jax.value_and_grad(
        _jloss(_jmodel(fused), v, x, y), has_aux=True)(v["params"])
    model = resnet.variables_from_numpy(_model(fused), v)
    conv_bn.reset_launches()
    logits = model(torch.from_numpy(x), train=True)
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    assert conv_bn.LAUNCHES == {"conv_bn_fwd": 0, "conv_bn_bwd": 0}
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    _assert_tree_close(_port_flat(model, "batch_stats"), jstats, TOL,
                       "running statistics")
    grads = {tuple(n.split(".")): p.grad.numpy()
             for n, p in model.named_parameters()}
    _assert_tree_close(grads, jgrads, GRAD_TOL, "gradient")


@pytest.mark.parametrize("fused", [False, True])
def test_eval_mode_matches_jax(jvars, fused):
    x, _ = _data(2)
    v = dict(jvars[fused])
    rng = np.random.RandomState(7)      # non-trivial running statistics
    v["batch_stats"] = jax.tree.map(
        lambda a: (np.abs(a + rng.randn(*a.shape)) * 0.5 + 0.1).astype(
            np.float32), v["batch_stats"])
    jlogits = _jmodel(fused).apply(v, x, train=False)
    model = resnet.variables_from_numpy(_model(fused), v)
    with torch.no_grad():
        logits = model(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _assert_tree_close(_port_flat(model, "batch_stats"), v["batch_stats"],
                       dict(rtol=0, atol=0), "unchanged running statistics")


def test_variables_and_key_translation_round_trip(jvars):
    """flax trees go in and come back exactly; the port's converters and
    key translation agree with the JAX package's on every path."""
    for fused in (False, True):
        model = resnet.variables_from_numpy(_model(fused), jvars[fused])
        back = resnet.variables_to_numpy(model)
        _assert_tree_close(flatten_dict(back), jvars[fused],
                           dict(rtol=0, atol=0), f"round trip {fused}")
    fused_keys = list(flatten_dict(jvars[True]))
    assert [fused_block.translate_fused_key(k) for k in fused_keys] == [
        jfused.translate_fused_key(k) for k in fused_keys]
    tmpl = resnet.variables_to_numpy(_model(True, seed=5))
    fv = fused_block.plain_to_fused_variables(tmpl, jvars[False])
    _assert_tree_close(flatten_dict(fv), jvars[True], dict(rtol=0, atol=0),
                       "plain -> fused")
    pv = fused_block.fused_to_plain_variables(jvars[False], fv)
    _assert_tree_close(flatten_dict(pv), jvars[False], dict(rtol=0, atol=0),
                       "fused -> plain")
    with pytest.raises(KeyError, match="no counterpart"):
        resnet.variables_from_numpy(_model(False), jvars[True])


def test_non_relu_act_and_unported_options_raise():
    with pytest.raises(ValueError, match="relu"):
        _model(True, act=F.silu)
    with pytest.raises(ValueError, match="bottleneck"):
        htt.ResNet(stage_sizes=[1], block_cls=resnet.ResNetBlock,
                   fused_conv_bn=True, device="cpu")
    for kw in (dict(space_to_depth=True), dict(folded_bn=True)):
        with pytest.raises(NotImplementedError, match="A.14"):
            _model(False, **kw)
    sgd = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    with pytest.raises(NotImplementedError, match="A.9"):
        htt.DistributedOptimizer(sgd, op=htt.ops.reduce_ops.Adasum)
    with pytest.raises(ValueError, match="unknown wire-compression"):
        htt.DistributedOptimizer(sgd, compression="int4")
    with pytest.raises(TypeError):       # the bucket knob governs
        htt.DistributedOptimizer(sgd, bucket_bytes=1 << 20)
    htt.DistributedOptimizer(sgd, compression=distributed.Compression.fp16,
                             backward_passes_per_step=2)
    with pytest.raises(TypeError, match="DistributedOptimizer"):
        htt.data_parallel_train_step(lambda m, x: x, sgd, device="cpu")
    with pytest.raises(NameError, match="unbound axis"):
        collectives.psum(torch.ones(2), "hvd")
    model = _model(True, bn_cross_replica_axis="hvd")
    with pytest.raises(NameError, match="unbound axis"):
        model(torch.zeros(2, 32, 32, 3), train=True)
    model(torch.zeros(2, 32, 32, 3), train=False)       # eval: no sync


def test_entry_points_default_to_cuda_and_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        htt.ResNet50()
    opt = htt.DistributedOptimizer(torch.optim.SGD(
        [torch.zeros(1, requires_grad=True)], lr=0.1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        htt.data_parallel_train_step(lambda m, x: x, opt)


def _jax_trajectory(fused, variables, batches):
    """bench.py build_step's math (model.apply in train mode with the
    running statistics carried, softmax CE, optax.sgd(0.01, momentum=0.9)),
    on one process: (losses, final variables)."""
    model = _jmodel(fused)
    opt = optax.sgd(0.01, momentum=0.9)

    @jax.jit
    def step(params, stats, opt_state, x, y):
        (loss, (_, new_stats)), grads = jax.value_and_grad(
            _jloss(model, {"batch_stats": stats}, x, y), has_aux=True)(
            params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, \
            loss

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = opt.init(params)
    losses = []
    for x, y in batches:
        params, stats, opt_state, loss = step(params, stats, opt_state, x,
                                              y.astype(np.int32))
        losses.append(float(loss))
    return losses, {"params": params, "batch_stats": stats}


def _loss_fn(model, x, y):
    return F.cross_entropy(model(x, train=True), y)


def test_distributed_optimizer_three_steps_match_jax(jvars):
    """A world of one (gloo): data_parallel_train_step + DistributedOptimizer
    (SGD 0.01, momentum 0.9) over three batches against the JAX step."""
    batches = [_data(10 + i) for i in range(3)]
    j_losses, j_vars = _jax_trajectory(True, jvars[True], batches)
    htt.init(device="cpu")
    try:
        model = resnet.variables_from_numpy(_model(True), jvars[True])
        opt = htt.DistributedOptimizer(torch.optim.SGD(
            model.parameters(), lr=0.01, momentum=0.9), op=htt.Average)
        init_fn, step, put_batch = htt.data_parallel_train_step(
            _loss_fn, opt, device="cpu")
        state = init_fn(model)
        losses = []
        state, info = htt.train_loop(
            step, state, [put_batch(b) for b in batches],
            on_step=lambda i, s, loss: losses.append(float(loss)))
    finally:
        htt.shutdown()
    assert info["final_step"] == 3 and state.step == 3
    np.testing.assert_allclose(losses, j_losses, **TOL)
    port = resnet.variables_to_numpy(state.params)
    for coll in ("params", "batch_stats"):
        _assert_tree_close(flatten_dict(port[coll]), j_vars[coll], TOL,
                           f"{coll} after 3 steps")


def test_two_rank_sync_batch_norm_matches_jax_whole_batch(jvars, tmp_path):
    """Two gloo ranks, each on half of every global batch, with
    bn_cross_replica_axis bound (sync batch norm, a differentiable
    allreduce of the statistics): two steps equal the JAX single-process
    step on the whole batch. Rank r starts from the weights times (1 + r):
    init_fn must broadcast rank 0's."""
    batches = [_data(20 + i, b=4) for i in range(2)]
    procs = workers.start_world(workers.resnet_dp_worker, 2,
                                dict(block_cls=resnet.BottleneckBlock,
                                     dtype=torch.float32, fused_conv_bn=True,
                                     **KW),
                                jvars[True], batches, str(tmp_path))
    try:
        j_losses, j_vars = _jax_trajectory(True, jvars[True], batches)
    finally:
        workers.join_world(procs)
    for r in range(2):
        out = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(out["losses"], j_losses, **TOL,
                                   err_msg=f"rank {r} losses")
        for coll in ("params", "batch_stats"):
            flat = {tuple(k.split("|")[1:]): out[k] for k in out.files
                    if k.startswith(coll + "|")}
            _assert_tree_close(flat, j_vars[coll], TOL,
                               f"rank {r} {coll} after 2 steps")
