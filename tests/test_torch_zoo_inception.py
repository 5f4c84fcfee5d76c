"""The port's Inception V3 against the JAX package's, on the CPU, in f32,
with the variables carried across by ``resnet.variables_from_numpy`` and
``variables_to_numpy``.

- The whole model at its smallest input (75^2, batch 2), on the port's
  seeded weights carried to the JAX model: eval-mode logits and every
  gradient (on perturbed running statistics) within
  1e-5 of the largest reference value; in train mode, finite logits and
  every running statistic moved.
- Each of the stem's and ``InceptionA``-``E``'s blocks in train mode at
  a spatial size where batch norm sees enough positions: output, running
  statistics and the gradients of a weighted sum (every parameter and the
  input) within ResNet's limits (1e-4 for outputs and statistics, 1e-3
  for gradients).

Why block by block in train mode: at 75^2 the last blocks see 1x1 maps,
so their batch statistics are over two positions, and ``E[x^2] - E[x]^2``
over two values turns the frameworks' last-bit differences upstream into
3.5e-2 of the logits (1.8e-6 in eval mode on the same weights); the whole
model stays within 1e-4 in train mode only from about 139^2, whose JAX
compile and CPU run take most of a minute. (The JAX package's own
Inception test runs at 299^2 and is marked slow.)"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict

from horovod_tpu.models import inception as jinc
from horovod_tpu_torch.models import inception, resnet
import test_torch_zoo as zoo


def test_inception_v3_whole_model_matches_jax():
    jmodel = jinc.InceptionV3(num_classes=10, dtype=jnp.float32)
    model = inception.InceptionV3(num_classes=10, dtype=torch.float32,
                                  device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert "InceptionE_1.BasicConv_8.BatchNorm_0.scale" in names
    assert len(names) == len(set(names)) == len(jax.tree.leaves(
        jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3))))["params"]))
    x, y = zoo._images(3, 2, 75)
    # the port's seeded weights go to the JAX model (its init would cost
    # one more compile of the whole model)
    v = resnet.variables_to_numpy(model)
    rng = np.random.default_rng(4)
    v["batch_stats"] = jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape) * (a == 0)
                   + 0.2 * np.abs(rng.standard_normal(a.shape)) * (a == 1)
                   ).astype(np.float32), v["batch_stats"])
    zoo.compare(jmodel, model, x, y, train=False, tol=zoo.EXACT,
                variables=v)
    # not a dead network: logits and every gradient leaf move
    with torch.no_grad():
        assert float(model(torch.from_numpy(x)).abs().max()) > 1e-5
    assert all(float(p.grad.abs().max()) > 0 for p in model.parameters())
    # train mode runs and moves every running statistic (the values are
    # held block by block below)
    with torch.no_grad():
        logits = model(torch.from_numpy(x), train=True)
    assert torch.isfinite(logits).all() and logits.shape == (2, 10)
    moved = flatten_dict(resnet.variables_to_numpy(model)["batch_stats"])
    assert all(not np.array_equal(moved[k], a) for k, a in
               flatten_dict(v["batch_stats"]).items())


def _norm(train=True):
    return functools.partial(fnn.BatchNorm, use_running_average=not train,
                             momentum=0.9, epsilon=1e-3, dtype=jnp.float32)


class _JStem(fnn.Module):
    """The JAX model's stem (its first lines, in its module names)."""

    @fnn.compact
    def __call__(self, x):
        conv = functools.partial(jinc.BasicConv, norm=_norm())
        x = conv(32, (3, 3), (2, 2), padding="VALID")(x)
        x = conv(32, (3, 3), padding="VALID")(x)
        x = conv(64, (3, 3))(x)
        x = fnn.max_pool(x, (3, 3), strides=(2, 2), padding="VALID")
        x = conv(80, (1, 1), padding="VALID")(x)
        x = conv(192, (3, 3), padding="VALID")(x)
        return fnn.max_pool(x, (3, 3), strides=(2, 2), padding="VALID")


class _Stem(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        for i in range(5):
            self.add_module(f"BasicConv_{i}", getattr(model,
                                                      f"BasicConv_{i}"))
        self.model = [model]

    def forward(self, x, train):
        m, i = self.model[0], 0
        for spec in m._stem:
            if spec is None:
                x = inception.max_pool_nhwc(x, 3, 2)
                continue
            x = getattr(self, f"BasicConv_{i}")(x, train)
            i += 1
        return x


def _block(name):
    """(JAX block, port block, input shape)."""
    kw = dict(norm_kw=dict(momentum=0.9, epsilon=1e-3,
                           dtype=torch.float32),
              dtype=torch.float32, gen=torch.Generator().manual_seed(0))
    if name == "stem":
        return (_JStem(), _Stem(inception.InceptionV3(
            num_classes=10, dtype=torch.float32, device="cpu")),
                (2, 75, 75, 3))
    cls, extra, shape = {
        "A": ("InceptionA", dict(pool_features=32), (2, 9, 9, 192)),
        "B": ("InceptionB", {}, (2, 9, 9, 288)),
        "C": ("InceptionC", dict(channels_7x7=128), (2, 7, 7, 768)),
        "D": ("InceptionD", {}, (2, 7, 7, 768)),
        "E": ("InceptionE", {}, (2, 5, 5, 1280))}[name]
    return (getattr(jinc, cls)(norm=_norm(), **extra),
            getattr(inception, cls)(shape[-1], **extra, **kw), shape)


@pytest.mark.parametrize("name", ["stem", "A", "B", "C", "D", "E"])
def test_inception_blocks_train_mode_match_jax(name):
    jblock, block, shape = _block(name)
    rng = np.random.default_rng(ord(name[0]))
    x = rng.standard_normal(shape).astype(np.float32)
    v = zoo._np(jax.jit(jblock.init)(jax.random.PRNGKey(1), x))
    y_shape = jax.eval_shape(lambda: jblock.apply(
        v, x, mutable=["batch_stats"]))[0].shape
    w = rng.standard_normal(y_shape).astype(np.float32)

    def f(params, xx):
        y, upd = jblock.apply({**v, "params": params}, xx,
                              mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    (_, (jy, jstats)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], x)
    resnet.variables_from_numpy(block, v)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = block(xt, True)
    (y * torch.from_numpy(w)).sum().backward()
    zoo.assert_rel(y.detach().numpy(), jy, zoo.BN_TRAIN["logits"], "output")
    zoo.assert_tree_rel(
        flatten_dict(resnet.variables_to_numpy(block)["batch_stats"]),
        zoo._np(jstats), zoo.BN_TRAIN["stats"], "running statistics")
    grads = {tuple(n.split(".")): p.grad.numpy()
             for n, p in block.named_parameters()}
    zoo.assert_tree_rel(grads, zoo._np(gp), zoo.BN_TRAIN["grads"],
                        "gradient")
    zoo.assert_rel(xt.grad.numpy(), gx, zoo.BN_TRAIN["grads"], "dx")
