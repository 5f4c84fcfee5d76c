"""The port's model zoo against the JAX package's, on the CPU: VGG, the
MNIST models, lane-folded batch norm, and ResNet's space-to-depth stem
and ``folded_bn`` option (Inception V3 is in
``test_torch_zoo_inception.py``).

Each model is built in both packages; the JAX variables are carried
across by ``resnet.variables_from_numpy`` and the same numpy batch (made
from a seed) goes through both, in f32. Limits, relative to the largest
reference value:
- forward and gradients: 1e-5;
- where batch norm runs in train mode (its statistics divide by small
  standard deviations, which amplifies the two frameworks' different
  summation orders): ResNet's limits, 1e-4 for logits and running
  statistics and 1e-3 for gradients.
"""

import functools

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from horovod_tpu.models import folded_bn as jfolded
from horovod_tpu.models import mlp as jmlp
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.models import vgg as jvgg
import horovod_tpu_torch as htt
from horovod_tpu_torch.models import (MLP, VGG, FoldedBatchNorm,
                                      InceptionV3, MnistCNN, inception,
                                      resnet, vgg)

EXACT = {"logits": 1e-5, "stats": 1e-5, "grads": 1e-5}
BN_TRAIN = {"logits": 1e-4, "stats": 1e-4, "grads": 1e-3}


def _np(tree):
    return unfreeze(jax.tree.map(np.asarray, tree))


def assert_rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max |diff| / max |ref| = {err:.3e} > {tol}"


def assert_tree_rel(flat_port, tree_jax, tol, what, zero=()):
    """Each leaf within ``tol`` of its own largest value; the leaves in
    ``zero`` are exactly zero in exact arithmetic (a conv bias under
    train-mode batch norm, which subtracts the batch mean), so both
    packages give rounding noise there: those are held to ``tol`` of the
    tree's largest value instead."""
    flat_jax = flatten_dict(tree_jax)
    assert set(flat_port) == set(flat_jax), (
        what, sorted(set(flat_port) ^ set(flat_jax))[:6])
    top = max(float(np.abs(v).max()) for v in flat_jax.values())
    for k, v in flat_jax.items():
        if k in zero:
            for a in (flat_port[k], v):
                assert float(np.abs(a).max()) <= tol * top, (what, k)
            continue
        assert_rel(flat_port[k], v, tol, f"{what} {'/'.join(k)}")


def compare(jmodel, model, x, y, *, train, tol, apply_kw=None,
            call=None, zero=(), variables=None):
    """Train- or eval-mode logits, running statistics (when the model
    has any) and every parameter gradient of softmax cross-entropy, JAX
    against the port, with the JAX variables (``variables``, or the JAX
    model's init) carried across."""
    apply_kw = dict(apply_kw if apply_kw is not None else {"train": train})
    if variables is None:
        variables = _np(jax.jit(functools.partial(
            jmodel.init, **apply_kw))(jax.random.PRNGKey(0), x))
    has_stats = "batch_stats" in variables
    mutable = ["batch_stats"] if (train and has_stats) else False

    def loss(params):
        out = jmodel.apply({**variables, "params": params}, x,
                           mutable=mutable, **apply_kw)
        logits, upd = out if mutable else (out, {})
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return ce.mean(), (logits, upd.get("batch_stats"))

    (_, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    resnet.variables_from_numpy(model, variables)
    call = call or (lambda m, t: m(t, train=train))
    logits = call(model, torch.from_numpy(np.asarray(x)))
    F.cross_entropy(logits, torch.from_numpy(np.asarray(y)).long()
                    ).backward()
    assert_rel(logits.detach().numpy(), jlogits, tol["logits"], "logits")
    port = resnet.variables_to_numpy(model)
    if jstats is not None:
        assert_tree_rel(flatten_dict(port["batch_stats"]), _np(jstats),
                        tol["stats"], "running statistics")
    grads = {tuple(n.split(".")): p.grad.numpy()
             for n, p in model.named_parameters()}
    assert_tree_rel(grads, _np(jgrads), tol["grads"], "gradient", zero)
    return variables


def _images(seed, b, side, c=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, side, side, c)).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int32))


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,batch_norm", [
    ("11", False), ("11", True), ("16", False), ("16", True)])
def test_vgg_matches_jax(name, batch_norm):
    """VGG-11 and VGG-16 at 32^2 with classifier_width=64: train-mode
    logits, running statistics and gradients; then eval-mode logits on
    the updated statistics."""
    cfg = {"11": vgg.CFG_11, "16": vgg.CFG_16}[name]
    assert cfg == {"11": jvgg.CFG_11, "16": jvgg.CFG_16}[name]
    kw = dict(num_classes=10, batch_norm=batch_norm, classifier_width=64)
    jmodel = jvgg.VGG(cfg=cfg, dtype=jnp.float32, **kw)
    model = VGG(cfg=cfg, dtype=torch.float32, image=32, device="cpu", **kw)
    x, y = _images(1, 2, 32)
    n_convs = sum(v != "M" for v in cfg)
    compare(jmodel, model, x, y, train=True,
            tol=BN_TRAIN if batch_norm else EXACT,
            zero=[(f"Conv_{i}", "bias") for i in range(n_convs)
                  if batch_norm])
    stats = resnet.variables_to_numpy(model)
    jl = jax.jit(functools.partial(jmodel.apply, train=False))(
        {"params": stats["params"], **({"batch_stats": stats["batch_stats"]}
                                       if batch_norm else {})}, x)
    with torch.no_grad():
        assert_rel(model(torch.from_numpy(x), train=False).numpy(), jl,
                   EXACT["logits"], "eval logits")


def test_vgg_layout_and_bf16_dtypes():
    """Convs carry a bias, the flatten is NHWC's (H, W, C) order (the
    first classifier kernel is [H*W*C, width]), the hidden dense layers
    compute in the model's dtype and the head in f32."""
    model = vgg.VGG11(num_classes=10, classifier_width=64, image=32,
                      device="cpu")
    names = dict(model.named_parameters())
    assert tuple(names["Conv_0.bias"].shape) == (64,)
    assert tuple(names["Dense_0.kernel"].shape) == (512, 64)
    assert model.Dense_0.dtype == torch.bfloat16
    assert model.Dense_2.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x, _ = _images(2, 2, 32)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, 10)
    assert torch.isfinite(out).all()


def test_vgg16_and_inception_v3_parameter_counts():
    """Published sizes, counted on the meta device (nothing allocated),
    equal to the JAX models' counts from ``jax.eval_shape``."""
    def jcount(model, side):
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3),
                                             jnp.bfloat16)))
        return sum(int(np.prod(s.shape))
                   for s in jax.tree.leaves(shapes["params"]))

    from horovod_tpu.models.inception import InceptionV3 as JInceptionV3
    with torch.device("meta"):
        v16 = vgg.VGG16(device="meta")
        inc = InceptionV3(device="meta")
    assert all(p.is_meta for p in v16.parameters())
    n_vgg = sum(p.numel() for p in v16.parameters())
    n_inc = sum(p.numel() for p in inc.parameters())
    assert 135e6 < n_vgg < 140e6, n_vgg
    assert 20e6 < n_inc < 28e6, n_inc
    assert v16.Dense_0.kernel.shape == (25088, 4096)
    assert n_vgg == jcount(jvgg.VGG16(num_classes=1000), 224)
    assert n_inc == jcount(JInceptionV3(num_classes=1000), 299)


# ---------------------------------------------------------------------------
# the MNIST models
# ---------------------------------------------------------------------------

def test_mlp_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, (4,)).astype(np.int32)
    compare(jmlp.MLP(), MLP(device="cpu"), x, y, train=False, tol=EXACT,
            apply_kw={}, call=lambda m, t: m(t))


def test_mnist_cnn_eval_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, (3,)).astype(np.int32)
    compare(jmlp.MnistCNN(), MnistCNN(device="cpu"), x, y, train=False,
            tol=EXACT)


def test_mnist_cnn_dropout_draws_from_the_generator():
    """Train-mode dropout: the mask comes from the generator passed in
    (the same seed gives the same output), a kept unit is scaled by
    1 / keep, and train mode without a generator raises as flax does
    without a dropout rng."""
    model = MnistCNN(device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 28, 28, 1)).astype(np.float32))
    a = model(x, train=True, gen=torch.Generator().manual_seed(1))
    b = model(x, train=True, gen=torch.Generator().manual_seed(1))
    c = model(x, train=True, gen=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert not torch.equal(a, model(x))
    from horovod_tpu_torch.models.mlp import dropout
    t = torch.ones(1000)
    kept = dropout(t, 0.5, True, torch.Generator().manual_seed(0))
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)


# ---------------------------------------------------------------------------
# lane-folded batch norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("c", [64, 48])
def test_folded_bn_matches_jax_folded_bn_and_flax_batchnorm(train, c):
    """C=64 folds (k=2 lanes of 128), C=48 does not (128 % 48): the port's
    FoldedBatchNorm against the JAX FoldedBatchNorm and against flax's
    BatchNorm in train and eval mode — output, running statistics, and
    the gradients of a weighted sum with respect to x, scale and bias."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6, 8, c)).astype(np.float32) * 2 + 0.5
    params = {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
             "var": (1 + 0.1 * rng.random(c)).astype(np.float32)}
    mod = FoldedBatchNorm(c, momentum=0.9, epsilon=1e-5)
    assert mod.fold(torch.from_numpy(x), train) == (2 if c == 64 and train
                                                    else 1)
    resnet.variables_from_numpy(mod, {"params": params,
                                      "batch_stats": stats})
    xt = torch.from_numpy(x).requires_grad_(True)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    y = mod(xt, train)
    (y * torch.from_numpy(w)).sum().backward()
    port = resnet.variables_to_numpy(mod)
    for jmod in (jfolded.FoldedBatchNorm(use_running_average=not train,
                                         momentum=0.9, epsilon=1e-5),
                 fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                               epsilon=1e-5)):
        mutable = ["batch_stats"] if train else False

        def f(p, xx):
            out = jmod.apply({"params": p, "batch_stats": stats}, xx,
                             mutable=mutable)
            yy, upd = out if mutable else (out, {"batch_stats": stats})
            return jnp.sum(yy * w), (yy, upd["batch_stats"])

        (_, (jy, jstats)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, x)
        what = type(jmod).__name__
        assert_rel(y.detach().numpy(), jy, 1e-5, f"{what} output")
        for k in ("mean", "var"):
            assert_rel(port["batch_stats"][k], jstats[k], 1e-5,
                       f"{what} running {k}")
        assert_rel(xt.grad.numpy(), gx, 1e-5, f"{what} dx")
        for k in ("scale", "bias"):
            assert_rel(dict(mod.named_parameters())[k].grad.numpy(), gp[k],
                       1e-5, f"{what} d{k}")


def test_folded_bn_bf16_and_cross_replica_axis():
    """In bf16 the normalize runs in bf16 (the statistics in f32), as the
    JAX module's does; with an axis that is not bound, train mode raises
    as the port's psum does, and eval mode needs no axis."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    jmod = jfolded.FoldedBatchNorm(use_running_average=False,
                                   dtype=jnp.bfloat16)
    jv = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jy, _ = jmod.apply(jv, jnp.asarray(x), mutable=["batch_stats"])
    mod = FoldedBatchNorm(64, dtype=torch.bfloat16)
    y = mod(torch.from_numpy(x), True)
    assert y.dtype == torch.bfloat16
    assert_rel(y.detach().float().numpy(), np.asarray(jy, np.float32), 2 ** -7,
               "bf16 output")
    synced = FoldedBatchNorm(64, axis_name="hvd")
    with pytest.raises(NameError, match="unbound axis"):
        synced(torch.from_numpy(x), True)
    synced(torch.from_numpy(x), False)


# ---------------------------------------------------------------------------
# ResNet: the space-to-depth stem and folded_bn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s2d,folded", [(True, False), (False, True)])
def test_resnet18_s2d_and_folded_bn_train_mode_match_jax(s2d, folded):
    """At 64^2 (the JAX tests' input): at 32^2 the last stage normalizes
    over 2 positions, where both packages' batch statistics of the last
    blocks differ by more than the limit from summation order alone."""
    kw = dict(num_classes=10, space_to_depth=s2d, folded_bn=folded)
    jmodel = jresnet.ResNet18(dtype=jnp.float32, **kw)
    model = htt.ResNet18(dtype=torch.float32, device="cpu", **kw)
    stem = [n for n, _ in model.named_parameters()
            if n.startswith("conv_init")]
    assert stem == (["conv_init_s2d.kernel"] if s2d
                    else ["conv_init.kernel"])
    assert tuple(dict(model.named_parameters())[stem[0]].shape) == (
        (4, 4, 12, 64) if s2d else (7, 7, 3, 64))
    norms = {type(m).__name__ for m in model.modules()
             if "BatchNorm" in type(m).__name__}
    assert norms == {"FoldedBatchNorm" if folded else "BatchNorm"}
    x, y = _images(7, 2, 64)
    variables = compare(jmodel, model, x, y, train=True, tol=BN_TRAIN)
    if folded:
        assert "FoldedBatchNorm_0" in variables["params"]["ResNetBlock_0"]
    # eval mode on the updated running statistics
    upd = resnet.variables_to_numpy(model)
    with torch.no_grad():
        assert_rel(model(torch.from_numpy(x), train=False).numpy(),
                   jax.jit(functools.partial(jmodel.apply, train=False))(
                       upd, x), BN_TRAIN["logits"],
                   "eval logits")


def test_space_to_depth_stem_is_the_7x7_stride_2_conv():
    """The MLPerf construction through the port's own pieces: the 7x7/s2
    conv with padding 3 equals the 4x4/s1 conv (padding [(2, 1), (2, 1)])
    of the zero-padded-8x8 rearranged kernel on the space-to-depth input
    with channel order (a, b, c), which is what ResNet(space_to_depth)
    computes; both against XLA's 7x7 conv."""
    rng = np.random.default_rng(0)
    n, side, c, out_ch = 2, 32, 3, 8
    x = rng.standard_normal((n, side, side, c)).astype(np.float32)
    w7 = rng.standard_normal((7, 7, c, out_ch)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w7, window_strides=(2, 2), padding=[(3, 3), (3, 3)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    w8 = np.pad(w7, [(1, 0), (1, 0), (0, 0), (0, 0)])
    w4 = (w8.reshape(4, 2, 4, 2, c, out_ch).transpose(0, 2, 1, 3, 4, 5)
          .reshape(4, 4, 4 * c, out_ch))
    model = htt.ResNet18(num_classes=10, dtype=torch.float32,
                         space_to_depth=True, in_channels=c, device="cpu")
    model.conv_init_s2d.kernel.data = torch.from_numpy(
        np.pad(w4, [(0, 0), (0, 0), (0, 0), (0, 64 - out_ch)]))
    seen = {}
    model.conv_init_s2d.register_forward_hook(
        lambda m, i, o: seen.setdefault("y", o))
    with torch.no_grad():
        model(torch.from_numpy(x), train=False)
    y7 = resnet.conv_nhwc(torch.from_numpy(x), torch.from_numpy(w7), (2, 2),
                          [(3, 3), (3, 3)]).numpy()
    np.testing.assert_allclose(seen["y"][..., :out_ch].numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y7, want, rtol=1e-5, atol=1e-5)


def test_space_to_depth_rejects_odd_dims():
    model = htt.ResNet18(num_classes=10, space_to_depth=True, device="cpu")
    with pytest.raises(ValueError, match="even spatial dims"):
        model(torch.ones(1, 33, 33, 3))
    jmodel = jresnet.ResNet18(num_classes=10, space_to_depth=True)
    with pytest.raises(ValueError, match="even spatial dims"):
        jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 33, 33, 3)))


def test_zoo_is_exported_beside_the_jax_names():
    import horovod_tpu.models as jm
    import horovod_tpu_torch.models as pm
    for name in ("MLP", "MnistCNN", "ResNet", "ResNet18", "ResNet50",
                 "ResNet101", "VGG", "VGG11", "VGG16", "VGG19",
                 "InceptionV3", "TransformerConfig", "TransformerLM",
                 "fused_to_plain_variables", "plain_to_fused_variables"):
        assert hasattr(jm, name) and hasattr(pm, name), name
    assert inception.InceptionV3 is pm.InceptionV3
    if not torch.cuda.is_available():       # the entry points default to cuda
        for ctor in (vgg.VGG11, InceptionV3, MLP, MnistCNN):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                ctor()
