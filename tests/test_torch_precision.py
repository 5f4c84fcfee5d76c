"""The matmul precision knob of the port's train steps
(HOROVOD_TPU_MATMUL_PRECISION, ``horovod_tpu_torch/precision.py``) against
the JAX package's ``jit_step``: the names ``jax.default_matmul_precision``
accepts and refuses, the flags a step sets and restores (also when it
raises), and CPU losses bitwise equal at every setting."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtfm
import horovod_tpu_torch as htt
from horovod_tpu_torch import precision
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.parallel import trainer
from horovod_tpu_torch.utils import tree as tree_util

CFG_KW = dict(vocab_size=128, d_model=32, n_heads=2, head_dim=16,
              n_layers=2, d_ff=64, max_seq=64)
B, S = 2, 16
SETTINGS = ("default", "float32", "highest", "tensorfloat32", "high",
            "bfloat16", "F32_F32_F32", "TF32_TF32_F32", "BF16_BF16_F32")


def _jax_accepts(name) -> bool:
    try:
        with jax.default_matmul_precision(name):
            pass
        return True
    except ValueError:
        return False


def _jax_names():
    """The names JAX's config lists in its refusal."""
    try:
        with jax.default_matmul_precision("not-a-precision"):
            pass
    except ValueError as e:
        listed = str(e).split("[", 1)[1].split("]", 1)[0]
        return re.findall(r"'([^']+)'", listed)
    raise AssertionError("jax accepted a bogus precision")


@pytest.fixture(autouse=True)
def _clean():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    knobs.clear_override("HOROVOD_TPU_MATMUL_PRECISION")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.fixture()
def world_of_one():
    htt.init(device="cpu")
    yield
    htt.shutdown()


def test_the_port_knows_every_name_jax_accepts():
    assert tuple(_jax_names()) == precision.JAX_PRECISION_NAMES


@pytest.mark.parametrize("name", list(precision.JAX_PRECISION_NAMES)
                         + ["fastest", "bogus", "HIGHEST", "tf32"])
def test_names_jax_refuses_are_refused_and_the_rest_map(name):
    if not _jax_accepts(name):
        with pytest.raises(ValueError, match="jax.default_matmul_precision"):
            precision.resolve(name)
        return
    if name in precision.MODES:
        want = {"default": None, "float32": "ieee", "highest": "ieee",
                "F32_F32_F32": "ieee", "tensorfloat32": "tf32",
                "high": "tf32", "TF32_TF32_F32": "tf32",
                "bfloat16": "bf16", "BF16_BF16_F32": "bf16"}[name]
        assert precision.resolve(name) == want
    else:
        # a dot algorithm JAX accepts and torch has no flag for
        with pytest.raises(NotImplementedError, match="no CUDA flag"):
            precision.resolve(name)


def _quadratic_step(seen):
    """A data-parallel step of a quadratic on the CPU whose loss records
    the flags and the mode it ran under; a batch with a negative sum
    raises inside it."""
    w = torch.ones(4, 1, requires_grad=True)
    opt = htt.DistributedOptimizer(torch.optim.SGD([w], lr=0.1))

    def loss_fn(model, x):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32, precision.current()))
        if x.sum() < 0:
            raise RuntimeError("poisoned batch")
        return ((x @ model) ** 2).mean()

    _, step, _ = trainer.data_parallel_train_step(loss_fn, opt,
                                                  device="cpu")
    return step, trainer.TrainState(0, w, opt)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, precision.current())


@pytest.mark.parametrize("name,mode,tf32", [
    ("float32", "ieee", False), ("tensorfloat32", "tf32", True),
    ("bfloat16", "bf16", True)])
def test_step_sets_flags_inside_and_restores_them(world_of_one, name, mode,
                                                  tf32):
    knobs.set_override("HOROVOD_TPU_MATMUL_PRECISION", name)
    seen = []
    step, state = _quadratic_step(seen)
    # the caller's flags: the opposite of the step's, to see them restored
    torch.backends.cuda.matmul.allow_tf32 = not tf32
    torch.backends.cudnn.allow_tf32 = not tf32
    state, _ = step(state, torch.ones(8, 4))
    assert seen[-1] == (tf32, tf32, mode)
    assert _flags() == (not tf32, not tf32, None)
    with pytest.raises(RuntimeError, match="poisoned"):
        step(state, -torch.ones(8, 4))
    assert seen[-1] == (tf32, tf32, mode)
    assert _flags() == (not tf32, not tf32, None)


def test_default_leaves_the_step_unwrapped_and_bad_names_fail_at_build(
        world_of_one):
    seen = []
    step, _ = _quadratic_step(seen)
    assert not hasattr(step, "__wrapped__")
    knobs.set_override("HOROVOD_TPU_MATMUL_PRECISION", "fastest")
    with pytest.raises(ValueError, match="fastest"):
        _quadratic_step(seen)
    knobs.set_override("HOROVOD_TPU_MATMUL_PRECISION", "F16_F16_F32")
    with pytest.raises(NotImplementedError):
        htt.make_transformer_train_step(
            htt.TransformerConfig(**CFG_KW, dtype=torch.float32,
                                  dp_axis=None), lambda ps: None,
            device="cpu")


def test_nested_contexts_restore_in_order():
    torch.backends.cuda.matmul.allow_tf32 = False
    with precision.matmul_precision("tensorfloat32"):
        assert torch.backends.cuda.matmul.allow_tf32
        with precision.matmul_precision("float32"):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert precision.current() == "ieee"
        assert torch.backends.cuda.matmul.allow_tf32
        assert precision.current() == "tf32"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert precision.current() is None


def test_the_mode_is_per_thread():
    import threading
    seen = []
    with precision.matmul_precision("bfloat16"):
        t = threading.Thread(target=lambda: seen.append(precision.current()))
        t.start()
        t.join()
        assert precision.current() == "bf16"
    assert seen == [None]


def test_building_a_step_beside_a_serving_fleet_warns(monkeypatch):
    """The TF32 flags are process-wide while a step runs: a step built
    under a non-default setting beside a live fleet says so; 'default'
    and a process without a fleet stay quiet."""
    from horovod_tpu_torch.serving import fleet
    said = []
    monkeypatch.setattr(precision.logger, "warning",
                        lambda *a: said.append(a[0] % a[1:]))
    precision.wrap_step(lambda: None, "tensorfloat32")
    assert said == []
    monkeypatch.setattr(fleet, "_active_fleet", object())
    precision.wrap_step(lambda: None, "default")
    assert said == []
    precision.wrap_step(lambda: None, "tensorfloat32")
    assert len(said) == 1 and "serving fleet" in said[0]


def _np_params():
    jcfg = jtfm.TransformerConfig(**CFG_KW, dtype=jnp.float32, dp_axis=None,
                                  remat=False, mlp_recompute=False)
    return jcfg, jax.tree.map(np.asarray,
                              jtfm.init_params(jcfg, jax.random.PRNGKey(0)))


def test_cpu_losses_are_bitwise_equal_at_every_setting():
    """The flagship's step on the CPU: three steps at each setting give
    the same losses and parameters bit for bit (the knob changes CUDA
    flags and the card's f32 products only), and the first loss is JAX's
    on the same weights and batch."""
    jcfg, np_params = _np_params()
    cfg = htt.TransformerConfig(**CFG_KW, dtype=torch.float32, dp_axis=None,
                                remat=False, mlp_recompute=False)
    rng = np.random.default_rng(5)
    batches = [(rng.integers(0, CFG_KW["vocab_size"], (B, S)),
                rng.integers(0, CFG_KW["vocab_size"], (B, S)))
               for _ in range(3)]
    jloss = float(jtfm.loss_fn(jcfg, np_params, jnp.asarray(batches[0][0]),
                               jnp.asarray(batches[0][1])))
    runs = {}
    for name in SETTINGS:
        knobs.set_override("HOROVOD_TPU_MATMUL_PRECISION", name)
        params = htt.params_from_numpy(np_params, device="cpu")
        init_fn, step = htt.make_transformer_train_step(
            cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
            device="cpu")
        state = init_fn(params)
        losses = []
        for tokens, labels in batches:
            state, loss = step(state, tokens, labels)
            losses.append(loss.item())
        leaves = [t.detach().numpy().copy()
                  for t in tree_util.tree_leaves(state.params)]
        runs[name] = (losses, leaves)
    ref_losses, ref_leaves = runs["default"]
    np.testing.assert_allclose(ref_losses[0], jloss, rtol=1e-5)
    for name, (losses, leaves) in runs.items():
        assert losses == ref_losses, name
        assert all(np.array_equal(a, b)
                   for a, b in zip(leaves, ref_leaves)), name


def test_ce_backward_keeps_the_mode_of_its_forward(monkeypatch):
    """The blockwise CE decides on bf16 inputs in its forward, on the
    step's thread, and its backward keeps that decision: on the card the
    backward runs on autograd's device thread, which the step's
    per-thread mode does not reach. (On the CPU no product takes bf16
    inputs; the test lets the CPU tensors stand for the card's.)"""
    from horovod_tpu_torch.ops import blockwise_ce as ce
    calls = []

    def bf16_mm(a, b):
        calls.append(1)
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()

    monkeypatch.setattr(ce, "_bf16_inputs",
                        lambda t: precision.current() == "bf16")
    monkeypatch.setattr(ce, "_bf16_mm", bf16_mm)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 8, generator=gen, requires_grad=True)
    head = torch.randn(8, 20, generator=gen, requires_grad=True)
    labels = torch.randint(0, 20, (6,), generator=gen)
    with precision.matmul_precision("bfloat16"):
        loss = ce.blockwise_cross_entropy(x, head, labels, block=7).sum()
    assert len(calls) == 3                  # the forward's three chunks
    loss.backward()                         # outside the step's mode
    # the backward recomputes each chunk's logits and takes two products
    assert len(calls) == 3 + 3 * 3
    calls.clear()
    ce.blockwise_cross_entropy(x, head, labels, block=7).sum().backward()
    assert calls == []
