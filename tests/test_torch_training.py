"""The PyTorch port's training slice against the JAX package, on the CPU.

The tiny config of ``tests/test_fleet.py`` (d=64, H=4, Dh=16, L=2,
d_ff=128, V=256, f32) runs through the JAX ``loss_fn`` and trainer and
through the port's, with the JAX weights carried across by
``params_from_numpy`` and the same numpy batches. Tolerances: f32 parity
at rtol/atol 1e-5 (the two frameworks sum in different orders);
parameters after several SGD steps at 1e-5 as well, since each step moves
them by lr * grad ~ 1e-3.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.ops import blockwise_ce as jce
from horovod_tpu.parallel import trainer as jtrainer
import horovod_tpu_torch as htt
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import blockwise_ce as ce
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import tensor_parallel as tp_lib
from horovod_tpu_torch.parallel import trainer
from horovod_tpu_torch.utils import tree as tree_util
import test_torch_workers as workers

TOL = dict(rtol=1e-5, atol=1e-5)
CFG_KW = dict(vocab_size=256, d_model=64, n_heads=4, head_dim=16,
              n_layers=2, d_ff=128, max_seq=256)
B, S = 4, 32


def _jcfg(**kw):
    return jtfm.TransformerConfig(**{**CFG_KW, "dtype": jnp.float32,
                                     "dp_axis": None, "remat": False,
                                     "mlp_recompute": False, **kw})


def _cfg(**kw):
    return htt.TransformerConfig(**{**CFG_KW, "dtype": torch.float32,
                                    "dp_axis": None, "remat": False,
                                    "mlp_recompute": False, **kw})


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray,
                        jtfm.init_params(_jcfg(), jax.random.PRNGKey(0)))


def _batches(n, b=B, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG_KW["vocab_size"], (b, S)).astype(np.int32),
             rng.integers(0, CFG_KW["vocab_size"], (b, S)).astype(np.int32))
            for _ in range(n)]


def _sgd(leaves):
    return torch.optim.SGD(leaves, lr=0.01, momentum=0.9)


def _assert_tree_close(port_tree, jax_tree, tol=TOL, what=""):
    pl, _ = tree_util.tree_flatten(port_tree)
    jl = jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl)
    for i, (p, j) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(p.detach().cpu().numpy(), np.asarray(j),
                                   **tol, err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# blockwise cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,block", [(250, 64), (256, 256), (250, 1000)])
def test_blockwise_ce_matches_jax_and_unfused(v, block):
    """Loss and d(x), d(head) against JAX blockwise_cross_entropy and the
    port's own unfused path (block=0). V=250 at block 64 leaves a ragged
    last chunk."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    head = (rng.standard_normal((32, v)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, (3, 7)).astype(np.int32)
    w = rng.standard_normal((3, 7)).astype(np.float32)   # a weighted sum

    def jloss(x, head):
        return jnp.sum(w * jce.blockwise_cross_entropy(x, head, labels,
                                                       block=block))

    j_loss = jce.blockwise_cross_entropy(jnp.asarray(x), jnp.asarray(head),
                                         labels, block=block)
    j_dx, j_dh = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(head))
    for blk in (block, 0):
        tx = torch.from_numpy(x).requires_grad_(True)
        th = torch.from_numpy(head).requires_grad_(True)
        loss = tp_lib.vocab_parallel_cross_entropy(
            tx, th, torch.from_numpy(labels), None, block=blk)
        (torch.from_numpy(w) * loss).sum().backward()
        np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss),
                                   **TOL, err_msg=f"loss, block={blk}")
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_dx), **TOL,
                                   err_msg=f"dx, block={blk}")
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(j_dh), **TOL,
                                   err_msg=f"dhead, block={blk}")


def test_blockwise_ce_default_block_reads_the_knob(monkeypatch):
    assert ce.default_block() == 1024
    monkeypatch.setenv("HOROVOD_CE_BLOCK_VOCAB", "0")
    assert ce.default_block() == 0 == jce.default_block()
    with pytest.raises(NotImplementedError, match="tp_axis"):
        ce.blockwise_cross_entropy(torch.zeros(2, 4), torch.zeros(4, 8),
                                   torch.zeros(2, dtype=torch.long), "tp")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_loss_and_grads(np_params):
    tokens, labels = _batches(1)[0]
    fn = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(_jcfg(), p, tokens, labels)))
    loss, grads = fn(jax.tree.map(jnp.asarray, np_params))
    return float(loss), grads


@pytest.mark.parametrize("remat,mlp_recompute", [(False, False),
                                                 (False, True),
                                                 (True, False),
                                                 (True, True)])
def test_loss_and_every_gradient_leaf_match_jax(np_params,
                                                jax_loss_and_grads, remat,
                                                mlp_recompute):
    """loss_fn and every gradient leaf against jax.value_and_grad of the
    JAX loss_fn (dp_axis=None); recompute settings must not move them."""
    tokens, labels = _batches(1)[0]
    cfg = _cfg(remat=remat, mlp_recompute=mlp_recompute)
    params = htt.params_from_numpy(np_params, device="cpu")
    leaves = tree_util.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    fa.reset_launches()
    loss = tfm.loss_fn(cfg, params, torch.from_numpy(tokens),
                       torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, leaves)
    assert all(n == 0 for n in fa.LAUNCHES.values())
    j_loss, j_grads = jax_loss_and_grads
    np.testing.assert_allclose(loss.item(), j_loss, **TOL)
    for i, (g, jg) in enumerate(zip(grads, jax.tree.leaves(j_grads))):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL,
                                   err_msg=f"gradient leaf {i}")


def test_logits_and_wrapper_match_jax(np_params):
    tokens, _ = _batches(1)[0]
    j_logits = jtfm.logits_fn(_jcfg(), jax.tree.map(jnp.asarray, np_params),
                              tokens)
    lm = htt.TransformerLM(_cfg())
    logits = lm.apply(htt.params_from_numpy(np_params, device="cpu"),
                      torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    assert set(lm.init(torch.Generator().manual_seed(0), "cpu")) == set(
        np_params)


def test_later_slices_raise_not_implemented(np_params):
    params = htt.params_from_numpy(np_params, device="cpu")
    tokens = torch.zeros(1, 8, dtype=torch.long)
    for kw, what in ((dict(tp_axis="tp"), "slice 3"),
                     (dict(sp_axis="sp"), "slice 4"),
                     (dict(ep_axis="ep"), "slice 4"),
                     (dict(pp_axis="pp"), "slice 4"),
                     (dict(num_experts=2), "slice 4")):
        with pytest.raises(NotImplementedError, match=what):
            tfm.loss_fn(_cfg(**kw), params, tokens, tokens)
    with pytest.raises(ValueError, match="max_seq"):
        tfm.forward(_cfg(max_seq=4), params, tokens)


def test_grad_sync_axes_mirror_the_parameter_tree(np_params):
    jsync = jtfm.grad_sync_axes(_jcfg(dp_axis="dp"))
    sync = tfm.grad_sync_axes(_cfg(dp_axis="dp"))
    assert jax.tree.leaves(jsync, is_leaf=lambda x: isinstance(x, tuple)) \
        == tree_util.tree_leaves(sync) == [("dp",)] * 11
    assert tfm.mesh_axes(_cfg(dp_axis="dp")) == ("dp",)
    assert tfm.mesh_axes(_cfg()) == ()
    assert set(sync) == set(np_params)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _jax_trajectory(np_params, batches, n_dev):
    """JAX make_transformer_train_step on an n_dev-device dp mesh with
    optax.sgd(0.01, momentum=0.9): (losses, final params)."""
    cfg = _jcfg(dp_axis="dp")
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    opt = optax.sgd(0.01, momentum=0.9)
    _, step = jtrainer.make_transformer_train_step(cfg, opt, mesh)
    params = jax.device_put(jax.tree.map(jnp.asarray, np_params),
                            NamedSharding(mesh, P()))
    state = jtrainer.TrainState(jnp.zeros((), jnp.int32), params,
                                opt.init(params))
    losses = []
    for tokens, labels in batches:
        state, loss = step(state, tokens, labels)
        losses.append(float(loss))
    return losses, state.params


def test_one_rank_three_steps_match_jax_one_device_mesh(np_params):
    batches = _batches(3)
    j_losses, j_params = _jax_trajectory(np_params, batches, 1)
    htt.init(device="cpu")
    try:
        init_fn, step = htt.make_transformer_train_step(
            _cfg(dp_axis="dp", mlp_recompute=True), _sgd, device="cpu")
        state = init_fn(htt.params_from_numpy(np_params, device="cpu"))
        losses = []
        state, info = htt.train_loop(
            step, state, batches,
            on_step=lambda i, s, loss: losses.append(float(loss)))
    finally:
        htt.shutdown()
    assert info == {"status": "completed", "exit_code": 0, "start_step": 0,
                    "final_step": 3, "restored": False}
    assert state.step == 3
    np.testing.assert_allclose(losses, j_losses, **TOL)
    _assert_tree_close(state.params, j_params, what="params after 3 steps")


def test_two_rank_gloo_world_matches_jax_two_device_mesh(np_params,
                                                         tmp_path):
    """Horovod's contract: W ranks on B/W rows each give the single-step
    gradient of the global mean. Two gloo processes, two steps, against
    the JAX trainer on a 2-device dp mesh (computed while the ranks run)."""
    batches = _batches(2)
    procs = workers.start_world(
        workers.dp_worker, 2, _cfg(dp_axis="dp", mlp_recompute=True),
        np_params, batches, str(tmp_path))
    try:
        j_losses, j_params = _jax_trajectory(np_params, batches, 2)
    finally:
        workers.join_world(procs)
    j_leaves = jax.tree.leaves(j_params)
    for r in range(2):
        out = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(out["losses"], j_losses, **TOL,
                                   err_msg=f"rank {r} losses")
        for i, jl in enumerate(j_leaves):
            np.testing.assert_allclose(out[f"arr_{i}"], np.asarray(jl),
                                       **TOL, err_msg=f"rank {r} leaf {i}")


def test_sync_gradients_fuses_and_scales(monkeypatch):
    htt.init(device="cpu")
    try:
        grads = {"a": torch.ones(3), "b": {"c": torch.full((2, 2), 4.0),
                                           "d": torch.ones(2).double()}}
        axes = {"a": ("dp",), "b": ("dp",)}
        calls = []
        real = trainer.collectives.allreduce_

        def counting(buf, op):
            calls.append(tuple(buf.shape))
            return real(buf, op)

        monkeypatch.setattr(trainer.collectives, "allreduce_", counting)
        out = trainer.sync_gradients(grads, axes, world=4)
        assert sorted(calls) == [(2,), (7,)]          # one per dtype
        torch.testing.assert_close(out["b"]["c"], torch.ones(2, 2))
        torch.testing.assert_close(out["a"], torch.full((3,), 0.25))
        assert out["b"]["d"].dtype == torch.float64
        calls.clear()
        monkeypatch.setenv("HOROVOD_BATCH_D2D_MEMCOPIES", "0")
        trainer.sync_gradients(grads, axes, world=1)
        assert sorted(calls) == [(2,), (2, 2), (3,)]  # one per tensor
    finally:
        htt.shutdown()


def test_train_loop_hooks_of_later_slices_raise(monkeypatch):
    """The loop's hooks that are not ported yet raise, naming their
    ROADMAP item, when a knob turns them on (checkpointing and preemption
    are ported: tests/test_torch_resilience.py)."""
    state = trainer.TrainState(0, {}, None)
    for knob, value, item in (("HOROVOD_VERIFY_STEP", "1", "A.15"),
                              ("HOROVOD_ARTIFACT_STORE", "/s", "A.13"),
                              ("HOROVOD_TRACE_PROFILE", "steps:2", "A.13"),
                              ("HOROVOD_NUMERICS", "1", "A.13")):
        monkeypatch.setenv(knob, value)
        with pytest.raises(NotImplementedError, match=item):
            htt.train_loop(lambda s, b: (s, 0.0), state, [1])
        monkeypatch.delenv(knob)
    seen = []
    state, info = htt.train_loop(
        lambda s, b: (trainer.TrainState(s.step + 1, {}, None), b), state,
        [7, 8], on_step=lambda i, s, loss: seen.append((i, loss)))
    assert seen == [(1, 7), (2, 8)] and info["final_step"] == 2


def test_runtime_and_trainer_default_to_cuda_and_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        htt.init()
    assert not htt.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        htt.make_transformer_train_step(_cfg(), _sgd)


def test_runtime_init_is_idempotent_and_reinitializes():
    from horovod_tpu_torch import runtime
    with pytest.raises(runtime.NotInitializedError):
        htt.size()
    ctx = htt.init(device="cpu")
    try:
        assert htt.init(device="cpu") is ctx and ctx.backend == "gloo"
        assert (htt.size(), htt.rank(), htt.local_size(),
                htt.local_rank()) == (1, 0, 1, 0)
        assert (runtime.cross_size(), runtime.cross_rank()) == (1, 0)
        htt.shutdown()
        assert not htt.is_initialized()
        ctx = htt.init(device="cpu")
        assert htt.size() == 1
    finally:
        htt.shutdown()
    htt.shutdown()                              # a second shutdown is a no-op
