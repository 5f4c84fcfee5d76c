"""Data-parallel trainers: the port's "DistributedOptimizer loop".

The counterpart of ``horovod_tpu/parallel/trainer.py`` for ``dp_axis``
alone. One step is: forward and backward on this rank's rows of the
global batch (Horovod's convention: each rank feeds its own shard), the
gradient sync (one fused allreduce per dtype over the default process
group, NCCL on the card, then 1/W), and the optimizer update in place.
``make_transformer_train_step`` trains the flagship TransformerLM;
``data_parallel_train_step`` any ``nn.Module`` (ResNet) through a
``DistributedOptimizer``.

Not ported yet: ``make_transformer_train_step_fused``,
``DistributedApply`` and the reverse-backward bucket plan (with
``WireCodec``, ROADMAP A.6); and the checkpoint, preemption, verify-step,
artifact-store, goodput, numerics and straggler hooks of ``train_loop``
(slice 5).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.functions import broadcast_parameters
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.fusion import fused_group_apply
from horovod_tpu_torch.ops.reduce_ops import ReduceOp
from horovod_tpu_torch.runtime import context
from horovod_tpu_torch.utils import tree as tree_util
from horovod_tpu_torch.utils.device import resolve_device


class TrainState(NamedTuple):
    step: int
    params: Any                      # the parameter tree (leaf tensors)
    opt_state: Any                   # the torch.optim.Optimizer over them


def sync_gradients(grads: Any, sync_axes: Any, world: int) -> Any:
    """Sum each gradient leaf over its sync axes and scale by 1/W.

    Leaves that share an axes tuple sync as ONE fused allreduce per dtype
    (the fusion buffer of the reference): per step the collective count
    is the number of (axes group, dtype) pairs, not of parameters. Every
    axis of this slice is the data-parallel world, the default process
    group. The scale is skipped at W = 1. The reduction runs in place on
    the packed buffer (or, unbatched, on the gradient itself)."""

    def make_fn(axes):
        def one(buf):
            for _ in axes:
                buf = collectives.allreduce_(buf, ReduceOp.SUM)
            return buf.mul_(1.0 / world) if world != 1 else buf
        return one

    return fused_group_apply(grads, sync_axes, make_fn)


def _as_tokens(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=torch.long)


def make_transformer_train_step(
    cfg: tfm.TransformerConfig,
    make_optimizer: Callable[[list], torch.optim.Optimizer],
    *,
    device="cuda",
) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, train_step)`` for the flagship TransformerLM.

    - ``init_fn(params) -> TrainState``: takes a port parameter tree (from
      ``init_params`` or ``params_from_numpy``) on ``device``, broadcasts
      every leaf from rank 0 in place (so all ranks start equal), makes the
      leaves require grad, and builds the optimizer with
      ``make_optimizer(leaves)`` (leaves in sorted-key tree order).
    - ``train_step(state, tokens, labels) -> (state, loss)``: tokens and
      labels are this rank's rows ``[B/W, S]`` of the global batch (numpy
      or tensors); the returned loss is the global mean over all ranks'
      tokens, an f32 scalar on ``device``.

    ``torch.optim.SGD(leaves, lr=0.01, momentum=0.9)`` is
    ``optax.sgd(0.01, momentum=0.9)`` term for term: both keep
    ``trace = g + 0.9 * trace`` (the first step's trace is g) and apply
    ``p -= 0.01 * trace``. The update runs in place.

    With ``cfg.dp_axis`` set the runtime must be initialized
    (``horovod_tpu_torch.init``), and the world is every rank; with
    ``dp_axis=None`` the step runs alone, with no collective."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sync = tfm.grad_sync_axes(cfg)

    def world() -> int:
        return context.size() if cfg.dp_axis else 1

    def init_fn(params) -> TrainState:
        leaves = tree_util.tree_leaves(params)
        if any(t.device != dev for t in leaves):
            raise ValueError(f"init_fn: every parameter must be on {dev}")
        if cfg.dp_axis:
            broadcast_parameters(params, root_rank=0)
        for t in leaves:
            t.requires_grad_(True)
        return TrainState(0, params, make_optimizer(leaves))

    def train_step(state: TrainState, tokens, labels
                   ) -> Tuple[TrainState, torch.Tensor]:
        w = world()
        tokens, labels = _as_tokens(tokens, dev), _as_tokens(labels, dev)
        leaves, treedef = tree_util.tree_flatten(state.params)
        loss = tfm.loss_fn(cfg, state.params, tokens, labels)
        grads = torch.autograd.grad(loss, leaves)
        grads = sync_gradients(tree_util.tree_unflatten(treedef, list(grads)),
                               sync, w)
        for p, g in zip(leaves, tree_util.tree_leaves(grads)):
            p.grad = g
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        loss = loss.detach()
        if w != 1:
            loss = collectives.allreduce_(loss, ReduceOp.AVERAGE)
        return TrainState(state.step + 1, state.params, state.opt_state), loss

    return init_fn, train_step


def data_parallel_train_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer,
    *,
    device="cuda",
    axis: str = "hvd",
    bind_axis: bool = False,
) -> Tuple[Callable, Callable, Callable]:
    """Data-parallel trainer for any ``nn.Module`` (e.g. ``ResNet``): the
    ``hvd.DistributedOptimizer`` loop of the JAX package's
    ``data_parallel_train_step`` and ``bench.py``'s ``build_step``.

    ``loss_fn(model, *batch) -> scalar`` is written for one rank's rows
    (``batch`` = e.g. images and labels); ``optimizer`` is a
    ``DistributedOptimizer`` over the model's parameters. Returns
    ``(init_fn, train_step, put_batch)``:

    - ``init_fn(model) -> TrainState``: broadcasts every parameter and
      buffer from rank 0 (when the runtime is initialized);
    - ``put_batch(batch)``: this rank's rows of each leaf of a global
      batch (a tensor, numpy array, or tuple of them), on ``device``;
    - ``train_step(state, *batch) -> (state, loss)``: forward (the
      model's batch norms advance their running statistics in place),
      backward, the optimizer's gradient sync and update in place;
      ``loss`` is the mean over the ranks, an f32 scalar on ``device``.
      It takes the batch's leaves as ``train_loop`` splats them.

    ``bind_axis=True`` binds ``axis`` during the forward and backward, so
    a model built with ``bn_cross_replica_axis=axis`` sums its batch-norm
    statistics over the ranks (sync batch norm) through a differentiable
    allreduce."""
    from horovod_tpu_torch.parallel.distributed import DistributedOptimizer
    if not isinstance(optimizer, DistributedOptimizer):
        raise TypeError("data_parallel_train_step: pass a "
                        "DistributedOptimizer, which syncs the gradients")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def world() -> int:
        return context.size() if context.is_initialized() else 1

    def init_fn(model: torch.nn.Module) -> TrainState:
        if any(t.device != dev for t in model.parameters()):
            raise ValueError(f"init_fn: every parameter must be on {dev}")
        if context.is_initialized():
            broadcast_parameters(model, root_rank=0)
        return TrainState(0, model, optimizer)

    def put_batch(batch):
        if isinstance(batch, tuple):
            return tuple(put_batch(b) for b in batch)
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(np.ascontiguousarray(batch))
        w = world()
        if batch.shape[0] % w:
            raise ValueError(f"put_batch: {batch.shape[0]} rows do not "
                             f"split over {w} ranks")
        rows = batch.shape[0] // w
        r = context.rank() if context.is_initialized() else 0
        return batch[r * rows:(r + 1) * rows].to(dev)

    def train_step(state: TrainState, *batch
                   ) -> Tuple[TrainState, torch.Tensor]:
        binding = (collectives.bind_axis(axis) if bind_axis
                   else contextlib.nullcontext())
        with binding:
            loss = loss_fn(state.params, *batch)
            loss.backward()
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        loss = loss.detach().float()
        if world() != 1:
            loss = collectives.allreduce_(loss, ReduceOp.AVERAGE)
        return TrainState(state.step + 1, state.params, state.opt_state), loss

    return init_fn, train_step, put_batch


def train_loop(
    train_step: Callable,
    state: TrainState,
    batches: Iterable,
    *,
    checkpointer=None,
    preemption=None,
    on_step: Optional[Callable[[int, Any, Any], None]] = None,
):
    """Step ``train_step`` over ``batches``: ``(tokens, labels, ...)``
    tuples are splatted into it, anything else is passed as one argument.
    ``on_step(step, state, loss)`` runs after every step.

    Returns ``(state, info)`` with ``status`` ('completed'),
    ``exit_code`` (0), ``start_step`` and ``final_step``. Checkpointing
    and preemption (and the loop's other hooks in the JAX package) are
    not ported yet: passing a ``checkpointer`` or ``preemption`` raises
    ``NotImplementedError``."""
    if checkpointer is not None or preemption is not None:
        raise NotImplementedError(
            "train_loop: checkpointing and preemption are not yet ported "
            "to horovod_tpu_torch (slice 5)")
    step = int(state.step)
    info = {"status": "completed", "exit_code": 0, "start_step": step}
    for batch in batches:
        state, loss = (train_step(state, *batch) if isinstance(batch, tuple)
                       else train_step(state, batch))
        step += 1
        if on_step is not None:
            on_step(step, state, loss)
    info["final_step"] = step
    return state, info
