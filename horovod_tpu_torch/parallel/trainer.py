"""Trainers: the port's "DistributedOptimizer loop".

The counterpart of ``horovod_tpu/parallel/trainer.py``. One step is:
forward and backward on this rank's block of the global batch (Horovod's
convention: each rank feeds its own shard), the gradient sync (one fused
allreduce per (axes, dtype) and axis over that axis's process group,
NCCL on the card, then 1/W), and the optimizer update in place.
``make_transformer_train_step`` trains the flagship TransformerLM on any
mesh of its axes (data, tensor, sequence, expert and pipeline
parallelism); ``make_transformer_train_step_fused`` trains it on the
same meshes with the bucketed sync launched from the gradient hooks
(one set of buckets per group of sync axes) and the optimizer update in
each bucket's epilogue (``DistributedApply``);
``data_parallel_train_step`` trains any ``nn.Module`` (ResNet) through a
``DistributedOptimizer``.

Each of the three reads ``HOROVOD_TPU_MATMUL_PRECISION`` when it builds
the step, as the JAX package's ``jit_step`` does, and runs every step
under it (``precision.py``).

``train_loop`` is the resilient step loop of the JAX package
(``horovod_tpu/parallel/trainer.py:203-385``): restore before step 1,
snapshots off the step path, preemption quiesce with the resumable exit
code, step stats, goodput phases, spans, the chaos hook, straggler
detection, the ``HOROVOD_TRACE_PROFILE`` capture window
(``tracing/profile.py``) and the numerics monitor's loss feed
(``goodput/numerics.py``). With ``HOROVOD_ARTIFACT_STORE`` set it serves
the step's kernels from the compiled-artifact store before step 1
(``_adopt_store_step``). Its verify-step hook is not ported yet
(ROADMAP A.15): ``HOROVOD_VERIFY_STEP`` raises.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch import precision
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
    """Sum each gradient leaf once over the group of each of its sync
    axes, then scale by 1/W (the JAX ``sync_gradients``: a psum per axis).

    Leaves that share an axes tuple sync as ONE fused allreduce per
    (axes, dtype) and axis (the fusion buffer of the reference): per step
    the collective count is the number of (axes group, dtype) pairs times
    their axes, not the number of parameters. The scale is skipped at
    W = 1. The reduction runs in place on the packed buffer (or,
    unbatched, on the gradient itself). An axis name the mesh lacks
    stands for every rank (``collectives.axis_of``)."""

    def make_fn(axes):
        mesh = [collectives.axis_of(a) for a in axes]

        def one(buf):
            for ax in mesh:
                buf = collectives.allreduce_(buf, ReduceOp.SUM, ax)
            return buf.mul_(1.0 / world) if world != 1 else buf
        return one

    return fused_group_apply(grads, sync_axes, make_fn)


def _as_tokens(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=torch.long)


def mesh_world(cfg: tfm.TransformerConfig) -> int:
    """W of the 1/W scale: the product of the sizes of the configuration's
    mesh axes (1 without any)."""
    axes = tfm.mesh_axes(cfg)
    if not axes:
        return 1
    topo = context.get_context().topology
    return int(np.prod([topo.axis_size(collectives.axis_of(a)) for a in axes]))


def _broadcast_replicas(cfg: tfm.TransformerConfig, params) -> None:
    """Make every leaf equal over the axes it is replicated on: each is
    broadcast from the first rank along its sync axes (ranks on different
    tp, ep or pp shards hold different leaves)."""
    sync = tree_util.tree_leaves(tfm.grad_sync_axes(cfg))
    with torch.no_grad():
        for t, axes in zip(tree_util.tree_leaves(params), sync):
            if axes:
                collectives.broadcast_(
                    t.data, 0, tuple(collectives.axis_of(a) for a in axes))


def make_transformer_train_step(
    cfg: tfm.TransformerConfig,
    make_optimizer: Callable[[list], torch.optim.Optimizer],
    *,
    device="cuda",
) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, train_step)`` for the flagship TransformerLM on
    the runtime's mesh (the JAX ``make_transformer_train_step``).

    - ``init_fn(params) -> TrainState``: takes this rank's parameter
      shard (``shard_params`` of a global tree from ``init_params`` or
      ``params_from_numpy``) on ``device``, broadcasts every leaf in
      place from the first rank of the axes it is replicated on (so all
      replicas start equal), makes the leaves require grad, and builds
      the optimizer with ``make_optimizer(leaves)`` (leaves in sorted-key
      tree order).
    - ``train_step(state, tokens, labels) -> (state, loss)``: tokens and
      labels are this rank's block of the global batch (``shard_batch``;
      for data parallelism alone, its rows ``[B/W, S]``), numpy or
      tensors; the step binds the configuration's axes, sums each
      gradient over its replicated axes' groups and scales by 1/W (W the
      product of the mesh axes), and updates in place. The loss is the
      global mean over every token, an f32 scalar on ``device``.

    ``torch.optim.SGD(leaves, lr=0.01, momentum=0.9)`` is
    ``optax.sgd(0.01, momentum=0.9)`` term for term: both keep
    ``trace = g + 0.9 * trace`` (the first step's trace is g) and apply
    ``p -= 0.01 * trace``.

    With any mesh axis set the runtime must be initialized
    (``horovod_tpu_torch.init``, with ``mesh_shape``/``axis_names``
    naming the axes when there are several); a data-parallel axis alone
    may be absent from the mesh and then spans every rank. With every
    axis None the step runs alone, with no collective."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sync = tfm.grad_sync_axes(cfg)
    axes = tfm.mesh_axes(cfg)

    def init_fn(params) -> TrainState:
        leaves = tree_util.tree_leaves(params)
        if any(t.device != dev for t in leaves):
            raise ValueError(f"init_fn: every parameter must be on {dev}")
        if axes:
            tfm.check_mesh(cfg)
            _broadcast_replicas(cfg, params)
        for t in leaves:
            t.requires_grad_(True)
        return TrainState(0, params, make_optimizer(leaves))

    def train_step(state: TrainState, tokens, labels
                   ) -> Tuple[TrainState, torch.Tensor]:
        w = mesh_world(cfg)
        tokens, labels = _as_tokens(tokens, dev), _as_tokens(labels, dev)
        leaves, treedef = tree_util.tree_flatten(state.params)
        with collectives.bind_axis(*axes):
            loss = tfm.loss_fn(cfg, state.params, tokens, labels)
            grads = torch.autograd.grad(loss, leaves)
            grads = sync_gradients(
                tree_util.tree_unflatten(treedef, list(grads)), sync, w)
        for p, g in zip(leaves, tree_util.tree_leaves(grads)):
            p.grad = g
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        return (TrainState(state.step + 1, state.params, state.opt_state),
                loss.detach())

    return init_fn, precision.wrap_step(train_step)


def make_transformer_train_step_fused(
    cfg: tfm.TransformerConfig,
    apply_opt,
    *,
    device="cuda",
) -> Tuple[Callable, Callable]:
    """The bucketed sync + optimizer-in-epilogue flagship step: the same
    ``TrainState`` and signature as :func:`make_transformer_train_step`.

    ``apply_opt`` is a ``DistributedApply`` (``distributed_apply(
    EpilogueSGD(...), sync_axes=grad_sync_axes(cfg))``), whose leaves
    sync in one group per tuple of sync axes. ``init_fn(params)`` takes
    this rank's shard (``shard_params``), broadcasts each leaf from the
    first rank of the axes it is replicated on, makes the leaves require
    grad, installs the gradient hooks and returns ``TrainState(0, params,
    apply_opt.init(params))``. ``train_step`` binds every axis of the
    configuration and runs ``loss.backward()``; the hooks launch each
    bucket of the reverse sorted-key leaf list (the JAX package's order,
    so the plans and the fp8 scales are the reference's) once its
    gradients are complete, and the update of each bucket runs in place
    as soon as its sync completes. The loss is the global mean over every
    token, and every leaf's sum is divided by W, the product of the mesh
    axes, as in :func:`make_transformer_train_step`, so the two steps
    update alike on every mesh. (The JAX fused step divides a leaf by its
    own sync group's size, so there a leaf sharded over tp, ep or pp moves
    by W over that size times the unfused step's update.) The fp8 encode
    keeps the group's size as its headroom, so the wire bits and the
    error-feedback residual (per rank, in ``state.opt_state``) are the
    JAX fused step's."""
    from horovod_tpu_torch.parallel.distributed import DistributedApply
    if not isinstance(apply_opt, DistributedApply):
        raise TypeError(
            "make_transformer_train_step_fused needs a DistributedApply "
            "(distributed_apply(EpilogueSGD(...), sync_axes=grad_sync_axes"
            "(cfg))); for a torch optimizer use make_transformer_train_step")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    axes = tfm.mesh_axes(cfg)
    attached = {}

    def init_fn(params) -> TrainState:
        leaves = tree_util.tree_leaves(params)
        if any(t.device != dev for t in leaves):
            raise ValueError(f"init_fn: every parameter must be on {dev}")
        if axes:
            tfm.check_mesh(cfg)
            _broadcast_replicas(cfg, params)
        for t in leaves:
            t.requires_grad_(True)
        if "launcher" in attached:
            attached["launcher"].remove_hooks()
        attached["launcher"] = apply_opt.attach(params,
                                                world=mesh_world(cfg))
        attached["leaves"] = leaves
        return TrainState(0, params, apply_opt.init(params))

    def train_step(state: TrainState, tokens, labels
                   ) -> Tuple[TrainState, torch.Tensor]:
        leaves = tree_util.tree_leaves(state.params)
        launcher = attached.get("launcher")
        if launcher is None or any(
                a is not b for a, b in zip(leaves, attached["leaves"])):
            raise ValueError("train_step: pass the TrainState of init_fn "
                             "(its leaves carry the gradient hooks)")
        launcher.bind(None, tree_util.tree_leaves(state.opt_state.residual)
                      if launcher.sync.ef else None)
        tokens, labels = _as_tokens(tokens, dev), _as_tokens(labels, dev)
        with collectives.bind_axis(*axes):
            loss = tfm.loss_fn(cfg, state.params, tokens, labels)
            loss.backward()
        params, opt_state = apply_opt.apply_attached(launcher, state.params,
                                                     state.opt_state)
        for p in leaves:
            p.grad = None
        return TrainState(state.step + 1, params, opt_state), loss.detach()

    return init_fn, precision.wrap_step(train_step)


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

    return init_fn, precision.wrap_step(train_step), put_batch


def _unported_loop_knobs() -> None:
    """Raise for a knob that turns on a train_loop hook the port does
    not have yet: a run must never skip such a hook silently."""
    from horovod_tpu_torch.config import knobs
    if str(knobs.get("HOROVOD_VERIFY_STEP")) in ("1", "strict"):
        raise NotImplementedError(
            "train_loop: HOROVOD_VERIFY_STEP turns on a hook that is not "
            "yet ported to horovod_tpu_torch (ROADMAP A.15); unset it")
    from horovod_tpu_torch.resilience import chaos
    unported = chaos.unported_faults()
    if unported:
        raise NotImplementedError(
            f"train_loop: the chaos spec drills subsystems that are not yet "
            f"ported to horovod_tpu_torch: "
            f"{', '.join(f'{f} (ROADMAP {i})' for f, i in unported)}; "
            f"remove them from HOROVOD_CHAOS_SPEC")


def train_loop(
    train_step: Callable,
    state: TrainState,
    batches: Iterable,
    *,
    checkpointer=None,
    preemption=None,
    step_stats=None,
    on_step: Optional[Callable[[int, Any, Any], None]] = None,
):
    """Resilient step loop around ``train_step``: restore, step, measure,
    snapshot off the step path, quiesce on preemption.

    - ``checkpointer`` (resilience.AsyncCheckpointer, or None): the loop
      restores the latest committed snapshot into ``state`` before the
      first step (the auto-resume path: tensors, modules and optimizers
      are written in place, so gradient hooks and bound residuals keep
      working) and calls ``maybe_save`` after every step, which blocks
      only to issue the device->host copy. Built from
      ``HOROVOD_CKPT_DIR`` when unset.
    - ``preemption`` (resilience.PreemptionHandler, or None): checked
      every step; at the agreed quiesce step the loop commits a final
      synchronous snapshot and returns with the resumable status. When
      unset, the process-global installed handler is used; when none is
      installed and ``HOROVOD_PREEMPTION_FILE`` is set, one is built for
      the duration of the loop (signal hooks included).
    - ``step_stats`` (callbacks.StepStats, or None=create): per-step wall
      time feeds ``hvd_step_duration_seconds``, what the auto checkpoint
      cadence tunes against, and the straggler detector.
    - ``on_step(step, state, loss)``: caller hook (logging, eval, ...).

    Every step feeds the goodput phases (input_wait, step_compute,
    checkpoint, restart), a ``train.step`` span, the chaos hook and, in a
    world larger than one, the straggler detector.
    ``HOROVOD_TRACE_PROFILE=steps:N[@S]`` opens a torch.profiler window at
    the end of step S-1 and closes it N steps later
    (``tracing.profile.StepProfiler``; closed in the loop's ``finally``
    too). ``HOROVOD_NUMERICS=1`` hands each step's loss to the numerics
    monitor (a device tensor, converted at the monitor's cadence) and
    drains it when the loop ends; under ``HOROVOD_NUMERICS_ACTION=abort``
    an anomaly raises ``NumericsAnomalyError`` out of the loop.
    ``HOROVOD_ARTIFACT_STORE`` serves the step's kernels from the
    compiled-artifact store before step 1, or records and publishes them
    after it (``info["store_step"]``: hit | miss | error).
    ``HOROVOD_VERIFY_STEP`` in {1, strict} raises ``NotImplementedError``:
    its hook is not ported yet (ROADMAP A.15). So would an armed chaos
    spec with a fault of a subsystem not ported yet
    (``chaos.unported_faults``; none is left). The data service's knobs
    ``HOROVOD_FAULT_HEARTBEAT_SECONDS`` and ``HOROVOD_FAULT_WORKER_DEADLINE``
    tune its workers and consumers (``data.compute_service``), which feed
    the loop through ``batches``.

    Returns ``(state, info)`` where ``info`` carries ``status``
    ('completed' | 'preempted'), ``exit_code`` (0 or the resumable 75),
    ``start_step``/``final_step``, and ``restored`` (bool). The caller
    owns process exit: ``sys.exit(info['exit_code'])``.

    Batches are ``(tokens, labels, ...)`` tuples splatted into
    ``train_step``, or single objects passed as one argument."""
    from horovod_tpu_torch.callbacks import StepStats
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.goodput import accountant as _goodput
    from horovod_tpu_torch.goodput import numerics as _numerics
    from horovod_tpu_torch.parallel.distributed import (
        record_step_wire_metrics)
    from horovod_tpu_torch.resilience import chaos
    from horovod_tpu_torch.resilience.preemption import RESUMABLE_EXIT_CODE
    from horovod_tpu_torch.tracing import spans as trace
    from horovod_tpu_torch.tracing import straggler as _straggler
    from horovod_tpu_torch.tracing.profile import StepProfiler

    _unported_loop_knobs()
    owned_checkpointer = False
    if checkpointer is None:
        ckpt_dir = knobs.get("HOROVOD_CKPT_DIR")
        if ckpt_dir:
            from horovod_tpu_torch.resilience import AsyncCheckpointer
            checkpointer = AsyncCheckpointer(ckpt_dir)
            owned_checkpointer = True
    owned_handler = False
    if preemption is None:
        from horovod_tpu_torch.resilience import preemption as _preemption
        preemption = _preemption.active_handler()
        if preemption is None and knobs.get("HOROVOD_PREEMPTION_FILE"):
            from horovod_tpu_torch.resilience import PreemptionHandler
            preemption = PreemptionHandler(checkpointer=checkpointer)
            owned_handler = True
    stats = step_stats or StepStats()
    info = {"status": "completed", "exit_code": 0, "restored": False}
    step = int(state.step) if hasattr(state, "step") else 0
    profiler = None
    try:
        if checkpointer is not None:
            # Goodput: restore time is 'restart', the cost a preemption
            # or crash charged this incarnation before step 1.
            with _goodput.phase_scope(_goodput.RESTART):
                restored = checkpointer.restore_latest(template=state)
            if restored is not None:
                step, state = restored
                info["restored"] = True
        info["start_step"] = step
        from horovod_tpu_torch.store import artifact_store as _store
        if _store.enabled():
            train_step, batches = _adopt_store_step(
                train_step, state, batches, info)
        # Straggler detection: from_env returns None in a world of one.
        straggler = _straggler.active_detector() or _straggler.from_env()
        profiler = StepProfiler.from_env()
        monitor = _numerics.get_monitor()
        stats.begin()
        batch_it = iter(batches)
        reserved = False
        while True:
            # Goodput: pulling the next batch is input-wait.
            _goodput.set_phase(_goodput.INPUT_WAIT)
            try:
                batch = next(batch_it)
            except StopIteration:
                break
            chaos.on_step(step)
            if preemption is not None and preemption.check(step):
                if checkpointer is not None:
                    with _goodput.phase_scope(_goodput.CHECKPOINT), \
                            trace.span("preemption.drain",
                                       cat=trace.CAT_PREEMPTION,
                                       attrs={"step": step}
                                       if trace.enabled() else None):
                        checkpointer.save(step, state, sync=True)
                info["status"] = "preempted"
                info["exit_code"] = RESUMABLE_EXIT_CODE
                break
            _goodput.set_phase(_goodput.STEP_COMPUTE)
            step_span = trace.span(
                "train.step", cat=trace.CAT_TRAIN,
                attrs={"step": step} if trace.enabled() else None)
            step_span.__enter__()
            try:
                state, loss = (train_step(state, *batch)
                               if isinstance(batch, tuple)
                               else train_step(state, batch))
            finally:
                step_span.__exit__(None, None, None)
            step += 1
            # Charge the step's gradient wire traffic to the counters.
            record_step_wire_metrics()
            # stats.end() runs while the ambient phase is still
            # step_compute: its exposed-collective carve moves this
            # step's handle-wait seconds out of this step's bucket.
            row = stats.end()
            if straggler is not None and row:
                straggler.observe_step(row["step_time_s"])
            if profiler is not None:
                profiler.on_step_end(step)
            if monitor is not None:
                # a device tensor buffered; converted at the monitor's
                # cadence, not per step
                monitor.observe_step(step, loss=loss)
            if on_step is not None:
                on_step(step, state, loss)
            if checkpointer is not None:
                with _goodput.phase_scope(_goodput.CHECKPOINT):
                    if not reserved:
                        # The snapshots' pinned buffers, made once the
                        # first step has made the optimizer's state
                        # (torch.optim does so lazily), so that no save
                        # pays for them.
                        checkpointer.reserve(state)
                        reserved = True
                    checkpointer.maybe_save(step, state)
        info["final_step"] = step
        if monitor is not None:
            monitor.drain()                 # flush the buffered tail
        if checkpointer is not None:
            with _goodput.phase_scope(_goodput.CHECKPOINT):
                checkpointer.wait()         # drain queued async writes
    finally:
        _goodput.set_phase(_goodput.IDLE)
        if profiler is not None:
            profiler.stop()     # idempotent: an exception mid-window must
            #                     not leave the profiler running
        if owned_handler:
            preemption.close()
        if owned_checkpointer:
            checkpointer.close()            # joins the writer thread
    return state, info


def _adopt_store_step(train_step, state, batches, info):
    """HOROVOD_ARTIFACT_STORE: key the step on the first batch's shapes
    and adopt it through the store (``store.artifact_store.adopt_step``):
    on a hit every kernel the stored step loaded is resolved now, from
    the store, so the first step runs no ``nvcc``; on a miss the first
    step records the kernels it loads and publishes them. Returns
    ``(step, batches)`` with the peeked batch chained back in front;
    ``info["store_step"]`` records hit | miss | disabled | error. Never
    raises: a store fault leaves the step as it was."""
    import itertools
    from horovod_tpu_torch.store import artifact_store as _store
    it = iter(batches)
    try:
        first = next(it)
    except StopIteration:
        return train_step, iter(())
    args = (state,) + (first if isinstance(first, tuple) else (first,))
    try:
        stepper, outcome = _store.adopt_step(train_step, args,
                                             label="train_step")
    except Exception as e:
        from horovod_tpu_torch.utils.logging import get_logger
        get_logger().warning(
            "HOROVOD_ARTIFACT_STORE: step adoption failed (%s: %s); the "
            "step runs as built", type(e).__name__, e)
        stepper, outcome = train_step, "error"
    info["store_step"] = outcome
    return stepper, itertools.chain([first], it)
