"""DistributedOptimizer, the bucketed gradient sync and the fused
optimizer-in-epilogue apply.

The counterpart of ``horovod_tpu/parallel/distributed.py`` (l.65-1188, the
flat schedule; the reference's ``torch/optimizer.py``).

**The bucketed sync.** The gradient leaves are cut into contiguous buckets
of at most ``HOROVOD_GRADIENT_BUCKET_BYTES`` in reverse order
(``ops/fusion._plan_buckets_by_bytes``: the backward produces the last
parameters' gradients first). Each bucket is packed into one buffer per
dtype and reduced with one SUM over the ranks. Where the JAX package lets
XLA's scheduler start a bucket's collective once its gradients exist, the
port launches it from the gradient hooks, as the reference's
``torch/optimizer.py`` does: ``Tensor.register_post_accumulate_grad_hook``
marks a parameter ready, and a bucket is launched once all its leaves are
ready and every earlier bucket of the plan has been launched, so every rank
issues its collectives in the same order (the JAX package's
``optimization_barrier`` chain). On the card a bucket's pack, encode and
collectives run on a side stream, so the backward's kernels go on while
the bucket's NCCL kernels run; ``step()`` waits on the buckets in plan
order. ``HOROVOD_GRADIENT_BUCKET_BYTES=0`` syncs one bucket after the
backward instead.

**The wire codec** (``compression.WireCodec``): with a tier active
(``HOROVOD_GRADIENT_COMPRESSION`` or ``compression=``) each packed bucket
is encoded to the wire dtype, summed over the ranks in that dtype
(``collectives.wire_sum_async``) and decoded with the averaging folded in.
The fp8 tiers carry an error-feedback residual: the quantization error of
step t is added to step t+1's gradient. The residual is per rank and has
each leaf's own shape (the JAX package's is ``[W, *shape]`` sharded over the
ranks; rank r's residual here is its ``residual[r]``). It is updated in
place.

**The fused apply** (:func:`distributed_apply`): the optimizer update of a
bucket runs in place, under ``torch.no_grad``, as soon as that bucket's
sync has completed, so no whole-model optimizer pass remains
(``EpilogueSGD``, ``EpilogueAdam``;
``trainer.make_transformer_train_step_fused``).

**The two-level DCN tier** (``_resolve_tier``): when a group's sync axes
cross the ``hvd_dcn`` axis of the topology with at least one other axis
left, the op is SUM/AVERAGE, and HOROVOD_DCN_SCHEDULE resolves
``two_level`` (``autotune.resolve_dcn_schedule``), each bucket runs the
three stages of ``collectives.two_level_allreduce``: reduce-scatter over
the fast axes, SUM of the owned shard over ``hvd_dcn`` (the only stage the
wire codec narrows, its amax shared over ``hvd_dcn`` alone, and the only
one the error-feedback residual compensates: the residual holds this
rank's DCN-stage error at its shard's offset, zeros elsewhere), all-gather
back, launched asynchronously like the flat SUM. ``last_wire_trace()``
gives the ``schedule`` and the ``dcn_wire_bytes`` that stage carried.

Sync axes name the topology's axes (``runtime/topology.py``); a name the
mesh does not have, such as a model's own data-parallel axis ``dp`` or
``hvd`` on a multi-axis mesh, stands for every axis, i.e. the world. An
empty axes tuple marks a local leaf, which is not synced.

**Adasum** (``op=Adasum``; ``ops/adasum.py``): as in the JAX package's
``_sync_leaf``, each leaf is its own bucket, launched from its gradient
hook, on an uncompressed wire (the per-leaf compressor still applies), and
combined over each sync axis in turn; the dot products span the leaf.
:class:`DistributedAdasumOptimizer` combines the inner optimizer's
parameter deltas instead of the gradients (the reference's
torch/optimizer.py:345), and :func:`distributed_value_and_grad` gives a
loss and its synced gradients. Not ported: the online tuner (A.13b).
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Sequence, Tuple)

import torch

from horovod_tpu_torch import compression as compr
from horovod_tpu_torch.autotune import resolve_bucket_bytes
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.fusion import (_plan_buckets_by_bytes,
                                          flatten_for_fusion,
                                          group_leaves_by_axes,
                                          unflatten_from_fusion)
from horovod_tpu_torch.ops.reduce_ops import ReduceOp, check_supported
from horovod_tpu_torch.runtime import context
from horovod_tpu_torch.utils import tree as tree_util

# The axes of a DistributedOptimizer's single group: the whole world.
_WORLD_AXES = ("hvd",)


def _mesh_axes(axes) -> Tuple[str, ...]:
    """The topology's axes that sync ``axes`` spans: names the mesh has
    stay, any other name stands for every axis; () stays local."""
    axes = tuple(a for a in axes if a)
    if not axes or not context.is_initialized():
        return axes
    topo = context.get_context().topology
    out: List[str] = []
    for a in axes:
        for n in ((a,) if a in topo.mesh.shape else topo.flat_axes):
            if n not in out:
                out.append(n)
    return tuple(out)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bucket_reverse_order(leaves: Sequence[torch.Tensor], bucket_bytes: int
                          ) -> List[List[int]]:
    """Contiguous buckets over the leaf list in REVERSE order, each at most
    ``bucket_bytes`` (``ops/fusion._plan_buckets_by_bytes``)."""
    return _plan_buckets_by_bytes([_nbytes(g) for g in leaves], bucket_bytes)


def _plan_sync_buckets(gs: Sequence[torch.Tensor], axes, world: int
                       ) -> List[List[int]]:
    """The bucket schedule of one group: the bucket knob resolved for
    this (payload, world), reverse-order chunks; 0 or one leaf gives a
    single bucket in leaf order."""
    bucket_bytes = resolve_bucket_bytes(
        [(tuple(g.shape), g.dtype) for g in gs], world)
    if bucket_bytes <= 0 or len(gs) <= 1:
        return [list(range(len(gs)))]
    return _bucket_reverse_order(gs, bucket_bytes)


def _axes_world(axes) -> int:
    """Ranks a group's SUM spans: the product of its axes' sizes, 1 for
    a local group."""
    axes = _mesh_axes(axes)
    if not axes or not context.is_initialized():
        return 1
    return context.get_context().topology.axis_size(axes)


def _spans_world(axes) -> bool:
    return _axes_world(axes) == (context.size() if context.is_initialized()
                                 else 1)


def _tier_split(axes) -> Tuple[Tuple[str, ...], Optional[str]]:
    """``(fast axes, dcn axis)`` of one sync-axes tuple: the DCN axis is
    peeled off when the tuple crosses it and another axis remains."""
    from horovod_tpu_torch.runtime.topology import DCN_AXIS
    axes = tuple(a for a in axes if a)
    if DCN_AXIS in axes and len(axes) > 1:
        return tuple(a for a in axes if a != DCN_AXIS), DCN_AXIS
    return axes, None


def _resolve_tier(gs: Sequence[torch.Tensor], axes, op: ReduceOp,
                  compression=None
                  ) -> Optional[Tuple[Tuple[str, ...], str]]:
    """``(fast axes, dcn axis)`` when this group's sync runs the two-level
    schedule, else None: SUM/AVERAGE, axes crossing ``hvd_dcn`` with
    another axis left, HOROVOD_DCN_SCHEDULE resolving ``two_level`` for
    the payload, and no duck-typed per-leaf compressor (which has no wire
    tier and stays on the flat per-leaf path)."""
    from horovod_tpu_torch.autotune import resolve_dcn_schedule
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        return None
    ici_axes, dcn_axis = _tier_split(_mesh_axes(axes))
    if dcn_axis is None or not ici_axes:
        return None
    if compr.wire_codec(compression) is None and \
            compr.as_compressor(compression) is not compr.NoneCompressor:
        return None
    payload = sum(_nbytes(g) for g in gs)
    if resolve_dcn_schedule(payload, _axes_world(ici_axes),
                            _axes_world((dcn_axis,))) != "two_level":
        return None
    return ici_axes, dcn_axis


# ---------------------------------------------------------------------------
# wire-bytes accounting: the last sync's trace, and the bytes of every sync
# since train_loop last charged them to the hvd_grad_* counters
# ---------------------------------------------------------------------------

_WIRE_TRACE = {"tier": "none", "logical_bytes": 0, "wire_bytes": 0,
               "n_buckets": 0, "error_feedback": False, "schedule": "flat",
               "dcn_wire_bytes": 0}
_UNCHARGED = {"logical_bytes": 0, "wire_bytes": 0}


def last_wire_trace() -> dict:
    """Byte accounting of the most recent gradient sync: wire tier,
    logical (uncompressed) against wire bytes, bucket count, whether the
    error-feedback residual was carried, the schedule (flat | two_level)
    and, under two_level, the bytes each rank's DCN stage carried (the
    payload convention of the JAX package: what each collective's result
    holds; the reduce-scatter and all-gather count the whole bucket)."""
    return dict(_WIRE_TRACE)


def _record_wire_trace(tier: str, logical: int, wire: int, n_buckets: int,
                       ef: bool, schedule: str = "flat",
                       dcn_wire: int = 0) -> None:
    _WIRE_TRACE.update(tier=tier, logical_bytes=int(logical),
                       wire_bytes=int(wire), n_buckets=int(n_buckets),
                       error_feedback=bool(ef), schedule=str(schedule),
                       dcn_wire_bytes=int(dcn_wire))
    _UNCHARGED["logical_bytes"] += int(logical)
    _UNCHARGED["wire_bytes"] += int(wire)


def record_step_wire_metrics() -> None:
    """Charge the gradient wire traffic of the syncs since the last call
    to the cumulative counters (called per step by ``train_loop``). Where
    the JAX package estimates a step's bytes from the last traced program,
    the port counts every sync that ran, so the charge is exact."""
    logical, wire = _UNCHARGED["logical_bytes"], _UNCHARGED["wire_bytes"]
    if not logical:
        return
    _UNCHARGED.update(logical_bytes=0, wire_bytes=0)
    from horovod_tpu_torch import metrics as M
    M.counter("hvd_grad_wire_bytes_total",
              "Gradient bytes actually moved by the sync collectives "
              "(post wire compression)").inc(wire)
    M.counter("hvd_grad_logical_bytes_total",
              "Gradient bytes the sync collectives would move "
              "uncompressed").inc(logical)


# ---------------------------------------------------------------------------
# one bucket: pack -> (compensate) -> encode -> SUM -> decode -> unpack
# ---------------------------------------------------------------------------

class _Part:
    """One dtype group of a launched bucket: what :meth:`finish` needs."""

    def __init__(self, slots, specs, dtype, work=None, buf=None,
                 scale=None, ctxs=None, compressed=False, done_n=None):
        self.slots, self.specs, self.dtype = slots, specs, dtype
        self.work, self.buf, self.scale = work, buf, scale
        self.ctxs, self.compressed = ctxs, compressed
        # two-level parts arrive decoded and averaged: keep done_n values
        self.done_n = done_n


class _PendingBucket:
    """A launched bucket. :meth:`finish` waits on its collectives and
    returns the synced leaves, in the bucket's leaf order. ``ready`` is the
    CUDA event recorded on the side stream after the launch (None on the
    CPU)."""

    def __init__(self, n, parts, codec, post, leaf_comp, logical, wire,
                 dcn_wire=0, tiered=False):
        self.n, self.parts, self.codec = n, parts, codec
        self.post, self.leaf_comp = post, leaf_comp
        self.logical_bytes, self.wire_bytes = logical, wire
        self.dcn_wire_bytes, self.tiered = dcn_wire, tiered
        self.ready: Optional[torch.cuda.Event] = None

    def finish(self) -> List[torch.Tensor]:
        out: List[Optional[torch.Tensor]] = [None] * self.n
        stream = None
        for part in self.parts:
            if part.work is not None:
                collectives.wait_work(part.work)
            if part.buf.is_cuda:
                # made on the side stream, read on this one: not reused
                # before this stream is done with them
                stream = stream or torch.cuda.current_stream(part.buf.device)
                for t in (part.buf, part.scale):
                    if t is not None:
                        t.record_stream(stream)
            if part.done_n is not None:
                full = part.buf[:part.done_n]
            elif part.compressed:
                full = self.codec.decode(part.buf, part.scale, part.dtype,
                                         postscale=self.post)
            else:
                full = part.buf
                if self.post is not None:
                    full.mul_(self.post)
            views = unflatten_from_fusion(full, part.specs)
            for j, (slot, v) in enumerate(zip(part.slots, views)):
                if part.ctxs is not None:
                    v = self.leaf_comp.decompress(v, part.ctxs[j])
                out[slot] = v
        return out


def _tier_part(buf: torch.Tensor, specs, idxs, res_leaves, tier, op,
               world: int, codec) -> Tuple[_Part, int, int]:
    """One dtype group of a two-level bucket: reduce-scatter over the fast
    axes, (compensate,) encode and SUM the owned shard over the DCN axis,
    decode with the averaging folded in, start the all-gather. Returns the
    part and its (wire, DCN-stage) bytes. The stages before the gather are
    ordered on the launching stream; each collective keeps its buffers
    alive until it has completed."""
    from horovod_tpu_torch.ops.collectives import (_all_gather,
                                                   _reduce_scatter)
    ctx = context.get_context()
    ici_axes, dcn_axis = tier
    gi, gd = ctx.axis_group(ici_axes), ctx.axis_group(dcn_axis)
    dtype, orig = buf.dtype, buf.numel()
    pad = (-orig) % gi.size
    chunk = (orig + pad) // gi.size
    compressed = codec is not None and codec.compresses(dtype)
    stage = (chunk * codec.wire_itemsize + (4 if codec.scaled else 0)
             if compressed else chunk * dtype.itemsize)
    if pad:
        buf = torch.cat([buf, buf.new_zeros(pad)])
    shard = _reduce_scatter(buf, ReduceOp.SUM, gi)
    off = gi.index * chunk
    if compressed:
        if res_leaves is not None:
            rbuf, _ = flatten_for_fusion([res_leaves[i].to(dtype)
                                          for i in idxs])
            if pad:
                rbuf = torch.cat([rbuf, rbuf.new_zeros(pad)])
            shard.add_(rbuf[off:off + chunk])
        wire, scale = codec.encode(shard, axes=(dcn_axis,), world=gd.size)
        work, red = collectives.wire_sum_async(wire, axis=dcn_axis)
        collectives.wait_work(work)
        post = (1.0 / world) if (op == ReduceOp.AVERAGE and world != 1) \
            else None
        out = codec.decode(red, scale, dtype, postscale=post)
        if res_leaves is not None:
            res_full = buf.new_zeros(orig + pad)
            res_full[off:off + chunk] = shard - codec.decode(wire, scale,
                                                             dtype)
            for i, r in zip(idxs, unflatten_from_fusion(res_full[:orig],
                                                        specs)):
                res_leaves[i].copy_(r)
    else:
        collectives.allreduce_async(shard, axis=dcn_axis).wait()
        out = shard.div_(world) if (op == ReduceOp.AVERAGE
                                    and world != 1) else shard
        if res_leaves is not None:
            for i in idxs:                    # lossless: nothing lost
                res_leaves[i].zero_()
    work, full = _all_gather(out, gi, async_op=True)
    return (_Part(idxs, specs, dtype, work, full, done_n=orig),
            2 * orig * dtype.itemsize + stage, stage)


def _wire_bucket_launch(leaves: List[torch.Tensor],
                        res_leaves: Optional[List[torch.Tensor]], axes,
                        op: ReduceOp, world: int, codec, leaf_comp,
                        prescale: Optional[float] = None,
                        batch: bool = True, tier=None) -> _PendingBucket:
    """Start one bucket's sync (the JAX ``_wire_bucket_reduce``). Per
    dtype: pack into a fresh buffer (times ``prescale``), add the residual,
    encode, start the wire SUM; the new residual, compensated minus the
    decode of this rank's own wire with the same scale, is written into
    ``res_leaves`` in place. Dtypes the codec does not narrow, and every
    dtype without a codec, reduce uncompressed; without a codec each leaf
    first goes through the per-leaf ``leaf_comp`` and ``batch=False``
    (HOROVOD_BATCH_D2D_MEMCOPIES=0) reduces leaf by leaf. ``tier=(fast
    axes, dcn axis)`` runs every dtype group through the two-level
    schedule (:func:`_tier_part`) instead."""
    ef = res_leaves is not None
    axes = _mesh_axes(axes)
    sync = bool(axes)
    post = (1.0 / world) if (op == ReduceOp.AVERAGE and world != 1) else None
    parts: List[_Part] = []
    wire_bytes = dcn_bytes = 0
    logical = sum(_nbytes(g) for g in leaves)

    ctxs = None
    if codec is None:
        packed = []
        ctxs = []
        for g in leaves:
            c, ctx = leaf_comp.compress(g)
            packed.append(c)
            ctxs.append(ctx)
    else:
        packed = list(leaves)
    if codec is None and not batch:
        groups = [[i] for i in range(len(packed))]
    else:
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, x in enumerate(packed):
            by_dtype.setdefault(x.dtype, []).append(i)
        groups = list(by_dtype.values())

    for idxs in groups:
        parts_in = [packed[i] for i in idxs]
        buf, specs = flatten_for_fusion(parts_in)
        buf = torch.cat([buf]) if len(parts_in) == 1 else buf   # own copy
        if prescale is not None:
            buf.mul_(prescale)
        dtype = buf.dtype
        part_ctxs = [ctxs[i] for i in idxs] if ctxs is not None else None
        if tier is not None:
            part, wb, db = _tier_part(buf, specs, idxs, res_leaves, tier,
                                      op, world, codec)
            part.ctxs = part_ctxs
            parts.append(part)
            wire_bytes += wb
            dcn_bytes += db
            continue
        if codec is not None and codec.compresses(dtype):
            if ef:
                rbuf, _ = flatten_for_fusion(
                    [res_leaves[i].to(dtype) for i in idxs])
                buf.add_(rbuf)
            wire, scale = codec.encode(buf, axes=axes, world=world)
            work, red = collectives.wire_sum_async(wire, axis=axes)
            if ef:
                res_buf = buf - codec.decode(wire, scale, dtype)
                for i, r in zip(idxs, unflatten_from_fusion(res_buf, specs)):
                    res_leaves[i].copy_(r)
            wire_bytes += wire.numel() * codec.wire_itemsize \
                + (4 if codec.scaled else 0)
            parts.append(_Part(idxs, specs, dtype, work, red, scale,
                               part_ctxs, compressed=True))
            continue
        work = None
        if sync:        # the world's group is the default one
            work = (collectives.allreduce_async(buf) if _spans_world(axes)
                    else collectives.allreduce_async(buf, axis=axes))
        if ef:
            for i in idxs:                   # lossless: nothing lost
                res_leaves[i].zero_()
        wire_bytes += _nbytes(buf)
        parts.append(_Part(idxs, specs, dtype, work, buf, None, part_ctxs))
    return _PendingBucket(len(leaves), parts, codec,
                          post if sync else None, leaf_comp, logical,
                          wire_bytes, dcn_bytes, tier is not None)


def _sync_leaves(gs: Sequence[torch.Tensor], axes, op: ReduceOp,
                 compression) -> List[torch.Tensor]:
    """The JAX package's ``_sync_leaf`` over every leaf of ``gs``: through
    the per-leaf compressor, reduced with ``op`` over each of ``axes`` in
    turn, and back. Adasum sends the leaves of one dtype in one transfer
    per butterfly level; its dot products stay per leaf."""
    from horovod_tpu_torch.ops.adasum import adasum_allreduce_many
    comp = compr.as_compressor(compression)
    packed, ctxs = [], []
    for g in gs:
        c, ctx = comp.compress(g)
        packed.append(c)
        ctxs.append(ctx)
    for ax in _mesh_axes(axes):
        if op == ReduceOp.ADASUM:
            packed = adasum_allreduce_many(packed, ax)
        else:
            packed = [collectives.allreduce(c, op, axis=ax) for c in packed]
    return [comp.decompress(c, ctx) for c, ctx in zip(packed, ctxs)]


def _adasum_bucket_launch(leaves: List[torch.Tensor], axes, leaf_comp,
                          prescale: Optional[float] = None
                          ) -> _PendingBucket:
    """One bucket of an Adasum sync (:func:`_sync_leaves`), complete when
    it returns (each butterfly level needs the last); the wire trace
    counts its bytes uncompressed."""
    if prescale is not None:
        leaves = [g * prescale for g in leaves]
    synced = _sync_leaves(leaves, axes, ReduceOp.ADASUM, leaf_comp)
    parts = []
    for i, s in enumerate(synced):
        buf, specs = flatten_for_fusion([s])
        parts.append(_Part([i], specs, s.dtype, buf=buf))
    logical = sum(_nbytes(g) for g in leaves)
    return _PendingBucket(len(leaves), parts, None, None,
                          compr.NoneCompressor, logical, logical)


# ---------------------------------------------------------------------------
# the plan and its launches
# ---------------------------------------------------------------------------

class _GradSync:
    """The static wiring of one gradient sync: op, codec, error feedback
    and the bucket plan over a leaf list grouped by sync axes (groups in
    order of their first leaf; a local group is one bucket)."""

    def __init__(self, leaves: Sequence[torch.Tensor],
                 groups: Dict[Tuple, List[int]], op: ReduceOp,
                 compression, error_feedback: Optional[bool]):
        op = check_supported(op)
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
            raise NotImplementedError(
                f"gradient sync with op={op.name} is not supported (Sum, "
                f"Average and Adasum are)")
        compr.tier_for(compression)            # reject typos here
        self.op = op
        # Adasum's wire stays uncompressed (its dot products need the
        # values); the per-leaf compressor still applies
        self.codec = (None if op == ReduceOp.ADASUM
                      else compr.wire_codec(compression))
        self.leaf_comp = compr.as_compressor(compression)
        self.ef = self.codec is not None and (
            compr.error_feedback_enabled(self.codec)
            if error_feedback is None else bool(error_feedback))
        self.batch = bool(knobs.get("HOROVOD_BATCH_D2D_MEMCOPIES"))
        self.buckets: List[Tuple[Tuple, List[int]]] = []
        # sync axes -> (fast axes, dcn axis) of the two-level schedule
        self.tiers: Dict[Tuple, Optional[Tuple[Tuple[str, ...], str]]] = {}
        for axes, idxs in groups.items():
            gs = [leaves[i] for i in idxs]
            self.tiers[axes] = (_resolve_tier(gs, axes, op, compression)
                                if axes else None)
            if not axes:
                plan = [list(range(len(idxs)))]
            elif op == ReduceOp.ADASUM:       # a leaf a bucket, reversed
                plan = [[j] for j in reversed(range(len(idxs)))]
            else:
                plan = _plan_sync_buckets(gs, axes, _axes_world(axes))
            self.buckets += [(axes, [idxs[j] for j in b]) for b in plan]
        self.n_leaves = len(leaves)

    @property
    def schedule(self) -> str:
        return ("two_level" if any(t is not None for t in self.tiers.values())
                else "flat")

    def launch(self, k: int, grads: List[torch.Tensor],
               residuals: Optional[List[torch.Tensor]],
               prescale: Optional[float] = None) -> _PendingBucket:
        axes, _ = self.buckets[k]
        if self.op == ReduceOp.ADASUM:
            return _adasum_bucket_launch(grads, axes, self.leaf_comp,
                                         prescale)
        return _wire_bucket_launch(
            grads, residuals if self.ef else None, axes, self.op,
            _axes_world(axes), self.codec if axes else None,
            self.leaf_comp, prescale, self.batch, self.tiers[axes])


def _on_grad_ready(launcher_ref, i: int, _param) -> None:
    launcher = launcher_ref()
    if launcher is not None:
        launcher.grad_ready(i)


class _BucketLauncher:
    """Launches the buckets of a :class:`_GradSync` over ``leaves``.

    With ``hooks=True`` a post-accumulate-grad hook on every leaf counts
    its backward passes, and a pass beyond ``passes`` before the sync
    raises (as the reference's ``torch/optimizer.py`` does). Once a leaf
    has seen ``passes`` of them it is ready, and, with ``early=True``,
    every bucket whose leaves are all ready is launched, in plan order.
    :meth:`finish` launches what is left, then waits bucket by bucket in
    plan order. The gradients are the leaves' ``.grad`` (zeros where a leaf
    got none), or the list given to :meth:`bind`. On the card the launches
    run on a side stream that first waits for the current one, and the
    current one waits for a bucket's launch before it reads the bucket."""

    def __init__(self, sync: _GradSync, leaves: Sequence[torch.Tensor],
                 passes: int = 1, hooks: bool = False, early: bool = True):
        self.sync, self.leaves, self.passes = sync, list(leaves), passes
        self.early = early
        self.residuals: Optional[List[torch.Tensor]] = None
        self._grads: Optional[List[torch.Tensor]] = None
        self._bucket_of = {i: k for k, (_, idxs) in enumerate(sync.buckets)
                           for i in idxs}
        dev = self.leaves[0].device if self.leaves else torch.device("cpu")
        self._stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                        else None)
        self._hooks = []
        if hooks:
            ref = weakref.ref(self)
            self._hooks = [p.register_post_accumulate_grad_hook(
                functools.partial(_on_grad_ready, ref, i))
                for i, p in enumerate(self.leaves)]
        # launch order of the last step: (bucket, launched from a hook)
        self.launch_log: List[Tuple[int, bool]] = []
        # hooks run on the autograd engine's threads (one per device)
        self._lock = threading.Lock()
        self._reset()

    def _reset(self) -> None:
        self._fired = [0] * len(self.leaves)
        self._missing = [len(idxs) for _, idxs in self.sync.buckets]
        self._pending: List[Optional[_PendingBucket]] = \
            [None] * len(self.sync.buckets)
        self._next = 0

    def remove_hooks(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def bind(self, grads: Optional[List[torch.Tensor]] = None,
             residuals: Optional[List[torch.Tensor]] = None) -> None:
        """Take the gradients from ``grads`` (else the leaves' ``.grad``)
        and read and update the residuals ``residuals`` in place."""
        self._grads, self.residuals = grads, residuals

    def grad_ready(self, i: int) -> None:
        with self._lock:
            self._fired[i] += 1
            if self._fired[i] > self.passes:
                raise RuntimeError(
                    f"Gradients were computed more than "
                    f"backward_passes_per_step ({self.passes}) times before "
                    f"the gradient sync (step()). Increase "
                    f"backward_passes_per_step to accumulate gradients "
                    f"locally.")
            if self._fired[i] < self.passes or not self.early:
                return
            k = self._bucket_of[i]
            self._missing[k] -= 1
            while (self._next < len(self._pending)
                   and self._missing[self._next] == 0):
                self._launch(self._next, from_hook=True)

    def _grad(self, i: int) -> torch.Tensor:
        if self._grads is not None:
            return self._grads[i]
        g = self.leaves[i].grad
        return torch.zeros_like(self.leaves[i]) if g is None else g.detach()

    def _launch(self, k: int, from_hook: bool = False) -> None:
        if self.sync.ef and self.residuals is None:
            raise ValueError("error feedback is active: bind() the "
                             "residuals before the backward")
        if k == 0:
            self.launch_log = []
        _, idxs = self.sync.buckets[k]
        grads = [self._grad(i) for i in idxs]
        res = ([self.residuals[i] for i in idxs]
               if self.residuals is not None else None)
        prescale = 1.0 / self.passes if self.passes != 1 else None
        if self._stream is None:
            pending = self.sync.launch(k, grads, res, prescale)
        else:
            dev = self.leaves[0].device
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                pending = self.sync.launch(k, grads, res, prescale)
            pending.ready = self._stream.record_event()
        self._pending[k] = pending
        self._next = k + 1
        self.launch_log.append((k, from_hook))

    def finish(self) -> Iterator[Tuple[List[int], List[torch.Tensor]]]:
        """Launch the buckets not launched yet, then yield ``(leaf
        indices, synced gradients)`` bucket by bucket in plan order, each
        once its collectives have completed. Records the wire trace."""
        while self._next < len(self._pending):
            self._launch(self._next)
        pending = self._pending
        try:
            for (_, idxs), p in zip(self.sync.buckets, pending):
                if p.ready is not None:
                    # the pack (and a local group's whole bucket, which
                    # has no collective to wait on) ran on the side stream
                    torch.cuda.current_stream(
                        self.leaves[0].device).wait_event(p.ready)
                yield idxs, p.finish()
        finally:
            if self._stream is not None:
                torch.cuda.current_stream(self.leaves[0].device).wait_stream(
                    self._stream)
            codec = self.sync.codec
            _record_wire_trace(codec.tier if codec is not None else "none",
                               sum(p.logical_bytes for p in pending),
                               sum(p.wire_bytes for p in pending),
                               len(pending), self.sync.ef,
                               self.sync.schedule,
                               sum(p.dcn_wire_bytes for p in pending))
            self._reset()


def _sync_leaves_fused(gs: List[torch.Tensor], groups: Dict[Tuple, List[int]],
                       op: ReduceOp, compression,
                       residuals: Optional[List[torch.Tensor]] = None,
                       error_feedback: Optional[bool] = None
                       ) -> List[torch.Tensor]:
    """Sync the leaves ``gs`` (grouped by sync axes) after the backward as
    the bucketed fused collectives of the plan; returns the synced leaves.
    With error feedback active, ``residuals`` (one per leaf) are read and
    updated in place."""
    sync = _GradSync(gs, groups, op, compression, error_feedback)
    if sync.ef and residuals is None:
        raise ValueError("error feedback is active: pass the WireState "
                         "from init()")
    launcher = _BucketLauncher(sync, gs)
    launcher.bind(list(gs), residuals if sync.ef else None)
    out: List[Optional[torch.Tensor]] = [None] * len(gs)
    for idxs, synced in launcher.finish():
        for i, s in zip(idxs, synced):
            out[i] = s
    return out


# ---------------------------------------------------------------------------
# error-feedback residual state
# ---------------------------------------------------------------------------

class WireState(NamedTuple):
    """State of :func:`allreduce_gradients` when a lossy wire tier carries
    error feedback: ``residual`` mirrors the gradient tree, each leaf this
    rank's residual with the leaf's own shape, updated in place."""
    residual: Any
    # checkpoints write it per rank (resilience/async_checkpoint.py)
    _per_rank_fields = ("residual",)


def _residual_zeros(leaf: torch.Tensor) -> torch.Tensor:
    dtype = leaf.dtype if leaf.is_floating_point() else torch.float32
    return torch.zeros(leaf.shape, dtype=dtype, device=leaf.device)


class GradientTransformation(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state) -> (synced,
    state)``: the optax shape of the JAX package's transform."""
    init: Callable
    update: Callable


def _groups(tree, axis, sync_axes):
    """(treedef, leaves, {axes: [leaf indices]}) of a gradient tree (a
    nested dict, or a list or tuple of tensors)."""
    if isinstance(tree, (list, tuple)):
        tree = {f"{i:06d}": t for i, t in enumerate(tree)}
    if sync_axes is not None:
        return group_leaves_by_axes(tree, sync_axes)
    leaves, treedef = tree_util.tree_flatten(tree)
    axes_t = axis if isinstance(axis, tuple) else (axis,)
    return treedef, leaves, {tuple(a for a in axes_t if a):
                             list(range(len(leaves)))}


def _leaf_paths(tree) -> List[tuple]:
    if isinstance(tree, (list, tuple)):
        return [(i,) for i in range(len(tree))]
    flat = tree_util.flatten_dict(tree)
    return sorted(flat)          # sorted keys: the tree_flatten order


def _rebuild(tree, treedef, leaves):
    if isinstance(tree, (list, tuple)):
        return type(tree)(leaves)
    return tree_util.tree_unflatten(treedef, leaves)


def allreduce_gradients(
    op: ReduceOp = ReduceOp.AVERAGE,
    axis: Any = "hvd",
    compression=Compression.none,
    sync_axes: Any = None,
    local_param_filter: Optional[Callable[[tuple], bool]] = None,
    error_feedback: Optional[bool] = None,
) -> GradientTransformation:
    """The gradient-sync transform (the allreduce step of
    DistributedOptimizer) over a gradient tree: a nested dict of tensors,
    or a list of them.

    ``sync_axes`` (a tree of axis-name tuples mirroring the gradients; a
    tuple may cover a subtree) overrides ``axis``: leaves with the same
    axes sync together, an empty tuple leaves a gradient local.
    ``local_param_filter(path) -> True`` keeps that leaf's own gradient
    (``path`` is the tuple of dict keys, or ``(index,)`` for a list).
    ``error_feedback`` overrides HOROVOD_GRADIENT_ERROR_FEEDBACK: when it
    is active, ``init`` returns a :class:`WireState` of zeros, and
    ``update`` reads it and updates it in place; otherwise the state is
    ``()``. The buckets are planned and launched on each ``update``,
    after the backward."""
    op = check_supported(op)
    compr.tier_for(compression)

    def init_fn(params):
        codec = compr.wire_codec(compression)
        ef = codec is not None and (
            compr.error_feedback_enabled(codec)
            if error_feedback is None else bool(error_feedback))
        if not ef or params is None:
            return ()
        return WireState(tree_util.tree_map(
            _residual_zeros, params) if not isinstance(params, (list, tuple))
            else [_residual_zeros(p) for p in params])

    def update_fn(grads, state=()):
        treedef, leaves, groups = _groups(grads, axis, sync_axes)
        res = None
        if isinstance(state, WireState):
            res = (list(state.residual)
                   if isinstance(state.residual, (list, tuple))
                   else tree_util.tree_leaves(state.residual))
        out = _sync_leaves_fused(leaves, groups, op, compression,
                                 residuals=res,
                                 error_feedback=error_feedback)
        if local_param_filter is not None:
            for i, path in enumerate(_leaf_paths(grads)):
                if local_param_filter(path):
                    out[i] = leaves[i]
        return _rebuild(grads, treedef, out), state

    return GradientTransformation(init_fn, update_fn)


class DistributedOptimizer:
    """``optimizer`` with its gradients synced over the ranks:
    Horovod's ``hvd.DistributedOptimizer``.

    The bucket plan runs over the parameters in ``param_groups`` order,
    reversed (Horovod's and DDP's order). With
    HOROVOD_GRADIENT_BUCKET_BYTES > 0 (default 25 MiB) each bucket is
    launched from the gradient hooks during the backward; ``step()`` (or
    ``synchronize()``) launches the rest, waits on the buckets in plan
    order, sets each parameter's ``.grad`` to its synced gradient and runs
    the inner optimizer's step. ``compression`` (or
    HOROVOD_GRADIENT_COMPRESSION) selects the wire tier; ``error_feedback``
    overrides HOROVOD_GRADIENT_ERROR_FEEDBACK (its residual is
    ``wire_state``).

    ``backward_passes_per_step=N``: call ``backward()`` N times, then
    ``step()`` once. torch sums the N gradients into ``.grad``; the sync
    divides by N, so the update sees their mean, as ``optax.MultiSteps``
    averages them, and syncs once. A backward pass beyond N before
    ``step()`` raises ``RuntimeError``.

    The runtime must be initialized (``horovod_tpu_torch.init``) before
    the first backward; the tier and the bucket knob are read here."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 error_feedback: Optional[bool] = None):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.op = check_supported(op)
        self.params = [p for group in optimizer.param_groups
                       for p in group["params"]]
        self._sync = _GradSync(self.params, {_mesh_axes(_WORLD_AXES): list(
            range(len(self.params)))}, self.op, compression, error_feedback)
        self.wire_state = (WireState([_residual_zeros(p)
                                      for p in self.params])
                           if self._sync.ef else ())
        early = resolve_bucket_bytes(
            [(tuple(p.shape), p.dtype) for p in self.params],
            _axes_world(_WORLD_AXES)) > 0
        self._launcher = _BucketLauncher(self._sync, self.params,
                                         passes=backward_passes_per_step,
                                         hooks=True, early=early)
        self._launcher.bind(None, self.wire_state.residual
                            if self._sync.ef else None)

    @property
    def buckets(self) -> List[List[int]]:
        """The bucket plan: parameter indices (``param_groups`` order) of
        each bucket, in launch order."""
        return [idxs for _, idxs in self._sync.buckets]

    @property
    def launch_log(self) -> List[Tuple[int, bool]]:
        """(bucket, launched from a gradient hook) of the last sync, in
        launch order."""
        return list(self._launcher.launch_log)

    def synchronize(self) -> None:
        """Replace every parameter's ``.grad`` by its sync over the
        ranks."""
        for idxs, synced in self._launcher.finish():
            for i, g in zip(idxs, synced):
                self.params[i].grad = g

    def step(self, closure=None):
        self.synchronize()
        return self.optimizer.step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)


class DistributedAdasumOptimizer:
    """Adasum's delta optimizer (ref torch/optimizer.py:345, its rationale
    at :414-427; the JAX package's ``DistributedAdasumOptimizer``): each
    rank's inner ``optimizer`` steps on its LOCAL gradients, and the
    parameter deltas, not the gradients, are Adasum-combined over
    ``axis`` (a name or a tuple, each axis in turn), which keeps adaptive
    state (momentum, Adam's moments) at the local gradient's scale.

    ``step()`` snapshots the parameters, runs the inner step, forms each
    delta as new - old in f32, combines the deltas (per leaf; the leaves
    of one dtype cross in one transfer per butterfly level) and writes old
    + combined back into the same parameter tensors, so whatever holds them
    by reference (hooks, a checkpointer) keeps seeing them. Every rank
    then holds the same parameters, bit for bit; over one rank the inner
    step stands as it is. No gradient hooks are installed."""

    def __init__(self, optimizer: torch.optim.Optimizer, axis,
                 compression=Compression.none):
        if axis is None:
            raise ValueError(
                "DistributedAdasumOptimizer needs an explicit mesh axis: "
                "the delta combination is an Adasum collective over it")
        compr.tier_for(compression)
        self.optimizer = optimizer
        self.axes = axis if isinstance(axis, tuple) else (axis,)
        self.compression = compression
        self.params = [p for group in optimizer.param_groups
                       for p in group["params"]]

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def step(self, closure=None):
        if _axes_world(self.axes) == 1:     # the butterfly has no level
            return self.optimizer.step(closure)
        with torch.no_grad():
            start = [p.detach().clone() for p in self.params]
        loss = self.optimizer.step(closure)
        with torch.no_grad():
            deltas = [p.detach().float() - s.float()
                      for p, s in zip(self.params, start)]
            combined = _sync_leaves(deltas, self.axes, ReduceOp.ADASUM,
                                    self.compression)
            for p, s, c in zip(self.params, start, combined):
                p.copy_((s.float() + c).to(p.dtype))
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.optimizer.load_state_dict(state_dict)


def distributed_value_and_grad(loss_fn: Callable[..., Any],
                               op: ReduceOp = ReduceOp.AVERAGE,
                               axis: Any = None,
                               compression=Compression.none,
                               sync_axes: Any = None,
                               has_aux: bool = False) -> Callable:
    """``loss_fn(params, *args)`` and its gradients with respect to
    ``params`` (a tensor, a list or a nested dict of tensors, or an
    ``nn.Module``, whose gradients come as a dict by parameter name),
    synced over ``axis`` or per leaf over ``sync_axes``: the
    ``DistributedGradientTape`` analogue (ref tensorflow/__init__.py:1051).
    With ``axis`` the loss is averaged over it too (detached); with only
    ``sync_axes`` it stays this rank's. Returns ``wrapped(params, *args,
    **kwargs) -> (value, grads)``, ``value`` a ``(loss, aux)`` pair under
    ``has_aux``."""
    op = check_supported(op)

    def wrapped(params, *args, **kwargs):
        out = loss_fn(params, *args, **kwargs)
        loss, aux = (out[0], out[1]) if has_aux else (out, None)
        tree = (dict(params.named_parameters())
                if isinstance(params, torch.nn.Module)
                else [params] if torch.is_tensor(params) else params)
        treedef, leaves, groups = _groups(tree, axis or (),
                                          sync_axes)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if axis is not None or sync_axes is not None:
            for axes, idxs in groups.items():
                if axes:
                    for i, g in zip(idxs, _sync_leaves(
                            [grads[i] for i in idxs], axes, op,
                            compression)):
                        grads[i] = g
        if axis is not None:
            loss = collectives.allreduce(loss.detach(), ReduceOp.AVERAGE,
                                         axis=axis)
        out_grads = _rebuild(tree, treedef, grads)
        if torch.is_tensor(params):
            out_grads = out_grads[0]
        return ((loss, aux) if has_aux else loss), out_grads

    return wrapped


# ---------------------------------------------------------------------------
# optimizer-in-epilogue bucketed apply
# ---------------------------------------------------------------------------

class EpilogueOptState(NamedTuple):
    """State of an :class:`EpilogueOptimizer`: ``scalars`` are whole-model
    scalars (Adam's step count), ``slots`` a tuple of trees mirroring the
    params (momentum, second moment), updated in place."""
    scalars: Tuple[Any, ...]
    slots: Tuple[Any, ...]


class DistributedApplyState(NamedTuple):
    """State of :func:`distributed_apply`: the epilogue optimizer's state
    and the error-feedback residual tree (``()`` when none is carried)."""
    opt: EpilogueOptState
    residual: Any
    # checkpoints write it per rank (resilience/async_checkpoint.py)
    _per_rank_fields = ("residual",)


class EpilogueOptimizer:
    """A leaf-local optimizer whose update runs in a bucket's epilogue:
    ``apply_leaf`` updates one parameter leaf and its state slots IN PLACE
    from its synced gradient. Per-step scalar work (step counts, bias
    corrections) happens once in ``begin_step``."""

    n_slots = 0

    def init_scalars(self) -> Tuple[Any, ...]:
        return ()

    def init_slot(self, slot: int, param: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(param, requires_grad=False)

    def begin_step(self, scalars: Tuple[Any, ...]):
        """-> (new_scalars, ctx); ctx is handed to every apply_leaf."""
        return scalars, None

    def apply_leaf(self, ctx, param: torch.Tensor, grad: torch.Tensor,
                   slots: Tuple[torch.Tensor, ...]) -> None:
        raise NotImplementedError


class EpilogueSGD(EpilogueOptimizer):
    """SGD with optional (Nesterov) momentum: the optax ``sgd(lr,
    momentum, nesterov)`` math, leaf-local."""

    def __init__(self, lr: float, momentum: float = 0.0,
                 nesterov: bool = False):
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.n_slots = 1 if self.momentum else 0

    def apply_leaf(self, ctx, param, grad, slots):
        g = grad.to(param.dtype)
        if not self.momentum:
            param.sub_(g * self.lr)
            return
        m = slots[0].mul_(self.momentum).add_(g)
        d = g + m * self.momentum if self.nesterov else m
        param.sub_(d * self.lr)


class EpilogueAdam(EpilogueOptimizer):
    """Adam: the optax ``adam(lr, b1, b2, eps)`` math, leaf-local, with a
    shared step count (bias corrections once per step in
    ``begin_step``)."""

    n_slots = 2

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = (float(lr), float(b1),
                                               float(b2), float(eps))

    def init_scalars(self):
        return (torch.zeros((), dtype=torch.int32),)

    def begin_step(self, scalars):
        # the bias corrections in f32, as the JAX package computes them,
        # handed to the leaves as (exact) Python floats: no device copy
        count = scalars[0] + 1
        c = count.to(torch.float32)
        f32 = dict(dtype=torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, **f32), c)
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, **f32), c)
        return (count,), (float(bc1), float(bc2))

    def apply_leaf(self, ctx, param, grad, slots):
        bc1, bc2 = ctx
        g = grad.to(param.dtype)
        mu = slots[0].mul_(self.b1).add_(g * (1.0 - self.b1))
        nu = slots[1].mul_(self.b2).add_((g * g) * (1.0 - self.b2))
        mu_hat = mu / bc1
        nu_hat = nu / bc2
        param.sub_(mu_hat * self.lr / (torch.sqrt(nu_hat) + self.eps))


class DistributedApply:
    """Fused sync + optimizer-in-epilogue apply (build with
    :func:`distributed_apply`). Per reverse-backward bucket it packs,
    wire-encodes, reduces and decodes, and applies the optimizer update to
    the bucket's leaves as soon as that bucket's sync has completed, in
    place: no whole-model optimizer pass remains.

    ``apply(params, grads, state)`` takes the gradients as a tree.
    ``attach(params)`` instead installs the gradient hooks on the param
    leaves, so the buckets launch during ``loss.backward()``, and
    ``apply_attached(launcher, params, state)`` finishes them
    (``trainer.make_transformer_train_step_fused``)."""

    def __init__(self, optimizer: EpilogueOptimizer, *,
                 op: ReduceOp = ReduceOp.AVERAGE, axis: Any = None,
                 sync_axes: Any = None, compression=Compression.none,
                 error_feedback: Optional[bool] = None):
        if axis is None and sync_axes is None:
            raise ValueError(
                "DistributedApply needs an explicit mesh axis (axis= or "
                "sync_axes=): the buckets sync over the named axes")
        compr.tier_for(compression)     # reject typos at construction
        self.optimizer = optimizer
        self.op = check_supported(op)
        self.axis, self.sync_axes = axis, sync_axes
        self.compression = compression
        self._ef_override = error_feedback

    def error_feedback_active(self) -> bool:
        codec = compr.wire_codec(self.compression)
        if codec is None or self.op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            return False
        return (compr.error_feedback_enabled(codec)
                if self._ef_override is None else bool(self._ef_override))

    def _sync(self, tree) -> Tuple[Any, List[torch.Tensor], _GradSync]:
        treedef, leaves, groups = _groups(tree, self.axis, self.sync_axes)
        return treedef, leaves, _GradSync(leaves, groups, self.op,
                                          self.compression,
                                          self._ef_override)

    def init(self, params) -> DistributedApplyState:
        opt = self.optimizer
        slots = tuple(tree_util.tree_map(
            lambda p, s=s: opt.init_slot(s, p.detach()), params)
            for s in range(opt.n_slots))
        residual: Any = ()
        if self.error_feedback_active():
            residual = tree_util.tree_map(lambda p: _residual_zeros(
                p.detach()), params)
        return DistributedApplyState(
            EpilogueOptState(opt.init_scalars(), slots), residual)

    def attach(self, params) -> _BucketLauncher:
        """Install the gradient hooks on ``params``' leaves (sorted-key
        order, the JAX package's leaf order); returns the launcher to pass
        to :meth:`apply_attached`."""
        _, leaves, sync = self._sync(params)
        return _BucketLauncher(sync, leaves, hooks=True)

    def apply(self, params, grads, state: DistributedApplyState
              ) -> Tuple[Any, DistributedApplyState]:
        """Sync ``grads`` bucket by bucket and update ``params`` and the
        state in place; returns ``(params, new_state)``."""
        _, g_leaves, sync = self._sync(grads)
        launcher = _BucketLauncher(sync, tree_util.tree_leaves(params))
        launcher.bind(list(g_leaves), tree_util.tree_leaves(state.residual)
                      if sync.ef else None)
        return self.apply_attached(launcher, params, state)

    def apply_attached(self, launcher: _BucketLauncher, params,
                       state: DistributedApplyState
                       ) -> Tuple[Any, DistributedApplyState]:
        """Finish ``launcher``'s buckets (the hooks launched some during
        the backward) and apply the update of each bucket as soon as it is
        synced; returns ``(params, new_state)``. With error feedback the
        caller binds ``state.residual``'s leaves before the backward
        (``launcher.bind(None, residual_leaves)``)."""
        opt = self.optimizer
        p_leaves = tree_util.tree_leaves(params)
        if len(p_leaves) != launcher.sync.n_leaves:
            raise ValueError(
                f"params tree has {len(p_leaves)} leaves but the gradient "
                f"tree has {launcher.sync.n_leaves}")
        slot_leaves = [tree_util.tree_leaves(s) for s in state.opt.slots]
        scalars, ctx = opt.begin_step(state.opt.scalars)
        with torch.no_grad():
            for idxs, synced in launcher.finish():
                for i, g in zip(idxs, synced):
                    opt.apply_leaf(ctx, p_leaves[i], g, tuple(
                        slot_leaves[s][i] for s in range(opt.n_slots)))
        return params, DistributedApplyState(
            EpilogueOptState(scalars, state.opt.slots), state.residual)


def distributed_apply(optimizer: EpilogueOptimizer, *,
                      op: ReduceOp = ReduceOp.AVERAGE, axis: Any = None,
                      sync_axes: Any = None, compression=Compression.none,
                      error_feedback: Optional[bool] = None
                      ) -> DistributedApply:
    """The fused sync + optimizer-in-epilogue counterpart of
    :class:`DistributedOptimizer`; see :class:`DistributedApply`."""
    return DistributedApply(optimizer, op=op, axis=axis,
                            sync_axes=sync_axes, compression=compression,
                            error_feedback=error_feedback)
