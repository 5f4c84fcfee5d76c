"""Eager fusion-cycle coordinator: the control plane of the ``*_async``
collectives.

The counterpart of ``horovod_tpu/ops/coordinator.py``. Reference parity:
the background communication thread (``BackgroundThreadLoop``/
``RunLoopOnce``, operations.cc:405,747), the tensor queue
(tensor_queue.{h,cc}), greedy response fusion (``FuseResponses``
controller.cc:887), the response cache (response_cache.h:45) and the
fusion buffer manager (fusion_buffer_manager.h:31-47).

Every ``*_async`` call of ``eager.py`` enqueues a named tensor and returns
a pending :class:`~horovod_tpu_torch.eager.Handle`. A cycle drains the
queue, splits it into compatible classes, packs each class greedily into
bins under ``HOROVOD_FUSION_THRESHOLD`` bytes (``ops.fusion.
plan_fusion_bins``) and dispatches ONE collective per bin and dtype on a
persistent fusion buffer, then copies each result out of it and resolves
the handles.

**Modes.** In a world of one rank the ``hvd-cycle`` thread drains the queue
``HOROVOD_CYCLE_TIME`` ms after the first enqueue (thread mode). In a
world of several ranks dispatch is deterministic, since a wall-clock drain
would put a burst into different bins on different ranks and NCCL would
hang: enqueues accumulate, and the queue drains only at points every
rank's program reaches in the same order -- its bytes reaching the
threshold (floored at 4 KiB), a ``synchronize``/``poll`` of a pending
handle, ``shutdown``. Before each such flush a
:class:`~horovod_tpu_torch.ops.divergence.DivergenceChecker` compares the
ranks' digests of what they enqueued over the c10d store, and the flush's
collectives are issued from the flushing thread, in plan order.

**Bytes** are counted as the JAX package counts them: an entry holds the
rank-stacked size of its tensor there, so here it counts the world size
times this rank's bytes, and one HOROVOD_FUSION_THRESHOLD gives the same
bins in both packages. The queue's flush count leaves out allgathers and
alltoalls, whose first dims may differ between ranks, so every rank
flushes at the same point. An allgather bin is planned by the bytes it
gathers from every rank: the cycle exchanges their first dims in one small
all-gather (after the divergence check), which also lets first dims differ
between ranks inside one fused gather.

**The plan cache.** Eager torch compiles nothing, so :class:`ExecutableCache`
(the JAX name is kept) holds, per bin signature (the JAX ``sig``: op,
process set, scale factors, root, shapes, dtypes and the knobs that pick
the path), what a cache hit reuses: the grouping by dtype with its
offsets, the chosen path (flat, ``hierarchical_allreduce`` under
HOROVOD_HIERARCHICAL_ALLREDUCE/HOROVOD_TORUS_ALLREDUCE, the two-level DCN
tier under ``resolve_dcn_schedule``, or the ``WireCodec`` tier under
HOROVOD_GRADIENT_COMPRESSION). It is an LRU of HOROVOD_CACHE_CAPACITY
plans. The synchronous collectives do not use it. The fusion buffers are
not the plans': :class:`FusionBuffers` keeps one per (device, dtype,
lane), grown on demand up to the largest fusion threshold, so the memory
they pin does not grow with the signatures seen.

**Streams.** An entry remembers the CUDA stream it was enqueued on; the
bin's stream waits for it before the pack. HOROVOD_NUM_STREAMS > 1 puts
bin i on stream i mod N, but bins are still issued from the cycle's thread
in plan order, so every rank issues its collectives in one order. Under
HOROVOD_ENABLE_ASYNC_COMPLETION (the default) a handle resolves at
dispatch with the bin's CUDA event, which ``wait`` synchronizes; with it
off the cycle synchronizes the event before it resolves the handles.

Knobs read here: HOROVOD_CYCLE_TIME, HOROVOD_FUSION_THRESHOLD[_CROSS],
HOROVOD_CACHE_CAPACITY, HOROVOD_DISABLE_GROUP_FUSION,
HOROVOD_BATCH_D2D_MEMCOPIES, HOROVOD_ENABLE_ASYNC_COMPLETION,
HOROVOD_NUM_STREAMS, HOROVOD_ELASTIC (a dispatch failure becomes
``HorovodInternalError``), HOROVOD_HIERARCHICAL_ALLREDUCE/_TORUS_ALLREDUCE,
HOROVOD_HIERARCHICAL_ALLGATHER, HOROVOD_DCN_SCHEDULE,
HOROVOD_GRADIENT_COMPRESSION, HOROVOD_NUMERICS (a global-set allreduce bin
then gives its entries' nonfinite counts and squared norms to the numerics
monitor, ``goodput/numerics.py``: a segmented reduction over each reduced
fusion buffer, a fixed number of launches a bin, device tensors until the
monitor drains), HOROVOD_AUTOTUNE (the online tuner,
``autotune.ParameterManager``, is fed each cycle's bytes and overrides the
tunable knobs between cycles; in a world of several ranks rank 0 tunes and
the others apply its values at the same cycle over the c10d store,
``autotune.ParameterSynchronizer``).

HOROVOD_ARTIFACT_STORE: a plan the cache misses is read from the
compiled-artifact store (``store/artifact_store.py``, kind
``eager_fused``, components ``{sig, mesh, knobs}``) before a plan is
made, and a plan made is published, so a warm process makes no plan
(``ExecutableCache.snapshot()``'s ``builds == 0``, ``store_hits`` the
plans the store served), the JAX package's contract. A plan is host
data: planning a ResNet-50 step's 161 gradient sizes took 13.2-35.5 us on
the host of an H100 machine (PERF.md, control plane), so the tier keeps
that contract and saves no measurable time; the JAX store saves an XLA
compile here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd.profiler import record_function

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.ops.divergence import DivergenceError
from horovod_tpu_torch.ops.reduce_ops import ReduceOp
from horovod_tpu_torch.tracing import spans as trace
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.coordinator")


class DuplicateNameError(ValueError):
    """Same tensor name enqueued twice before completion
    (ref DUPLICATE_NAME_ERROR common.h:238, tensor_queue.cc AddToTensorQueue)."""


@dataclasses.dataclass
class Entry:
    """One queued collective request (ref Request message.h:59 +
    TensorTableEntry tensor_queue.h)."""
    name: str
    op_type: str                     # allreduce|allgather|broadcast|...
    x: Any                           # this rank's tensor
    handle: Any                      # eager.Handle (pending)
    op: ReduceOp = ReduceOp.AVERAGE
    process_set: Any = None
    prescale_factor: Optional[float] = None
    postscale_factor: Optional[float] = None
    root_rank: int = 0
    splits: Any = None               # alltoallv send counts
    group_id: Optional[int] = None   # grouped-collective membership
    group_size: int = 0              # total entries in the group
    nbytes: int = 0                  # world x this rank's bytes
    # Join-registry snapshot at ENQUEUE time (ref joined_size accounting
    # controller.cc:269-327): dispatch may be deferred past a join() reset,
    # so the mask travels with the request, not with the flush.
    joined: Tuple[int, ...] = ()
    stream: Any = None               # CUDA stream the tensor was made on
    rows: Tuple[int, ...] = ()       # an allgather's first dim per rank


def _counts_toward_flush(e: Entry) -> bool:
    """Whether an entry's bytes are the same on every rank (an allgather's
    or alltoall's first dim may differ)."""
    return e.op_type not in ("allgather", "alltoall")


class TensorQueue:
    """Mutex-guarded message queue (ref common/tensor_queue.{h,cc}):
    rejects duplicate outstanding names, drains in FIFO order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: List[Entry] = []
        self._outstanding: set = set()
        self._bytes = 0                 # queued bytes every rank shares

    def add(self, entry: Entry, on_success=None) -> None:
        """Append entry; ``on_success`` runs under the queue lock so callers
        can update per-entry state atomically with the add: a concurrent
        drain() cannot interleave between the two."""
        with self._lock:
            if entry.name in self._outstanding:
                raise DuplicateNameError(
                    f"tensor name {entry.name!r} already queued; names must "
                    f"be unique among in-flight collectives")
            self._outstanding.add(entry.name)
            self._entries.append(entry)
            if _counts_toward_flush(entry):
                self._bytes += entry.nbytes
            if on_success is not None:
                on_success()

    def queued_bytes(self) -> int:
        """Bytes of the queued entries whose size every rank shares (what
        the deterministic threshold flush and ``hvd_queued_bytes`` read)."""
        with self._lock:
            return self._bytes

    def drain(self) -> List[Entry]:
        with self._lock:
            out, self._entries = self._entries, []
            self._bytes = 0
            return out

    def requeue(self, entries: List[Entry]) -> None:
        """Put drained-but-deferred entries back at the queue head (they are
        still outstanding; no duplicate check)."""
        with self._lock:
            self._entries = list(entries) + self._entries
            self._bytes += sum(e.nbytes for e in entries
                               if _counts_toward_flush(e))

    def remove_group(self, group_id: int) -> List[Entry]:
        """Pull all queued members of an aborted group (their handles are
        resolved with the abort error by the caller)."""
        with self._lock:
            removed = [e for e in self._entries if e.group_id == group_id]
            self._entries = [e for e in self._entries
                             if e.group_id != group_id]
            self._outstanding.difference_update(e.name for e in removed)
            self._bytes -= sum(e.nbytes for e in removed
                               if _counts_toward_flush(e))
            return removed

    def mark_complete(self, names) -> None:
        with self._lock:
            self._outstanding.difference_update(names)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class FusedPlan:
    """What a cache hit reuses for one bin signature: the path and the
    dtype groups with their offsets (``(dtype, indices, numels)``). The
    fusion buffers are the coordinator's (:class:`FusionBuffers`), not the
    plan's, so the memory they pin does not grow with the plans cached."""

    __slots__ = ("op_type", "path", "batch", "groups", "stats")

    def __init__(self, op_type: str, path: str, batch: bool,
                 groups: List[Tuple[torch.dtype, List[int], List[int]]],
                 stats: bool = False):
        self.op_type = op_type
        self.path = path
        self.batch = batch
        self.groups = groups
        # the bin gives its numerics aggregates (HOROVOD_NUMERICS)
        self.stats = stats

    def to_json(self) -> Dict[str, Any]:
        """The plan as the artifact store keeps it (dtypes by name)."""
        return {"op_type": self.op_type, "path": self.path,
                "batch": self.batch, "stats": self.stats,
                "groups": [[str(dt).replace("torch.", ""), list(idxs),
                            list(numels)] for dt, idxs, numels in self.groups]}

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FusedPlan":
        groups = []
        for name, idxs, numels in obj["groups"]:
            dt = getattr(torch, name)
            if not isinstance(dt, torch.dtype):
                raise ValueError(f"not a dtype: {name!r}")
            groups.append((dt, [int(i) for i in idxs],
                           [int(n) for n in numels]))
        return cls(str(obj["op_type"]), str(obj["path"]),
                   bool(obj["batch"]), groups, bool(obj["stats"]))


class FusionBuffers:
    """The persistent fusion buffers of one coordinator, one per (device,
    dtype, lane) (ref FusionBufferManager fusion_buffer_manager.h:31-47:
    one buffer per device and stream). A buffer grows on demand up to
    ``cap_bytes()`` (the largest fusion threshold); a pack larger than
    that (an atomic group over the threshold) gets a buffer of its own
    that is not kept. A buffer remembers the stream that used it last; a
    pack on another stream waits for that one first."""

    def __init__(self, cap_bytes: Callable[[], int]):
        self._cap_bytes = cap_bytes
        self._bufs: Dict[Tuple, List[Any]] = {}    # key -> [tensor, stream]

    def get(self, dtype: torch.dtype, numel: int, device: torch.device,
            lane: Optional[int]) -> torch.Tensor:
        """A contiguous ``numel``-element buffer of ``dtype``, ordered
        after the buffer's last use."""
        cur = torch.cuda.current_stream(device) if device.type == "cuda" \
            else None
        cap = self._cap_bytes() // dtype.itemsize
        if numel > cap:
            return torch.empty(numel, dtype=dtype, device=device)
        key = (str(device), dtype, lane)
        slot = self._bufs.get(key)
        if slot is not None and cur is not None and slot[1] is not None \
                and slot[1] != cur:
            cur.wait_stream(slot[1])           # another stream used it
        if slot is None or slot[0].numel() < numel:
            grown = numel if slot is None else min(
                max(numel, 2 * slot[0].numel()), cap)
            slot = [torch.empty(grown, dtype=dtype, device=device), None]
            self._bufs[key] = slot
        slot[1] = cur
        return slot[0][:numel]

    def nbytes(self) -> int:
        """Bytes the buffers hold now."""
        return sum(t.numel() * t.element_size() for t, _ in
                   self._bufs.values())

    def clear(self) -> None:
        self._bufs.clear()


class ExecutableCache:
    """LRU of fused plans keyed by bin signature: the response cache's
    steady-state fast path (response_cache.h:45), where a hit re-dispatches
    with nothing to rebuild. Capacity = HOROVOD_CACHE_CAPACITY.

    With HOROVOD_ARTIFACT_STORE set, a miss whose caller gives the
    signature's canonical form (``store_sig``) reads the plan from the
    store before it calls ``make``, and publishes a plan it made.
    ``builds`` counts the calls of ``make``, ``store_hits`` the misses the
    store served."""

    def __init__(self, capacity: int):
        from horovod_tpu_torch import metrics as M
        self.capacity = max(int(capacity), 1)
        self._d: "OrderedDict[Tuple, FusedPlan]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.builds = 0                 # plans made by make()
        self.store_hits = 0             # misses the artifact store served
        self._lock = threading.Lock()
        self._m_hits = M.counter(
            "hvd_cache_hits_total",
            "Fused-plan cache lookups served without rebuilding")
        self._m_misses = M.counter(
            "hvd_cache_misses_total",
            "Fused-plan cache lookups that built a plan")
        self._m_evictions = M.counter(
            "hvd_cache_evictions_total",
            "Fused plans dropped by the LRU at capacity")
        self._m_size = M.gauge("hvd_cache_size",
                               "Fused plans currently cached")

    def get_or_build(self, sig: Tuple, make: Callable[[], FusedPlan],
                     store_sig: Any = None) -> FusedPlan:
        """The cached plan for ``sig``; a miss reads the artifact store
        (when it is on and ``store_sig`` is given), else pays
        ``make()``."""
        with self._lock:
            if sig in self._d:
                self._d.move_to_end(sig)
                self.hits += 1
                self._m_hits.inc()
                return self._d[sig]
            self.misses += 1
            self._m_misses.inc()
        store = key = plan = None
        if store_sig is not None:
            store, key = _plan_store_key(store_sig)
            if store is not None:
                plan = _load_plan(store, key)
        if plan is not None:
            with self._lock:
                self.store_hits += 1
        else:
            plan = make()
            with self._lock:
                self.builds += 1
            if store is not None:
                store.publish_blob(key, plan.to_json(),
                                   extra_meta={"label": "eager_fused"})
        with self._lock:
            self._d[sig] = plan
            self._d.move_to_end(sig)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self.evictions += 1
                self._m_evictions.inc()
            self._m_size.set(len(self._d))
        return plan

    def snapshot(self) -> Dict[str, int]:
        """Atomic read of the counters (one lock acquisition)."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "builds": self.builds,
                    "store_hits": self.store_hits, "size": len(self._d),
                    "capacity": self.capacity}

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


def _plan_store_key(store_sig: Any):
    """(store, key) of a plan's artifact-store entry, or (None, None)
    when the store is off or the key cannot be made."""
    try:
        from horovod_tpu_torch.store import artifact_store as _store
        store = _store.from_env()
        if store is None:
            return None, None
        return store, store.key(
            "eager_fused", sig=repr(store_sig),
            mesh=_store.mesh_fingerprint(),
            knobs=_store.program_knob_fingerprint())
    except Exception:
        logger.debug("artifact-store key unavailable", exc_info=True)
        return None, None


def _load_plan(store, key) -> Optional[FusedPlan]:
    """The store's plan for ``key``, or None (a miss: build as usual)."""
    obj = store.load_blob(key)
    if obj is None:
        return None
    try:
        return FusedPlan.from_json(obj)
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        logger.warning("artifact store: eager plan %s unreadable (%s); "
                       "building it", key, e)
        return None


@dataclasses.dataclass
class CycleStats:
    """Observable dispatch counters (for tests and the timeline)."""
    cycles: int = 0
    tensors: int = 0
    dispatched_programs: int = 0
    fused_tensors_max: int = 0
    bytes_total: int = 0


class Coordinator:
    """The cycle dispatcher (ref BackgroundThreadLoop operations.cc:405).
    One per Context, created lazily on the first ``*_async`` call;
    ``Context.coordinator`` holds it."""

    def __init__(self, ctx, start_thread: bool = True):
        from horovod_tpu_torch import metrics as M
        self._ctx = ctx
        self.queue = TensorQueue()
        self.cache = ExecutableCache(knobs.get("HOROVOD_CACHE_CAPACITY"))
        self.buffers = FusionBuffers(self._buffer_cap)
        self.stats = CycleStats()
        self._m_cycles = M.counter(
            "hvd_cycles_total", "Dispatch cycles that flushed entries")
        self._m_cycle_dur = M.histogram(
            "hvd_cycle_duration_seconds",
            "Wall time of one drain+fuse+dispatch cycle")
        self._m_bytes = M.counter(
            "hvd_bytes_reduced_total",
            "Tensor bytes dispatched through fused collectives")
        self._m_tensors = M.counter(
            "hvd_tensors_total", "Tensors dispatched by the coordinator")
        self._m_programs = M.counter(
            "hvd_dispatched_programs_total",
            "Fused dispatches (one per bin)")
        self._m_bins = M.histogram(
            "hvd_bins_per_cycle", "Fusion bins dispatched per cycle",
            buckets=M.COUNT_BUCKETS)
        self._m_deferrals = M.counter(
            "hvd_group_deferrals_total",
            "Cycles that requeued an incomplete atomic group")
        # hvd_queued_bytes is a scrape-time collector gauge (metrics.py):
        # publishing it per enqueue would take the queue lock twice.
        self._m_dispatch = M.histogram(
            "hvd_dispatch_seconds", "Wall time of one bin dispatch "
            "(plan lookup, pack, collective launch, copy out)")
        self._shutdown = threading.Event()
        self._wake = threading.Event()
        self._cycle_lock = threading.Lock()
        self._lanes: List[Any] = []
        # Several ranks must issue IDENTICAL collectives in IDENTICAL
        # order: dispatch is content-deterministic there (module
        # docstring), the single-controller analogue of the reference's
        # negotiation guarantee (controller.cc:74: same response list on
        # every rank).
        self.deterministic = ctx.size > 1
        # The checker verifies that assumption at each flush instead of
        # letting a divergent program hang the world (ref controller.cc:
        # 496-829 mismatch ERROR).
        self.divergence_checker = None
        if self.deterministic:
            from horovod_tpu_torch.ops.divergence import DivergenceChecker
            from horovod_tpu_torch.utils.kvstore import distributed_kv
            kv = distributed_kv(site="divergence", own_connection=True)
            if kv is not None:
                self.divergence_checker = DivergenceChecker(
                    kv, ctx.rank, ctx.size,
                    prefix=f"hvd/divcheck/g{_divcheck_generation()}")
            else:                          # pragma: no cover - defensive
                logger.warning("a world of several ranks without a c10d "
                               "store: divergence checking disabled")
        from horovod_tpu_torch.autotune import (ParameterManager,
                                                continuous_dims)
        # A hierarchical mesh tunes the cross-axis threshold as one more
        # dimension.
        self.autotune = ParameterManager(
            continuous=continuous_dims(ctx.topology.is_hierarchical),
            world=ctx.size)
        # Scores are timings, which differ between ranks, and a knob
        # changes the bins: in a world of several ranks rank 0 tunes and
        # the others apply its values at the same cycle boundary, which
        # deterministic dispatch makes the same on every rank (ref
        # controller.cc:40-54 SynchronizeParameters).
        self._param_sync = None
        if self.deterministic and self.autotune.enabled:
            from horovod_tpu_torch.autotune import (
                make_parameter_synchronizer)
            sync = make_parameter_synchronizer()
            if sync is None:
                logger.warning(
                    "HOROVOD_AUTOTUNE disabled: no c10d store for the "
                    "cross-rank parameter synchronization")
                self.autotune.disable()
            else:
                self._param_sync = sync
                if not sync.is_leader:
                    self.autotune.disable()
        self._min_threshold_cache: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        if start_thread and not self.deterministic:
            self._thread = threading.Thread(target=self._loop,
                                            name="hvd-cycle", daemon=True)
            self._thread.start()

    # -- enqueue side (any thread; ref EnqueueTensorAllreduce op.cc:1404) ----
    def enqueue(self, entry: Entry) -> None:
        from horovod_tpu_torch.eager import _joined_for
        from horovod_tpu_torch.timeline import QUEUE, get_timeline
        x = entry.x
        entry.nbytes = self._ctx.size * x.numel() * x.element_size()
        if entry.op_type in ("allreduce", "allgather"):
            entry.joined = _joined_for(entry.process_set)
        if x.is_cuda:
            entry.stream = torch.cuda.current_stream(x.device)
        # The stall clock of a deferred entry starts at dispatch (the
        # cycle re-tracks it). The untrack and the QUEUE-begin event are
        # atomic with the add: done only after add() succeeds (a
        # DuplicateNameError must not erase the in-flight op's record) and
        # under the queue lock (a concurrent cycle could otherwise dispatch
        # the entry first).
        tl = get_timeline()

        def _on_added():
            if tl.active:
                tl.begin(entry.name, QUEUE, mirror=False)
            trace.begin_async(entry.name, trace.CAT_COORDINATOR)
            if self.deterministic:
                entry.handle._untrack()

        self.queue.add(entry, on_success=_on_added)
        if self.deterministic:
            # Content-deterministic threshold flush: the same enqueue
            # sequence on every rank gives the same flush points.
            if self.queue.queued_bytes() >= self._min_threshold():
                self.run_cycle()
        else:
            self._wake.set()

    # -- cycle loop (ref RunLoopOnce operations.cc:747) ----------------------
    def _loop(self) -> None:
        if self._ctx.device.type == "cuda":
            torch.cuda.set_device(self._ctx.device)
        while not self._shutdown.is_set():
            # Idle-block until work arrives, then hold the CYCLE_TIME
            # batching window so a gradient burst lands in ONE drain.
            self._wake.wait(timeout=1.0)
            if self._shutdown.is_set():
                break
            # Clear BEFORE the emptiness check: an enqueue racing in after
            # the clear re-sets the event.
            self._wake.clear()
            if not len(self.queue):
                continue
            cycle_ms = float(knobs.get("HOROVOD_CYCLE_TIME"))
            if cycle_ms > 0:
                time.sleep(cycle_ms / 1000.0)
            try:
                self.run_cycle()
            except Exception:       # pragma: no cover - keep the loop alive
                logger.exception("cycle loop error")
        try:                        # shutdown never strands queued handles
            self.run_cycle()
        except Exception:           # pragma: no cover
            logger.exception("cycle flush error")

    def run_cycle(self) -> int:
        """Drain + fuse + dispatch once; returns the bins dispatched.
        Public so tests (and the deterministic/thread-less modes) can
        drive cycles directly."""
        with self._cycle_lock:
            return self._run_cycle_locked()

    def _run_cycle_locked(self) -> int:
        from horovod_tpu_torch.timeline import QUEUE, get_timeline
        entries = self.queue.drain()
        # Atomic groups (ref GroupTable): a group whose members have not
        # all been enqueued yet is deferred whole to a later cycle.
        counts: Dict[int, int] = {}
        for e in entries:
            if e.group_id is not None:
                counts[e.group_id] = counts.get(e.group_id, 0) + 1
        incomplete = {gid for gid, c in counts.items()
                      if c < next(e.group_size for e in entries
                                  if e.group_id == gid)}
        if incomplete:
            deferred = [e for e in entries if e.group_id in incomplete]
            entries = [e for e in entries if e.group_id not in incomplete]
            self.queue.requeue(deferred)
            self._m_deferrals.inc()
            if self.divergence_checker is not None:
                # requeues perturb flush composition: back to the base
                # check cadence (ref response-cache invalidation)
                self.divergence_checker.reset_cadence()
        if not entries:
            return 0
        t_cycle0 = time.perf_counter()
        tl = get_timeline()
        self.stats.cycles += 1
        self._m_cycles.inc()
        tl.mark_cycle(self.stats.cycles)
        if self.deterministic:
            for e in entries:          # stall clock starts at dispatch
                e.handle._retrack()
        if tl.active:
            for e in entries:
                tl.end(e.name, QUEUE, mirror=False)
        for e in entries:              # close the QUEUE-phase span mirror
            trace.end_async(e.name, trace.CAT_COORDINATOR)
        self.stats.tensors += len(entries)
        cycle_span = trace.span(
            "coordinator.cycle", cat=trace.CAT_COORDINATOR,
            attrs={"cycle": self.stats.cycles, "tensors": len(entries)}
            if trace.enabled() else None)
        cycle_span.__enter__()
        try:
            # Consistency check BEFORE dispatch: a mismatched flush must
            # never issue its (asymmetric) collectives.
            watch = None            # a flush dispatched unchecked
            if self.divergence_checker is not None:
                with trace.span("coordinator.negotiate",
                                cat=trace.CAT_COORDINATOR):
                    watch = self.divergence_checker.observe(
                        self.stats.cycles, entries)
            with trace.span("coordinator.fuse",
                            cat=trace.CAT_COORDINATOR,
                            attrs={"tensors": len(entries)}
                            if trace.enabled() else None):
                bins = self._plan_bins(entries)
        except Exception as exc:   # never strand queued handles
            cycle_span.__exit__(None, None, None)
            for e in entries:
                e.handle._set_error(exc)
            self.queue.mark_complete([e.name for e in entries])
            raise
        try:
            lanes = self._lanes_for_locked(len(bins))
            for i, b in enumerate(bins):
                exc = self._dispatch_bin(b, i % len(lanes) if lanes else None,
                                         watch)
                if isinstance(exc, DivergenceError):
                    # the world cannot go on: dispatch nothing more
                    rest = [e for later in bins[i + 1:] for e in later]
                    for e in rest:
                        e.handle._set_error(exc)
                    self.queue.mark_complete([e.name for e in rest])
                    break
        finally:
            cycle_span.__exit__(None, None, None)
        self.stats.dispatched_programs += len(bins)
        cycle_bytes = sum(e.nbytes for e in entries)
        self.stats.bytes_total += cycle_bytes
        self._m_tensors.inc(len(entries))
        self._m_programs.inc(len(bins))
        self._m_bins.observe(len(bins))
        self._m_bytes.inc(cycle_bytes)
        self._m_cycle_dur.observe(time.perf_counter() - t_cycle0)
        self.autotune.update(cycle_bytes)
        # The knob sync at the cycle boundary (the same on every rank): the
        # leader publishes this cycle's values, the followers apply them
        # before their next cycle.
        if self._param_sync is not None and not self._param_sync.done:
            if self._param_sync.is_leader:
                self._param_sync.publish(self.stats.cycles,
                                         self.autotune.converged)
                if self._param_sync.frozen:
                    # a degraded-mode freeze: the published-final values
                    # are the trajectory's last word
                    self.autotune.disable()
            else:
                self._param_sync.apply(self.stats.cycles)
        # the knobs may have changed just above
        self._min_threshold_cache = None
        return len(bins)

    def _lanes_for_locked(self, n_bins: int) -> List[Any]:
        """The CUDA streams of HOROVOD_NUM_STREAMS > 1 (empty: each bin
        goes on the dispatching thread's current stream). The caller
        holds ``_cycle_lock``."""
        n = int(knobs.get("HOROVOD_NUM_STREAMS"))
        if n <= 1 or n_bins <= 1 or self._ctx.device.type != "cuda":
            return []
        if len(self._lanes) != n:
            self._lanes = [torch.cuda.Stream(self._ctx.device)
                           for _ in range(n)]
        return self._lanes

    # -- per-axis fusion thresholds ------------------------------------------
    def _axis_kind(self, pset) -> str:
        """'cross' when the op's traffic must traverse the outermost mesh
        axis, 'local' when it stays inside one block of the others. On a
        flat mesh everything is 'local'; global-set collectives on a
        hierarchical mesh always cross; a subgroup crosses iff its members
        span more than one block."""
        topo = self._ctx.topology
        if not topo.is_hierarchical:
            return "local"
        if pset is None or pset.process_set_id == 0:
            return "cross"
        block = topo.size // topo.mesh.shape[topo.flat_axes[0]]
        return "local" if len({r // block for r in pset.ranks}) == 1 \
            else "cross"

    def _threshold_for(self, kind: str) -> int:
        """Bin capacity for an axis kind: the per-axis dict form of
        HOROVOD_FUSION_THRESHOLD, with HOROVOD_FUSION_THRESHOLD_CROSS
        winning for 'cross'."""
        base = knobs.get("HOROVOD_FUSION_THRESHOLD")
        if isinstance(base, dict):
            thr = base.get(kind)
            if thr is None:                      # half-specified dict
                thr = next(iter(base.values()))
        else:
            thr = int(base)
        if kind == "cross":
            cross = int(knobs.get("HOROVOD_FUSION_THRESHOLD_CROSS"))
            if cross > 0:
                thr = cross
        return thr

    def _buffer_cap(self) -> int:
        """The most bytes a fusion buffer keeps: the largest threshold a
        bin is packed under (a bin of several tensors never packs more on
        one rank)."""
        kinds = ("local", "cross") \
            if self._ctx.topology.is_hierarchical else ("local",)
        return max(self._threshold_for(k) for k in kinds)

    def _min_threshold(self) -> int:
        """Deterministic-mode flush capacity, floored at 4 KiB so a tiny
        threshold does not flush per enqueue (a constant floor, hence the
        same on every rank; bin capacity still honours the knob). Cached:
        it sits on the per-enqueue path, and cycles invalidate it."""
        if self._min_threshold_cache is None:
            kinds = ("local", "cross") \
                if self._ctx.topology.is_hierarchical else ("local",)
            self._min_threshold_cache = max(
                min(self._threshold_for(k) for k in kinds), 4096)
        return self._min_threshold_cache

    # -- fusion planning (ref FuseResponses controller.cc:887) ---------------
    def _plan_bins(self, entries: Sequence[Entry]) -> List[List[Entry]]:
        from horovod_tpu_torch.ops.fusion import plan_fusion_bins
        group_exclusive = bool(knobs.get("HOROVOD_DISABLE_GROUP_FUSION"))
        # Compatibility classes: only same-op/same-params tensors share a
        # bin (ref controller.cc:908-986). Mixed dtypes share an allreduce
        # or broadcast bin (one buffer per dtype); an allgather bin packs
        # one buffer, so dtype joins its key.
        classes: "OrderedDict[Tuple, List[Entry]]" = OrderedDict()
        for e in entries:
            if e.op_type in ("allreduce", "broadcast"):
                key = (e.op_type, e.op, _pset_id(e.process_set),
                       e.prescale_factor, e.postscale_factor, e.root_rank,
                       e.joined)     # same join mask per bin
            elif e.op_type == "allgather" and not _solo_gather(e):
                key = (e.op_type, _pset_id(e.process_set), e.x.dtype)
            else:   # alltoall/reducescatter/subgroup or joined gather
                key = ("solo", id(e))
            classes.setdefault(key, []).append(e)
        self._exchange_rows([e for key, group in classes.items()
                             if key[0] == "allgather" for e in group])

        bins: List[List[Entry]] = []
        for key, group in classes.items():
            if key[0] == "solo":
                bins.append(group)
                continue
            # Atomic groups: all entries of a registered group travel
            # together (ref GroupTable group_table.h).
            units: List[List[Entry]] = []
            by_gid: Dict[int, List[Entry]] = {}
            for e in group:
                if e.group_id is None:
                    units.append([e])
                else:
                    if e.group_id not in by_gid:
                        by_gid[e.group_id] = []
                        units.append(by_gid[e.group_id])
                    by_gid[e.group_id].append(e)
            if group_exclusive and by_gid:
                # each registered group is its own bin
                # (HOROVOD_DISABLE_GROUP_FUSION, controller.cc:214-238)
                solo_units = [u for u in units if u[0].group_id is None]
                for gid_unit in by_gid.values():
                    bins.append(list(gid_unit))
                units = solo_units
                if not units:
                    continue
            sizes = [sum(_plan_bytes(e) for e in u) for u in units]
            threshold = self._threshold_for(
                self._axis_kind(group[0].process_set))
            for idxs in plan_fusion_bins(sizes, threshold):
                bins.append([e for i in idxs for e in units[i]])
        return bins

    def _exchange_rows(self, gathers: List[Entry]) -> None:
        """Every rank's first dim of each fused allgather of the cycle, in
        one small all-gather over the world (``Entry.rows``)."""
        if not gathers:
            return
        if self._ctx.size == 1:
            for e in gathers:
                e.rows = (int(e.x.shape[0]),)
            return
        from horovod_tpu_torch.eager import _axis
        from horovod_tpu_torch.ops import collectives as C
        table = C._exchange_ints([int(e.x.shape[0]) for e in gathers],
                                 self._ctx.axis_group(_axis()),
                                 self._ctx.device)
        for j, e in enumerate(gathers):
            e.rows = tuple(int(v) for v in table[:, j])

    # -- dispatch (ref PerformOperation operations.cc:277) -------------------
    def _dispatch_bin(self, entries: List[Entry], lane: Optional[int],
                      watch=None) -> Optional[BaseException]:
        """Dispatch one bin and resolve its handles; returns the error
        they were resolved with, if any. ``watch``: the flush's
        ``FlushWatch`` when it was dispatched unchecked (the waits on its
        collectives go through it)."""
        from horovod_tpu_torch.timeline import DISPATCH, FUSION, get_timeline
        tl = get_timeline()
        names = [e.name for e in entries]
        label = names[0] if len(names) == 1 else f"fused[{len(names)}]"
        t_disp0 = time.perf_counter()
        bin_span = trace.span(
            "coordinator.dispatch", cat=trace.CAT_COORDINATOR,
            attrs={"label": label, "tensors": len(entries),
                   "bytes": sum(e.nbytes for e in entries),
                   "op": entries[0].op_type}
            if trace.enabled() else None)
        bin_span.__enter__()
        cuda = self._ctx.device.type == "cuda"
        cpu_watch = None if cuda else watch
        try:
            with (torch.cuda.stream(self._lanes[lane]) if lane is not None
                  else contextlib.nullcontext()):
                if cuda:
                    _wait_for_producers(entries)
                e0 = entries[0]
                if e0.op_type in ("allreduce", "allgather", "broadcast") \
                        and not _solo_gather(e0):
                    sig, make_plan, wire_acct = self._fused_plan(entries)

                    def _build():
                        if tl.active:
                            with tl.span(label, FUSION, mirror=False):
                                return make_plan()
                        return make_plan()

                    plan = self.cache.get_or_build(
                        sig, _build, store_sig=_store_sig(sig, e0))
                    flats = [] if plan.stats else None
                    if tl.active:
                        with tl.span(label, DISPATCH, mirror=False):
                            outs = self._run_plan(plan, entries, lane,
                                                  cpu_watch, flats)
                    else:
                        outs = self._run_plan(plan, entries, lane,
                                              cpu_watch, flats)
                    if flats is not None:
                        _observe_numerics(names, outs, flats)
                    self.stats.fused_tensors_max = max(
                        self.stats.fused_tensors_max, len(entries))
                    if e0.op_type == "allreduce":
                        from horovod_tpu_torch import metrics as M
                        logical_b, wire_b = wire_acct
                        M.counter(
                            "hvd_grad_wire_bytes_total",
                            "Gradient bytes actually moved by the sync "
                            "collectives (post wire compression)").inc(wire_b)
                        M.counter(
                            "hvd_grad_logical_bytes_total",
                            "Gradient bytes the sync collectives would move "
                            "uncompressed").inc(logical_b)
                else:
                    # Shape-changing per-rank ops dispatch through the sync
                    # eager path, one each (the reference likewise never
                    # fuses alltoall; nccl_operations.cc:1156).
                    outs = []
                    for e in entries:
                        if tl.active:
                            with tl.span(e.name, DISPATCH, mirror=False):
                                outs.append(_dispatch_solo(e))
                        else:
                            outs.append(_dispatch_solo(e))
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record()
            if event is not None and \
                    not knobs.get("HOROVOD_ENABLE_ASYNC_COMPLETION"):
                if watch is not None:
                    watch.wait_until(event.query)
                else:
                    event.synchronize()
            for e, out in zip(entries, outs):
                e.handle._set_result(out, event, watch)
            return None
        except Exception as exc:   # resolve handles with the failure
            from horovod_tpu_torch.goodput.numerics import \
                NumericsAnomalyError
            # An elastic rewrap would turn HOROVOD_NUMERICS_ACTION=abort
            # into a rollback and replay of the same poisoned batch: the
            # anomaly reaches synchronize() as it is.
            if knobs.get("HOROVOD_ELASTIC") and not isinstance(
                    exc, (DivergenceError, NumericsAnomalyError)):
                from horovod_tpu_torch.elastic.exceptions import \
                    HorovodInternalError
                if not isinstance(exc, HorovodInternalError):
                    exc = HorovodInternalError(
                        f"collective dispatch failed for {names}: {exc}")
            for e in entries:
                e.handle._set_error(exc)
            return exc
        finally:
            bin_span.__exit__(None, None, None)
            self._m_dispatch.observe(time.perf_counter() - t_disp0)
            self.queue.mark_complete(names)

    def _fused_plan(self, entries: List[Entry]):
        """(signature, plan builder, (logical, wire) bytes) of one fusable
        bin. The signature keys the plan cache; it holds the JAX ``sig``'s
        fields, with this rank's shapes (and an allgather's first dims on
        every rank) in place of the rank-stacked ones."""
        from horovod_tpu_torch import compression as _compr
        from horovod_tpu_torch.autotune import resolve_dcn_schedule
        from horovod_tpu_torch.runtime.topology import DCN_AXIS
        ctx = self._ctx
        e0 = entries[0]
        topo = ctx.topology
        axes = tuple(topo.flat_axes)
        pset = e0.process_set
        global_set = pset is None or pset.process_set_id == 0
        batch = bool(knobs.get("HOROVOD_BATCH_D2D_MEMCOPIES"))
        # The 2-level decomposition is defined for exactly (cross, local).
        hier = (e0.op_type == "allreduce" and global_set and len(axes) == 2
                and e0.op in (ReduceOp.SUM, ReduceOp.AVERAGE)
                and bool(knobs.get("HOROVOD_HIERARCHICAL_ALLREDUCE")
                         or knobs.get("HOROVOD_TORUS_ALLREDUCE")))
        shapes = tuple(tuple(e.x.shape) for e in entries)
        dtypes = tuple(e.x.dtype for e in entries)
        joined = e0.joined if e0.op_type == "allreduce" else ()
        hier_gather = (e0.op_type == "allgather"
                       and bool(knobs.get("HOROVOD_HIERARCHICAL_ALLGATHER")))
        payload_nb = sum(e.x.numel() * e.x.element_size() for e in entries)
        plain_sum = (e0.op_type == "allreduce" and global_set and not joined
                     and not hier
                     and e0.op in (ReduceOp.SUM, ReduceOp.AVERAGE))
        dcn_tiered = False
        n_ici = 1
        if plain_sum and DCN_AXIS in axes and len(axes) > 1:
            n_ici = ctx.size // topo.mesh.shape[DCN_AXIS]
            dcn_tiered = resolve_dcn_schedule(
                payload_nb, n_ici, topo.mesh.shape[DCN_AXIS]) == "two_level"
        wire_tier = "none"
        if plain_sum and e0.prescale_factor is None \
                and e0.postscale_factor is None:
            wire_tier = _compr.active_wire_tier()
        rows = tuple(e.rows for e in entries) \
            if e0.op_type == "allgather" else ()
        # Numerics aggregates ride global-set allreduce bins only
        # (gradient-like traffic whose outputs are every rank's).
        from horovod_tpu_torch.goodput import numerics as _numerics
        with_stats = (e0.op_type == "allreduce" and global_set
                      and _numerics.ingraph_enabled())
        sig = (e0.op_type, e0.op, _pset_id(pset), e0.prescale_factor,
               e0.postscale_factor, e0.root_rank, shapes, dtypes, batch,
               hier and not joined, joined, hier_gather, wire_tier,
               dcn_tiered, rows, with_stats)
        # Wire-bytes accounting of the bin (hvd_grad_wire_bytes_total):
        # what the reduction moves after compression against the logical
        # (uncompressed, per-rank) payload.
        codec_acct = _compr.WireCodec(wire_tier) \
            if wire_tier != "none" else None
        logical_nbytes = wire_nbytes = 0
        compressed_dtypes = []
        for e in entries:
            elems, item = e.x.numel(), e.x.element_size()
            nb = elems * item
            logical_nbytes += nb
            shard_elems = -(-elems // n_ici) if dcn_tiered else elems
            if codec_acct is not None and codec_acct.compresses(e.x.dtype):
                wire_nbytes += shard_elems * codec_acct.wire_itemsize
                compressed_dtypes.append(e.x.dtype)
            else:
                wire_nbytes += shard_elems * item
            if dcn_tiered:
                # the reduce-scatter and all-gather stages each move the
                # full payload, uncompressed
                wire_nbytes += 2 * nb
        if codec_acct is not None and codec_acct.scaled:
            wire_nbytes += 4 * (len(set(compressed_dtypes)) if batch
                                else len(compressed_dtypes))
        path = ("hierarchical" if hier and not joined
                else "two_level" if dcn_tiered
                else "codec:" + wire_tier if wire_tier != "none"
                else "flat")
        op_type = e0.op_type

        def make_plan() -> FusedPlan:
            groups: "OrderedDict[torch.dtype, Tuple[List[int], List[int]]]" \
                = OrderedDict()
            for i, (shp, dt) in enumerate(zip(shapes, dtypes)):
                idxs, numels = groups.setdefault(dt, ([], []))
                idxs.append(i)
                numels.append(_numel(shp) if op_type != "allgather"
                              else max(rows[i]) * _numel(shp[1:]))
            return FusedPlan(op_type, path, batch,
                             [(dt, idxs, numels)
                              for dt, (idxs, numels) in groups.items()],
                             with_stats)

        return sig, make_plan, (logical_nbytes, wire_nbytes)

    # -- running a plan --------------------------------------------------------
    def _run_plan(self, plan: FusedPlan, entries: List[Entry],
                  lane: Optional[int], watch=None,
                  flats: Optional[list] = None) -> List[torch.Tensor]:
        """The results of one bin, in entry order: each dtype group packed
        into the coordinator's persistent buffer of its dtype and lane, one
        collective per buffer, then copied out of it (the next bin reuses
        the buffer, so a view into it would change under a handle that
        still holds it). ``flats`` collects ``(entry indices, reduced flat
        buffer)`` of each fused group (the numerics aggregates' input)."""
        xs = [e.x for e in entries]
        if plan.op_type == "allgather":
            return self._run_gather(plan, entries, lane, watch)
        if not plan.batch or len(xs) == 1:
            return [_await(self._start(plan, entries[0], x, owned=False),
                           watch) for x in xs]
        outs: List[torch.Tensor] = [None] * len(xs)  # type: ignore
        started = []
        for dtype, idxs, numels in plan.groups:
            if len(idxs) == 1:
                i = idxs[0]
                started.append((idxs, numels, None, self._start(
                    plan, entries[0], xs[i], owned=False)))
                continue
            buf = self.buffers.get(dtype, sum(numels), xs[idxs[0]].device,
                                   lane)
            torch.cat([xs[i].reshape(-1) for i in idxs], out=buf)
            started.append((idxs, numels, buf,
                            self._start(plan, entries[0], buf, owned=True)))
        for idxs, numels, buf, pending in started:
            red = _await(pending, watch)
            if buf is None:
                outs[idxs[0]] = red
                continue
            if red.data_ptr() == buf.data_ptr():
                red = red.clone()           # copy out of the fusion buffer
            if flats is not None:
                flats.append((idxs, red))
            for i, piece in zip(idxs, red.split(numels)):
                outs[i] = piece.view(xs[i].shape)
        return outs

    def _start(self, plan: FusedPlan, e0: Entry, buf: torch.Tensor,
               owned: bool):
        """Start the bin's collective on ``buf`` (a ``collectives._Pending``
        whose result holds the reduced values). ``owned``: ``buf`` is a
        fusion buffer and may be reduced in place; otherwise it is the
        caller's tensor and stays as it was."""
        from horovod_tpu_torch.eager import _axis
        from horovod_tpu_torch.ops import collectives as C
        axis = _axis()
        op, pset = e0.op, e0.process_set
        pre, post = e0.prescale_factor, e0.postscale_factor
        if plan.op_type == "broadcast":
            return C.broadcast_start(buf if owned else buf.clone(),
                                     e0.root_rank, axis, pset)
        if plan.path == "hierarchical":
            axes = self._ctx.topology.flat_axes
            local_n = self._ctx.topology.mesh.shape[axes[1]]
            flat = buf.reshape(-1)
            pad = (-flat.numel()) % local_n
            flat = torch.cat([flat, flat.new_zeros(pad)]) if pad \
                else flat.clone()
            C._scale_(flat, pre)
            out = C.hierarchical_allreduce(flat, op=op, local_axis=axes[1],
                                           cross_axis=axes[0])
            C._scale_(out, post)
            return C._ready((out[:-pad] if pad else out).reshape(buf.shape))
        if plan.path == "two_level":
            from horovod_tpu_torch.runtime.topology import DCN_AXIS
            from horovod_tpu_torch.compression import WireCodec, \
                active_wire_tier
            tier = active_wire_tier()
            codec = WireCodec(tier) if tier != "none" else None
            out = C.two_level_allreduce(
                buf.reshape(-1), op=op,
                ici_axes=self._ctx.topology.ici_axes, dcn_axis=DCN_AXIS,
                wire_codec=codec, prescale_factor=pre,
                postscale_factor=post)
            return C._ready(out.reshape(buf.shape))
        if plan.path.startswith("codec:"):
            from horovod_tpu_torch.compression import WireCodec
            codec = WireCodec(plan.path.split(":", 1)[1])
            if codec.compresses(buf.dtype):
                world = self._ctx.size
                axes_t = axis if isinstance(axis, tuple) else (axis,)
                wire, scale = codec.encode(buf, axes=axes_t, world=world)
                work, red = C.wire_sum_async(wire, axis=axes_t)
                scaled = (1.0 / world) if (op == ReduceOp.AVERAGE
                                           and world != 1) else None
                return C._Pending([work], lambda: codec.decode(
                    red, scale, buf.dtype, postscale=scaled))
        inplace = owned and (op != ReduceOp.AVERAGE
                             or buf.is_floating_point())
        return C.allreduce_start(buf, op, axis, pset, pre, post, e0.joined,
                                 inplace=inplace)

    def _run_gather(self, plan: FusedPlan, entries: List[Entry],
                    lane: Optional[int], watch=None) -> List[torch.Tensor]:
        """A fused allgather: each rank packs its entries, each padded to
        its largest first dim on any rank, into the fusion buffer; one
        all-gather of the buffer; each entry's rows cut out of every
        rank's part, in rank order. HOROVOD_HIERARCHICAL_ALLGATHER gathers
        axis by axis, innermost first (same result)."""
        from horovod_tpu_torch.eager import _axis
        from horovod_tpu_torch.ops import collectives as C
        ctx = self._ctx
        xs = [e.x for e in entries]
        if not plan.batch or len(xs) == 1:
            return [_await(C.allgather_start(x, _axis()), watch)
                    for x in xs]
        ((dtype, idxs, numels),) = plan.groups
        buf = self.buffers.get(dtype, sum(numels), xs[0].device, lane)
        offs = [0]
        for n in numels:
            offs.append(offs[-1] + n)
        if all(e.rows and max(e.rows) == e.x.shape[0] for e in entries):
            torch.cat([x.reshape(-1) for x in xs], out=buf)
        else:
            for i, x in enumerate(xs):
                buf[offs[i]:offs[i] + x.numel()].copy_(x.reshape(-1))
        axes = ctx.topology.flat_axes
        if knobs.get("HOROVOD_HIERARCHICAL_ALLGATHER") and len(axes) > 1:
            gat = buf
            for ax in reversed(axes):
                gat = C._all_gather(gat, ctx.axis_group(ax))
        else:
            gat = _await(C._all_gather_start(buf, ctx.axis_group(_axis())),
                         watch)
        gat = gat.view(ctx.size, -1)
        outs = []
        for i, e in enumerate(entries):
            trailing = tuple(e.x.shape[1:])
            width = _numel(trailing)
            pieces = [gat[r, offs[i]:offs[i] + n * width]
                      for r, n in enumerate(e.rows)]
            outs.append(torch.cat(pieces).view((sum(e.rows),) + trailing))
        return outs

    # -- lifecycle -----------------------------------------------------------
    def reset(self, reason: Optional[BaseException] = None) -> int:
        """Elastic/resize reset: resolve EVERY queued-but-undispatched
        handle with ``reason`` (default: an ``elastic.ResizeInterrupt``)
        instead of dispatching it on a world that is about to change.
        Entries a running cycle owns resolve through that cycle. Returns
        the number of handles resolved; the coordinator stays usable."""
        if reason is None:
            from horovod_tpu_torch.elastic.exceptions import ResizeInterrupt
            reason = ResizeInterrupt(
                "collective cancelled: the world is being resized "
                "(elastic reset in progress); re-enqueue after the "
                "resize commits")
        with self._cycle_lock:
            leftover = self.queue.drain()
            for e in leftover:
                e.handle._set_error(reason)
            self.queue.mark_complete([e.name for e in leftover])
        if leftover:
            from horovod_tpu_torch import metrics as M
            M.counter(
                "hvd_coordinator_reset_resolved_total",
                "Outstanding eager handles resolved with ResizeInterrupt "
                "by Coordinator.reset (elastic/resize quiesce)"
            ).inc(len(leftover))
            logger.warning(
                "coordinator reset: resolved %d outstanding handle(s) "
                "with %s", len(leftover), type(reason).__name__)
        return len(leftover)

    def shutdown(self) -> None:
        """Stop the cycle thread, flushing queued work first (ref shutdown
        path operations.cc:690)."""
        self._shutdown.set()
        self._wake.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=10)
        else:
            self.run_cycle()
        # Anything still queued (a never-completed atomic group) must not
        # strand its handles.
        leftover = self.queue.drain()
        if leftover:
            exc = RuntimeError(
                "coordinator shut down with undispatched entries "
                f"({[e.name for e in leftover]}): incomplete group?")
            for e in leftover:
                e.handle._set_error(exc)
            self.queue.mark_complete([e.name for e in leftover])
        with self._cycle_lock:
            self._lanes = []
        self.buffers.clear()
        self.autotune.close()


# Divergence-check key-prefix generation: the c10d store's keys outlive
# shutdown()+init() in a process, so each coordinator gets a fresh prefix
# (every rank constructs the same number of coordinators, so generations
# agree without communication).
_divcheck_gen = 0
_divcheck_gen_lock = threading.Lock()


def _divcheck_generation() -> int:
    global _divcheck_gen
    with _divcheck_gen_lock:
        gen = _divcheck_gen
        _divcheck_gen += 1
        return gen


def _pset_id(pset) -> int:
    return 0 if pset is None else pset.process_set_id


def _store_sig(sig: Tuple, e0: "Entry") -> Tuple:
    """A bin signature in a form equal in every process and every world of
    the same shape: the process set by its ranks (its id is the order of
    registration) and dtypes by name. The rest is ints, floats, strings,
    bools and tuples of them already."""
    pset = e0.process_set
    ranks = None if pset is None or pset.ranks is None \
        else tuple(pset.ranks)
    return tuple(
        ("ranks", ranks) if i == 2
        else tuple(str(d).replace("torch.", "") for d in v) if i == 7
        else v for i, v in enumerate(sig))


def _observe_numerics(names: List[str], outs: List[torch.Tensor],
                      flats: list) -> None:
    """Give the numerics monitor one bin's per-entry nonfinite counts and
    squared norms: a segmented reduction over each reduced flat buffer
    (``flats``; the entries outside them packed by dtype first), device
    tensors all, and labels in the order of the counts."""
    from horovod_tpu_torch.goodput import numerics as _numerics
    monitor = _numerics.get_monitor()
    if monitor is None:
        return
    covered = {i for idxs, _ in flats for i in idxs}
    by_dtype: "OrderedDict[torch.dtype, List[int]]" = OrderedDict()
    for i, o in enumerate(outs):
        if i not in covered:
            by_dtype.setdefault(o.dtype, []).append(i)
    groups = list(flats) + [
        (idxs, outs[idxs[0]] if len(idxs) == 1
         else torch.cat([outs[i].reshape(-1) for i in idxs]))
        for idxs in by_dtype.values()]
    nfs, sqs, order = [], [], []
    # the label lets a profile count the aggregates' launches and time
    with record_function("hvd_numerics"):
        for idxs, flat in groups:
            nf, sq = _numerics.bin_aggregates(
                flat, [outs[i].numel() for i in idxs])
            nfs.append(nf)
            sqs.append(sq)
            order += idxs
        if len(groups) > 1:
            nfs, sqs = [torch.cat(nfs)], [torch.cat(sqs)]
    monitor.observe_bin([names[i] for i in order], nfs[0], sqs[0])


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _solo_gather(e: Entry) -> bool:
    """A subgroup allgather, or one with a join mask (it drops rows),
    dispatches alone through the eager path with its enqueue-time
    snapshot."""
    return e.op_type == "allgather" and (_pset_id(e.process_set) != 0
                                         or bool(e.joined))


def _plan_bytes(e: Entry) -> int:
    """An entry's size in the bin plan: its bytes, and for a fused
    allgather the bytes it gathers from every rank."""
    if e.op_type == "allgather" and e.rows:
        return sum(e.rows) * _numel(e.x.shape[1:]) * e.x.element_size()
    return e.nbytes


def _await(pending, watch):
    """``pending.wait()``, through ``watch`` (a ``FlushWatch``) when given:
    on the CPU, for a flush dispatched unchecked (gloo blocks the host in
    the wait; on the card the wait only orders the stream, and
    ``Handle.wait`` watches the bin's event instead)."""
    if watch is not None and pending.works:
        watch.wait_until(pending.is_completed)
    return pending.wait()


def _wait_for_producers(entries: Sequence[Entry]) -> None:
    """Order the current stream after the streams the entries' tensors
    were enqueued on."""
    cur = None
    seen = []
    for e in entries:
        s = e.stream
        if s is None or any(s == t for t in seen):
            continue
        seen.append(s)
        if cur is None:
            cur = torch.cuda.current_stream(e.x.device)
        if s != cur:
            cur.wait_stream(s)


def _dispatch_solo(e: Entry):
    """Dispatch a non-fusable entry through the sync eager API."""
    from horovod_tpu_torch import eager
    if e.op_type == "alltoall":
        return eager.alltoall(e.x, splits=e.splits,
                              process_set=e.process_set)
    if e.op_type == "reducescatter":
        return eager.reducescatter(
            e.x, op=e.op, process_set=e.process_set,
            prescale_factor=e.prescale_factor,
            postscale_factor=e.postscale_factor)
    if e.op_type == "allgather":     # subgroup/joined gather, dispatched
        # with the enqueue-time join snapshot
        return eager.allgather(e.x, process_set=e.process_set,
                               _joined=e.joined)
    raise ValueError(f"unknown op_type {e.op_type}")


_lazy_init_lock = threading.Lock()


def get_coordinator(ctx) -> Coordinator:
    """Lazily create the context's coordinator (ref InitializeHorovodOnce
    spawning the background thread, operations.cc:890). Locked: two
    threads racing the first ``*_async`` call must agree on ONE
    coordinator."""
    with _lazy_init_lock:
        if ctx.coordinator is None:
            ctx.coordinator = Coordinator(ctx)
        return ctx.coordinator
