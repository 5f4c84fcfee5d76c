"""Async off-step-path checkpointing with crash-safe manifest commit.

The port's counterpart of ``horovod_tpu/resilience/async_checkpoint.py``.
The step-loop cost of a snapshot is ONLY the device->host copy, taken at a
safe point between steps; serialization and the commit protocol run on a
background writer thread, so the card keeps stepping while the previous
snapshot drains to disk (the CheckFreq shape, Mohan et al., FAST'21).

**The state is live.** Where the JAX package snapshots an immutable
pytree, the port's ``TrainState`` holds tensors, ``nn.Module``s and
optimizers that other objects reference: ``DistributedOptimizer``'s
gradient hooks and the fused launcher's bound error-feedback residuals
point at those exact tensors. So :func:`host_snapshot` copies every
tensor out (a module as its ``state_dict``, an optimizer as its
``state_dict`` plus, for a ``DistributedOptimizer``, its residuals), and
restore (:func:`_place_tree`) writes back INTO the live objects: ``copy_``
for tensors, ``load_state_dict`` for modules and optimizers. A restore
that built new tensors would leave the hooks syncing the old ones.

**The copy.** A CUDA tensor is copied into a pinned host buffer with
``non_blocking=True`` on the current stream, which orders the copy after
everything the step queued there, the fused epilogue's updates included
(its side-stream work is joined into the current stream before the step
returns). An event recorded after the copies is what the writer thread
waits on before it reads a buffer. The pinned buffers come in a fixed
number of sets (two: one snapshot draining, one being taken), made
by :meth:`AsyncCheckpointer.reserve` (``train_loop`` calls it after the
first step, once the optimizer has made its state) or by the first
snapshot that takes a set, and reused once
their write has been serialized; a save that finds no set free waits for
one, so the pinned memory stays at two snapshots.

**Who writes what.** Every rank writes ``shard-<rank>.pkl``. Replicated
leaves (parameters, optimizer state, step) are written once, by rank 0,
the replica-0 owner, as the JAX package's ``host_snapshot`` keeps only the
``replica_id == 0`` shards; the other ranks write a placeholder there.
Per-rank leaves (the error-feedback residual, marked by the state type's
``_per_rank_fields``) go into each rank's own shard. Restore reads this
rank's shard and fills the placeholders from shard 0.

Crash-safe commit protocol (every checkpoint):

1. all shard data is written into ``<dir>/.tmp-step-<n>/``;
2. the manifest (step, world size, mesh fingerprint, per-shard digests)
   is written INSIDE the tmp dir, with ``"committed": true``;
3. one atomic ``os.rename`` to ``<dir>/step-<n>/`` publishes it.

A crash at any point leaves either nothing or a ``.tmp-*`` orphan, and
``restore_latest`` only considers directories whose manifest parses and
says committed. Rotation deletes older snapshots only AFTER the new
manifest is committed.

Several ranks add a barrier around step 3 on the c10d store of the
default process group (``utils/kvstore.py``): every rank writes its shard,
publishes the shard digest under a per-(directory, step, attempt)
namespace, and rank 0 renames and publishes the commit record once every
shard has landed. The namespace holds only what every rank shares: the
attempt counts this rank's saves of that directory and step, and every
rank makes the same saves, because a rank never skips a due save on its
own: when a rank has no free buffer set, ``maybe_save`` agrees over the
store, and every rank defers that save together. The writer thread waits
on its own connection to the store (a ``clone``), so the step path's
store calls (the preemption poll, the stop-step agreement) never queue
behind a barrier. A rank that dies mid-checkpoint times the barrier out
(``HOROVOD_CKPT_COMMIT_TIMEOUT``); the attempt is abandoned uncommitted
and training continues, which is what the chaos harness's commit
delay/deny injections exercise. Any other failure of a write (a full
disk, a serialization error) is raised at the next ``maybe_save``,
``save`` or ``wait``: it is never only logged.

Dynamic cadence (``HOROVOD_CKPT_INTERVAL=auto``): the interval keeps the
measured on-path snapshot cost (the host's issue time plus the copy's
device time) under ``HOROVOD_CKPT_OVERHEAD_BUDGET`` of wall time, using
the mean step time of StepStats' ``hvd_step_duration_seconds``:

    interval = ceil(snapshot_cost / (budget * mean_step_time))
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pickle
import queue
import shutil
import struct
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils import schedhooks
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.resilience")

MANIFEST_NAME = "manifest.json"
_STEP_PREFIX = "step-"
_TMP_PREFIX = ".tmp-"
# First auto interval before any cost measurement exists: small, so the
# first save happens early and the cadence can calibrate from real numbers.
_AUTO_START_INTERVAL = 10
# Pinned buffer sets per checkpointer: one snapshot draining to disk while
# the next is taken.
_PINNED_SETS = 2


class CheckpointCommitError(RuntimeError):
    """A checkpoint attempt could not be committed (denied, timed out, or
    failed mid-write). The on-disk state is unchanged: the attempt's tmp
    dir is not restorable and the previous committed snapshot survives."""


class CheckpointWriteError(CheckpointCommitError):
    """An async write failed for another reason than the commit
    protocol's own abandon (a full disk, a serialization error). Raised
    at the next ``maybe_save``/``save``/``wait``."""


class CheckpointMismatchError(RuntimeError):
    """A committed checkpoint's manifest does not match the current
    topology and cannot be adopted safely."""


# ---------------------------------------------------------------------------
# host snapshots: device -> host, rank 0 keeping the replicated leaves
# ---------------------------------------------------------------------------

class _OnRank0:
    """Placeholder of a replicated leaf in a shard of a rank other than 0:
    rank 0's shard holds the value."""

    def __reduce__(self):
        return "ON_RANK0"

    def __repr__(self):
        return "ON_RANK0"


ON_RANK0 = _OnRank0()


@dataclasses.dataclass
class ModuleImage:
    """Host image of an ``nn.Module``: its ``state_dict``."""
    state: Dict[str, Any]


@dataclasses.dataclass
class OptimizerImage:
    """Host image of an optimizer: its ``state_dict`` and, for a
    ``DistributedOptimizer`` with error feedback, its per-rank residuals
    (a :class:`PerRank` list)."""
    state: Dict[str, Any]
    residual: Any = None


@dataclasses.dataclass
class PerRank:
    """A per-rank subtree of the host tree: every rank writes its own."""
    value: Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


class _PinnedPool:
    """A fixed number of pinned host buffer sets, one snapshot's buffers
    each. A set's buffers are made by ``reserve`` or by the first snapshot
    that takes the set, and reused by every later snapshot of the same
    shapes; the writer hands the set back once it has serialized it."""

    def __init__(self, n_sets: int = _PINNED_SETS):
        self._sets: List[List[torch.Tensor]] = [[] for _ in range(n_sets)]
        self._free = list(range(n_sets))
        self._cond = schedhooks.Condition()

    def free_sets(self) -> List[int]:
        with self._cond:
            return list(self._free)

    def acquire(self) -> int:
        """The lowest free set's index (the sets ``reserve`` made come
        first), waiting for the writer to hand one back when none is
        free."""
        with self._cond:
            while not self._free:
                self._cond.wait()
            idx = min(self._free)
            self._free.remove(idx)
            return idx

    def release(self, idx: int) -> None:
        with self._cond:
            self._free.append(idx)
            self._cond.notify_all()

    def buffer(self, idx: int, i: int, shape, dtype) -> torch.Tensor:
        """The ``i``-th buffer of set ``idx``, made (or remade, when the
        state's shapes changed) on first use."""
        bufs = self._sets[idx]
        if i < len(bufs) and tuple(bufs[i].shape) == tuple(shape) \
                and bufs[i].dtype == dtype:
            return bufs[i]
        buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        if i < len(bufs):
            bufs[i] = buf
        else:
            bufs.append(buf)
        return buf

    def clear(self) -> None:
        with self._cond:
            self._sets = [[] for _ in self._sets]


class _Copier:
    """One snapshot's copies: CUDA tensors into the pinned buffers of one
    set on the current stream (non-blocking), CPU tensors and arrays by
    value. ``copy=False`` only makes the set's buffers (``reserve``)."""

    def __init__(self, owner: bool, pool: Optional[_PinnedPool],
                 set_idx: Optional[int] = None, copy: bool = True):
        self.owner = owner
        self.pool = pool
        self.set_idx = set_idx
        self.copy = copy
        self.pinned: List[torch.Tensor] = []
        self.starts: Dict[torch.device, Any] = {}   # device -> start event

    def tensor(self, t: torch.Tensor) -> Any:
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone() if self.copy else None
        buf = (self.pool.buffer(self.set_idx, len(self.pinned), t.shape,
                                t.dtype) if self.pool is not None
               else torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
        self.pinned.append(buf)
        if not self.copy:
            return None
        dev = t.device
        if dev not in self.starts:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            self.starts[dev] = start
        buf.copy_(t, non_blocking=True)
        return buf

    def array(self, x: Any) -> Any:
        return np.array(x, copy=True) if self.copy else None

    def finish(self) -> List[Tuple[Any, Any]]:
        """Record the end event of every device's copies; returns
        ``[(start, end), ...]``."""
        out = []
        for dev, start in self.starts.items():
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(dev))
            out.append((start, end))
        return out


def _walk(x: Any, cp: _Copier, per_rank: bool = False) -> Any:
    from horovod_tpu_torch.parallel.distributed import DistributedOptimizer
    mine = per_rank or cp.owner
    if isinstance(x, torch.Tensor):
        return cp.tensor(x) if mine else ON_RANK0
    if isinstance(x, torch.nn.Module):
        return ModuleImage(_walk(dict(x.state_dict()), cp, per_rank))
    if isinstance(x, DistributedOptimizer):
        residual = None
        if x.wire_state:
            residual = PerRank(_walk(list(x.wire_state.residual), cp, True))
        return OptimizerImage(_walk(x.optimizer.state_dict(), cp, per_rank),
                              residual)
    if isinstance(x, torch.optim.Optimizer):
        return OptimizerImage(_walk(x.state_dict(), cp, per_rank))
    if _is_namedtuple(x):
        ranked = getattr(type(x), "_per_rank_fields", ())
        return type(x)(*(
            PerRank(_walk(v, cp, True)) if f in ranked
            else _walk(v, cp, per_rank)
            for f, v in zip(x._fields, x)))
    if isinstance(x, dict):
        # keys in sorted order where they sort, as jax.tree rebuilds a
        # dict: a tree of numpy leaves pickles to the JAX package's bytes
        try:
            keys = sorted(x)
        except TypeError:
            keys = list(x)
        return {k: _walk(x[k], cp, per_rank) for k in keys}
    if isinstance(x, (list, tuple)):
        return type(x)(_walk(v, cp, per_rank) for v in x)
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return cp.array(x) if mine else ON_RANK0
    return x


def _snapshot(tree: Any, owner: bool, pool: Optional[_PinnedPool] = None,
              set_idx: Optional[int] = None):
    cp = _Copier(owner, pool, set_idx)
    host = _walk(tree, cp)
    return host, cp.finish()


def host_snapshot(tree: Any, owner: Optional[bool] = None) -> Any:
    """Host image of ``tree``: tensors become CPU tensors (copied out of
    the card), numpy arrays copies, modules and optimizers their
    ``state_dict`` images; other leaves pass through. ``owner`` (default:
    this is rank 0) writes the replicated leaves; otherwise they become
    placeholders and only the per-rank leaves are kept. Returns once the
    copies have completed."""
    if owner is None:
        owner = schedhooks.process_world()[0] == 0
    host, events = _snapshot(tree, owner)
    for _, end in events:
        end.synchronize()
    return host


def _merge_rank0(mine: Any, rank0: Any) -> Any:
    """This rank's host tree with every placeholder filled from rank 0's
    tree (the same structure)."""
    if mine is ON_RANK0:
        return rank0
    if isinstance(mine, PerRank):
        return mine
    if isinstance(mine, (ModuleImage, OptimizerImage)):
        return type(mine)(*(_merge_rank0(getattr(mine, f.name),
                                         getattr(rank0, f.name))
                            for f in dataclasses.fields(mine)))
    if _is_namedtuple(mine):
        return type(mine)(*(_merge_rank0(a, b) for a, b in zip(mine, rank0)))
    if isinstance(mine, dict):
        return {k: _merge_rank0(v, rank0[k]) for k, v in mine.items()}
    if isinstance(mine, (list, tuple)):
        return type(mine)(_merge_rank0(a, b) for a, b in zip(mine, rank0))
    return mine


def _count_per_rank(host: Any) -> int:
    if isinstance(host, PerRank):
        return max(1, len(_leaves(host.value)))
    if isinstance(host, (ModuleImage, OptimizerImage)):
        return sum(_count_per_rank(getattr(host, f.name))
                   for f in dataclasses.fields(host))
    if isinstance(host, dict):
        return sum(_count_per_rank(v) for v in host.values())
    if isinstance(host, (list, tuple)):
        return sum(_count_per_rank(v) for v in host)
    return 0


def _leaves(host: Any) -> List[Any]:
    if isinstance(host, PerRank):
        return _leaves(host.value)
    if isinstance(host, (ModuleImage, OptimizerImage)):
        return [leaf for f in dataclasses.fields(host)
                for leaf in _leaves(getattr(host, f.name))]
    if isinstance(host, dict):
        return [leaf for v in host.values() for leaf in _leaves(v)]
    if isinstance(host, (list, tuple)):
        return [leaf for v in host for leaf in _leaves(v)]
    return [host]


def _unwrap(host: Any) -> Any:
    """The host tree without its image and PerRank wrappers: plain
    nested containers of tensors, arrays and scalars."""
    if isinstance(host, PerRank):
        return _unwrap(host.value)
    if isinstance(host, ModuleImage):
        return _unwrap(host.state)
    if isinstance(host, OptimizerImage):
        out = _unwrap(host.state)
        if host.residual is not None:
            out = {"optimizer": out, "residual": _unwrap(host.residual)}
        return out
    if _is_namedtuple(host):
        return type(host)(*(_unwrap(v) for v in host))
    if isinstance(host, dict):
        return {k: _unwrap(v) for k, v in host.items()}
    if isinstance(host, (list, tuple)):
        return type(host)(_unwrap(v) for v in host)
    return host


def _copy_into(dst: torch.Tensor, src: Any) -> torch.Tensor:
    src = src if isinstance(src, torch.Tensor) else torch.as_tensor(
        np.asarray(src))
    if tuple(src.shape) != tuple(dst.shape):
        raise CheckpointMismatchError(
            f"template shape {tuple(dst.shape)} != checkpointed "
            f"{tuple(src.shape)}")
    with torch.no_grad():
        dst.copy_(src)
    return dst


def _place_tree(host_tree: Any, template: Any) -> Any:
    """Write a host snapshot back into the live ``template``: tensors by
    ``copy_``, modules and optimizers by ``load_state_dict``, residuals by
    ``copy_``, so every object that references the template's tensors
    (gradient hooks, bound residuals) sees the restored values. Returns
    the template's structure with the restored leaves (the same tensor
    objects); numpy and scalar leaves come back as host values."""
    from horovod_tpu_torch.parallel.distributed import DistributedOptimizer
    h = host_tree.value if isinstance(host_tree, PerRank) else host_tree
    t = template
    if isinstance(t, torch.Tensor):
        return _copy_into(t, h)
    if isinstance(t, torch.nn.Module):
        t.load_state_dict(_unwrap(h))
        return t
    if isinstance(t, DistributedOptimizer):
        t.optimizer.load_state_dict(_unwrap(h.state))
        if t.wire_state:
            if h.residual is None:
                raise CheckpointMismatchError(
                    "the optimizer carries an error-feedback residual but "
                    "the checkpoint has none")
            for dst, src in zip(t.wire_state.residual,
                                _unwrap(h.residual)):
                _copy_into(dst, src)
        return t
    if isinstance(t, torch.optim.Optimizer):
        t.load_state_dict(_unwrap(h.state if isinstance(h, OptimizerImage)
                                  else h))
        return t
    if _is_namedtuple(t):
        return type(t)(*(_place_tree(a, b) for a, b in zip(h, t)))
    if isinstance(t, dict):
        if not isinstance(h, dict) or set(h) != set(t):
            raise CheckpointMismatchError(
                f"template keys {sorted(t)} != checkpointed "
                f"{sorted(h) if isinstance(h, dict) else type(h).__name__}")
        return {k: _place_tree(h[k], t[k]) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_place_tree(a, b) for a, b in zip(h, t))
    if isinstance(t, np.ndarray):
        return np.asarray(h)
    return _unwrap(h)


# ---------------------------------------------------------------------------
# shard files: pickle, with the tensors' bytes outside the pickle stream
# ---------------------------------------------------------------------------

# A shard that holds tensors is this magic, the pickle stream's length and
# the stream (tensors pickled by reference: persistent ids), then every
# tensor's bytes in order. Writing and hashing those bytes release the
# GIL, so a multi-GB shard drains without stalling the training thread;
# pickling the tensors in-band would hold it for seconds. A shard of
# numpy arrays and scalars alone is the plain pickle of the JAX package
# (the same bytes, so the same digest).
_SHARD_MAGIC = b"HVDSHRD1"


def _raw(t: torch.Tensor) -> memoryview:
    """The bytes of a contiguous CPU tensor, without a copy."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


class _ShardPickler(pickle.Pickler):
    def __init__(self, f, tensors: List[torch.Tensor]):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.tensors = tensors

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            self.tensors.append(obj.contiguous())
            return ("tensor", len(self.tensors) - 1)
        return None


class _ShardUnpickler(pickle.Unpickler):
    def __init__(self, f, tensors: List[torch.Tensor]):
        super().__init__(f)
        self.tensors = tensors

    def persistent_load(self, pid):
        return self.tensors[pid[1]]


def _serialize(host: Any) -> List[Any]:
    """The shard file's chunks (bytes and memoryviews, in order)."""
    import io
    tensors: List[torch.Tensor] = []
    head = io.BytesIO()
    _ShardPickler(head, tensors).dump({"tree": host})
    if not tensors:
        return [pickle.dumps({"tree": host},
                             protocol=pickle.HIGHEST_PROTOCOL)]
    # the table of tensors goes first so the reader can allocate them
    table = pickle.dumps([(str(t.dtype).replace("torch.", ""),
                           tuple(t.shape)) for t in tensors],
                         protocol=pickle.HIGHEST_PROTOCOL)
    stream = head.getvalue()
    return ([_SHARD_MAGIC, struct.pack("<QQ", len(table), len(stream)),
             table, stream] + [_raw(t) for t in tensors])


def _read_shard(path: str) -> Any:
    with open(path, "rb") as f:
        magic = f.read(len(_SHARD_MAGIC))
        if magic != _SHARD_MAGIC:
            f.seek(0)
            return pickle.load(f)["tree"]
        n_table, n_stream = struct.unpack("<QQ", f.read(16))
        table = pickle.loads(f.read(n_table))
        stream = f.read(n_stream)
        tensors = []
        for dtype, shape in table:
            t = torch.empty(shape, dtype=getattr(torch, dtype))
            if t.numel():
                view = _raw(t)
                if f.readinto(view) != view.nbytes:
                    raise CheckpointMismatchError(
                        f"shard {path} is truncated")
            tensors.append(t)
    import io
    return _ShardUnpickler(io.BytesIO(stream), tensors).load()["tree"]


# ---------------------------------------------------------------------------
# manifest + directory layout
# ---------------------------------------------------------------------------

def mesh_fingerprint() -> Dict[str, Any]:
    """Topology identity a checkpoint was taken under: world size, device
    count (one card per rank), and, when the runtime is initialized, the
    mesh of its ``Topology``."""
    _, world = schedhooks.process_world()
    fp: Dict[str, Any] = {"world_size": world, "n_devices": world}
    try:
        from horovod_tpu_torch.runtime import context
        if context.is_initialized():
            m = context.mesh()
            fp["mesh_shape"] = [int(s) for s in m.devices.shape]
            fp["mesh_axes"] = [str(a) for a in m.axis_names]
    except Exception:
        pass
    return fp


def fingerprint_mismatch(manifest: Dict[str, Any],
                         fp: Optional[Dict[str, Any]] = None
                         ) -> Optional[str]:
    """Human-readable description of why ``manifest`` does not match the
    current topology, or None when it does."""
    fp = fp or mesh_fingerprint()
    diffs = []
    for key in ("world_size", "n_devices", "mesh_shape", "mesh_axes"):
        saved, cur = manifest.get(key), fp.get(key)
        if saved is not None and cur is not None and saved != cur:
            diffs.append(f"{key} {saved} -> {cur}")
    return "; ".join(diffs) or None


def step_dirname(step: int) -> str:
    return f"{_STEP_PREFIX}{step:010d}"


def _tmp_dirname(step: int) -> str:
    return f"{_TMP_PREFIX}{step_dirname(step)}"


def read_manifest(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """The manifest of one checkpoint directory, or None when the
    directory is partial/uncommitted/corrupt (never raises: a torn write
    must look like 'no checkpoint here', not an error)."""
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if not manifest.get("committed"):
        return None
    return manifest


def list_committed_steps(directory: str) -> List[int]:
    """Steps with a committed manifest, ascending. Partial/uncommitted
    directories (tmp dirs, missing or torn manifests) are skipped."""
    steps = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        if not name.startswith(_STEP_PREFIX):
            continue
        manifest = read_manifest(os.path.join(directory, name))
        if manifest is not None:
            steps.append(int(manifest["step"]))
    return sorted(steps)


def latest_committed_step(directory: str) -> Optional[int]:
    steps = list_committed_steps(directory)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# cadence: CheckFreq-style dynamic interval
# ---------------------------------------------------------------------------

class CheckpointCadence:
    """Chooses the save interval. Fixed when ``interval`` is an int;
    ``'auto'`` re-derives it after every save from the EWMA'd on-path
    snapshot cost and the mean step time observed by StepStats.

    ``frozen=True`` (several ranks) pins the interval at its initial
    value: every rank must save at the SAME steps or the commit barrier
    times out, and cost and step-time measurements are rank-local."""

    def __init__(self, interval: Any, budget: float, frozen: bool = False):
        self.auto = interval == "auto" and not frozen
        self.interval = _AUTO_START_INTERVAL if interval == "auto" \
            else int(interval)
        self.budget = max(float(budget), 1e-6)
        self._cost_ewma: Optional[float] = None
        # Step-time baseline: deltas against the process-global histogram
        # so a long-lived registry (tests, notebook reuse) cannot skew us.
        from horovod_tpu_torch import metrics as M
        hist = M.histogram("hvd_step_duration_seconds",
                           "Wall time per training step")
        self._hist = hist
        self._base_sum = hist.total_sum
        self._base_count = hist.total_count

    def mean_step_time(self) -> Optional[float]:
        n = self._hist.total_count - self._base_count
        if n <= 0:
            return None
        return (self._hist.total_sum - self._base_sum) / n

    def observe_snapshot_cost(self, seconds: float) -> None:
        self._cost_ewma = seconds if self._cost_ewma is None \
            else 0.5 * self._cost_ewma + 0.5 * seconds
        if not self.auto:
            return
        mean_step = self.mean_step_time()
        if not mean_step or mean_step <= 0:
            return
        self.interval = max(
            1, min(int(math.ceil(
                self._cost_ewma / (self.budget * mean_step))), 10 ** 6))


# ---------------------------------------------------------------------------
# the checkpointer
# ---------------------------------------------------------------------------

def _kv_namespace(directory: str, step: int) -> str:
    tag = hashlib.sha1(os.path.abspath(directory).encode()).hexdigest()[:12]
    return f"hvdckpt/{tag}/{step}"


# Saves of each (rank, directory, step) made by this process: the attempt
# number in the store namespace. The store outlives one save (a resumed
# run in the same process re-reaching a step, a repeated save of a step),
# and every rank makes the same saves, so every rank counts the same.
_attempts: Dict[Tuple[int, str, int], int] = {}
_attempts_lock = schedhooks.Lock()


def _attempt_namespace(directory: str, step: int) -> str:
    pidx = schedhooks.process_world()[0]
    with _attempts_lock:
        key = (pidx, os.path.abspath(directory), int(step))
        n = _attempts.get(key, 0)
        _attempts[key] = n + 1
    return f"{_kv_namespace(directory, step)}/{n}"


@dataclasses.dataclass
class _Pending:
    """One queued write: the host tree, the copy events to wait on, the
    pinned set to hand back, the step path's cost and, on several ranks,
    the store namespace of the commit barrier."""
    step: int
    host: Any
    events: List[Tuple[Any, Any]]
    set_idx: int
    t0: float
    block: float
    ns: Optional[str]


class AsyncCheckpointer:
    """Background checkpoint writer with crash-safe commit + rotation.

    Usage in a train loop::

        ckpt = AsyncCheckpointer(directory)
        restored = ckpt.restore_latest(template=state)
        if restored is not None:
            start_step, state = restored
        for step in range(start_step, total):
            state, loss = train_step(state, batch)
            ckpt.maybe_save(step + 1, state)   # off-step-path
        ckpt.close()

    ``maybe_save`` blocks only to issue the device->host copy;
    serialization and the commit run on the writer thread.
    ``save(..., sync=True)`` is the preemption path: durable (committed
    or raised) on return. Construct it after ``init()``: several ranks
    pin the cadence and commit behind the c10d-store barrier. Call
    ``reserve(state)`` once the state is complete (after the first step:
    torch.optim makes its state lazily) so that no save pays for its
    pinned buffers (``train_loop`` does).
    """

    def __init__(self, directory: str,
                 interval: Any = None,
                 max_to_keep: Optional[int] = None,
                 overhead_budget: Optional[float] = None,
                 fmt: Optional[str] = None,
                 commit_timeout: Optional[float] = None):
        from horovod_tpu_torch import metrics as M
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = (knobs.get("HOROVOD_CKPT_KEEP")
                            if max_to_keep is None else int(max_to_keep))
        self.commit_timeout = (knobs.get("HOROVOD_CKPT_COMMIT_TIMEOUT")
                               if commit_timeout is None
                               else float(commit_timeout))
        self.fmt = fmt or knobs.get("HOROVOD_CKPT_FORMAT")
        if self.fmt == "orbax":
            raise ValueError(
                "HOROVOD_CKPT_FORMAT=orbax is the JAX package's format; "
                "horovod_tpu_torch writes 'pickle' shards ('auto' "
                "resolves to it)")
        if self.fmt not in ("auto", "pickle"):
            raise ValueError(f"unknown checkpoint format {self.fmt!r}")
        _, nproc = self._world()
        self._multihost = nproc > 1
        self.cadence = CheckpointCadence(
            knobs.get("HOROVOD_CKPT_INTERVAL") if interval is None
            else interval,
            knobs.get("HOROVOD_CKPT_OVERHEAD_BUDGET")
            if overhead_budget is None else overhead_budget,
            frozen=self._multihost)
        self._m_inflight = M.gauge(
            "hvd_checkpoint_inflight",
            "Checkpoint writes currently draining on the worker thread")
        self._m_bytes = M.counter(
            "hvd_checkpoint_bytes",
            "Host bytes serialized into committed checkpoints")
        self._m_duration = M.histogram(
            "hvd_checkpoint_duration_seconds",
            "Snapshot-to-commit wall time per checkpoint (worker thread)")
        self._m_block = M.histogram(
            "hvd_checkpoint_block_seconds",
            "Step-path blocking cost per snapshot (device->host copy)")
        self._m_last_step = M.gauge(
            "hvd_checkpoint_last_step",
            "Step of the newest committed checkpoint", aggregation="leader")
        self._m_commits = M.counter(
            "hvd_checkpoint_commits_total", "Committed checkpoints")
        self._m_failures = M.counter(
            "hvd_checkpoint_failures_total",
            "Checkpoint attempts abandoned uncommitted "
            "(denied/timed out/failed)")
        self._m_deferred = M.counter(
            "hvd_checkpoint_deferred_total",
            "maybe_save calls skipped because a write was still inflight")
        self._m_interval = M.gauge(
            "hvd_checkpoint_interval_steps",
            "Effective checkpoint cadence in steps", aggregation="leader")
        self._m_interval.set(self.cadence.interval)
        self._pool = _PinnedPool()
        self._commit_kv = None             # the writer's own store client
        self.last_copy_seconds = 0.0       # device time of the last copy
        self._queue: "queue.Queue" = schedhooks.Queue()
        self._idle = schedhooks.Event()
        self._idle.set()
        self._last_save_step: Optional[int] = None
        self._last_error: Optional[BaseException] = None
        self._write_error: Optional[BaseException] = None
        self._closed = False
        self._worker = schedhooks.Thread(
            target=self._worker_loop, name="hvd-ckpt-writer", daemon=True)
        self._worker.start()

    # -- process identity ---------------------------------------------------
    @staticmethod
    def _world() -> Tuple[int, int]:
        return schedhooks.process_world()

    def _raise_write_error(self) -> None:
        err, self._write_error = self._write_error, None
        if err is not None:
            raise CheckpointWriteError(
                f"an async checkpoint write failed: {err}") from err

    # -- save paths ---------------------------------------------------------
    def reserve(self, state: Any) -> None:
        """Make the pinned buffer sets that ``maybe_save`` takes for
        ``state`` now, so that no such snapshot pays for pinned
        allocation on the step path: both sets on several ranks, whose
        saves queue behind a draining write, one set on one rank, which
        defers a save while a write drains (a save made then, such as
        the final synchronous one, makes the second set itself)."""
        owner = self._world()[0] == 0
        n = _PINNED_SETS if self._multihost else 1
        for idx in self._pool.free_sets()[:n]:
            _walk(state, _Copier(owner, self._pool, idx, copy=False))

    def maybe_save(self, step: int, state: Any) -> bool:
        """Interval-gated async save; returns True when a save started.
        Never blocks on a previous write: if one is still inflight the
        save is deferred to a later step (counted). A previous write that
        failed (other than an abandoned commit) raises here.

        Several ranks gate on step arithmetic (``step % interval == 0``)
        and then defer only together: every rank publishes whether it has
        a free buffer set and reads every other rank's answer, and the
        save is made only when all have one. The commit barrier needs
        every rank to make the SAME saves, so a rank-local condition must
        never decide alone."""
        self._raise_write_error()
        if self._closed or self.cadence.interval <= 0:
            return False
        if self._multihost:
            if step % self.cadence.interval != 0:
                return False
            ns = _attempt_namespace(self.directory, step)
            if not self._agree(ns, bool(self._pool.free_sets())):
                self._m_deferred.inc()
                return False
            self._save(step, state, ns)
            return True
        if self._last_save_step is not None \
                and step - self._last_save_step < self.cadence.interval:
            return False
        if not self._idle.is_set():
            self._m_deferred.inc()
            return False
        self._save(step, state, None)
        return True

    def _agree(self, ns: str, ready: bool) -> bool:
        """True when every rank is ``ready``: each writes its own answer
        (write-once) before reading the others', so all see the same
        answers and decide alike."""
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        kv = distributed_kv(site="checkpoint_commit")
        if kv is None:
            raise CheckpointCommitError(
                "a several-rank checkpoint needs the c10d store of the "
                "default process group, but torch.distributed is not "
                "initialized")
        pidx, nproc = self._world()
        kv.set(f"{ns}/ready/{pidx}", "1" if ready else "0")
        agreed = ready
        for p in range(nproc):
            if p == pidx:
                continue
            try:
                agreed &= kv.get(f"{ns}/ready/{p}",
                                 timeout_s=self.commit_timeout) == "1"
            except Exception as e:
                raise CheckpointCommitError(
                    f"rank {p} did not reach the save at {ns} within "
                    f"{self.commit_timeout}s") from e
        return agreed

    def save(self, step: int, state: Any, sync: bool = False) -> None:
        """Snapshot ``state`` at ``step``. The caller blocks only to issue
        the device->host copy unless ``sync=True`` (the preemption / final
        snapshot path: durable, committed or raised, on return). Every
        rank must make the same calls. With both buffer sets still
        draining, it first waits for the older write."""
        self._save(step, state, _attempt_namespace(self.directory, step)
                   if self._multihost else None, sync)

    def _save(self, step: int, state: Any, ns: Optional[str],
              sync: bool = False) -> None:
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._raise_write_error()
        from horovod_tpu_torch.tracing import spans as trace
        pidx, _ = self._world()
        t0 = time.perf_counter()
        with trace.span("checkpoint.snapshot", cat=trace.CAT_CHECKPOINT,
                        attrs={"step": step} if trace.enabled() else None):
            set_idx = self._pool.acquire()
            try:
                host, events = _snapshot(state, pidx == 0, self._pool,
                                         set_idx)
            except BaseException:
                self._pool.release(set_idx)
                raise
        block = time.perf_counter() - t0
        self._m_block.observe(block)
        # Goodput fold: the on-step-path cost is checkpoint time wherever
        # the caller sits (a no-op move inside train_loop's checkpoint
        # phase).
        from horovod_tpu_torch.goodput import accountant as _goodput
        _goodput.carve(_goodput.CHECKPOINT, block)
        if not events:
            self.cadence.observe_snapshot_cost(block)
            self._m_interval.set(self.cadence.interval)
        self._last_save_step = step
        self._idle.clear()
        self._m_inflight.set(1)
        self._queue.put(_Pending(step, host, events, set_idx, t0, block,
                                 ns))
        if sync:
            self.wait()
            # Judge THIS step by its committed manifest: an earlier async
            # attempt's failure must not mask a successful final snapshot.
            if step not in list_committed_steps(self.directory):
                err, self._last_error = self._last_error, None
                raise CheckpointCommitError(
                    f"synchronous checkpoint at step {step} failed: "
                    f"{err}") from err

    def wait(self) -> None:
        """Block until every queued write has committed or failed; a
        failed write (other than an abandoned commit) raises."""
        self._queue.join()
        self._idle.wait()
        self._raise_write_error()

    # -- worker thread ------------------------------------------------------
    def _worker_loop(self) -> None:
        from horovod_tpu_torch.resilience import chaos
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            try:
                copy_s = 0.0
                for start, end in item.events:
                    end.synchronize()        # the copy has landed
                    copy_s = max(copy_s, start.elapsed_time(end) / 1e3)
                if item.events:
                    self.last_copy_seconds = copy_s
                    self.cadence.observe_snapshot_cost(item.block + copy_s)
                    self._m_interval.set(self.cadence.interval)
                nbytes = self._write_and_commit(item)
                self._m_bytes.inc(nbytes)
                self._m_commits.inc()
                self._m_last_step.set(item.step)
                self._m_duration.observe(time.perf_counter() - item.t0)
                self._rotate(item.step)
            except Exception as e:           # report; the writer keeps on
                self._last_error = e
                self._m_failures.inc()
                abandoned = isinstance(e, (CheckpointCommitError,
                                           chaos.ChaosDenied))
                if not abandoned:
                    self._write_error = e
                logger.warning("checkpoint at step %d abandoned "
                               "uncommitted: %s", item.step, e)
            finally:
                item.host = None
                self._pool.release(item.set_idx)
                self._queue.task_done()
                if self._queue.unfinished_tasks == 0:
                    self._m_inflight.set(0)
                    self._idle.set()

    def _write_and_commit(self, item: _Pending) -> int:
        from horovod_tpu_torch.resilience import chaos
        from horovod_tpu_torch.tracing import spans as trace
        step, host = item.step, item.host
        pidx, nproc = self._world()
        fmt = "pickle"
        tmp = os.path.join(self.directory, _tmp_dirname(step))
        final = os.path.join(self.directory, step_dirname(step))
        # Transient-fs retry (resilience.faults.retry_fs): the tmp-dir
        # creation and both atomic renames absorb EIO-class hiccups under
        # the 'checkpoint_fs' policy; chaos fs_transient injects here.
        from horovod_tpu_torch.resilience import faults

        def _mk_tmp():
            chaos.on_fs("makedirs", tmp)
            os.makedirs(tmp, exist_ok=True)

        faults.retry_fs("checkpoint_fs", _mk_tmp)
        with trace.span("checkpoint.serialize", cat=trace.CAT_CHECKPOINT,
                        attrs={"step": step, "format": fmt}
                        if trace.enabled() else None):
            chunks = _serialize(host)
            digest = hashlib.sha256()
            nbytes = 0
            shard_path = os.path.join(tmp, f"shard-{pidx:05d}.pkl")
            with open(shard_path, "wb") as f:
                for chunk in chunks:
                    f.write(chunk)
                    digest.update(chunk)
                    nbytes += memoryview(chunk).nbytes
                f.flush()
                os.fsync(f.fileno())
            digests = [digest.hexdigest()]
            del chunks
        # Fault injection point: a chaos spec may delay the commit (the
        # slow-disk case) or deny it (the torn-write case) right before
        # the atomic rename; everything above is un-adopted tmp state.
        chaos.on_commit(step)
        with trace.span("checkpoint.commit", cat=trace.CAT_CHECKPOINT,
                        attrs={"step": step, "bytes": nbytes,
                               "multihost": nproc > 1}
                        if trace.enabled() else None):
            if nproc > 1:
                return self._commit_multihost(
                    item, tmp, final, fmt, digests[0], pidx, nproc, nbytes,
                    _count_per_rank(host))
            self._write_manifest(tmp, step, fmt, digests)
            self._publish(tmp, final)
        return nbytes

    @staticmethod
    def _publish(tmp: str, final: str) -> None:
        """The atomic commit. A committed directory for the same step
        (a resumed run re-reaching a step it saved before the
        interruption) already IS the durable snapshot of this state: drop
        the new attempt instead of failing the write."""
        if os.path.isdir(final) and read_manifest(final) is not None:
            shutil.rmtree(tmp, ignore_errors=True)
            return
        shutil.rmtree(final, ignore_errors=True)   # partial: replace

        def _rename():
            from horovod_tpu_torch.resilience import chaos
            chaos.on_fs("rename", final)
            schedhooks.rename(tmp, final)

        from horovod_tpu_torch.resilience import faults
        faults.retry_fs("checkpoint_fs", _rename)

    def _write_manifest(self, tmp: str, step: int, fmt: str,
                        digests: List[Optional[str]],
                        extra: Optional[Dict[str, Any]] = None) -> None:
        manifest = {
            "step": int(step),
            "format": fmt,
            "committed": True,
            "shards": len(digests),
            "shard_digests": digests,
            "wall_time": time.time(),
            **mesh_fingerprint(),
            **(extra or {}),
        }
        path = os.path.join(tmp, MANIFEST_NAME)
        with open(path + ".part", "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())

        def _rename():
            from horovod_tpu_torch.resilience import chaos
            chaos.on_fs("rename", path)
            schedhooks.rename(path + ".part", path)

        from horovod_tpu_torch.resilience import faults
        faults.retry_fs("checkpoint_fs", _rename)

    def _commit_multihost(self, item: _Pending, tmp: str, final: str,
                          fmt: str, digest: Optional[str], pidx: int,
                          nproc: int, nbytes: int, per_rank: int) -> int:
        """KV-store commit barrier: ranks other than 0 publish their shard
        digest and wait for rank 0's commit record; rank 0 collects every
        shard, writes the manifest, renames, then publishes. The namespace
        is the directory, the step and the attempt (the same on every
        rank). The writer waits on its own store connection: a c10d client
        runs one operation at a time, and the step path's store calls must
        not queue behind this barrier."""
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        if self._commit_kv is None:
            self._commit_kv = distributed_kv(site="checkpoint_commit",
                                             own_connection=True)
        kv = self._commit_kv
        if kv is None:
            raise CheckpointCommitError(
                f"{nproc}-rank checkpoint needs the c10d store of the "
                "default process group for its commit barrier, but "
                "torch.distributed is not initialized")
        ns = item.ns
        kv.set(f"{ns}/shard/{pidx}", digest or "", overwrite=True)
        if pidx != 0:
            try:
                kv.get(f"{ns}/committed", timeout_s=self.commit_timeout)
            except Exception as e:
                raise CheckpointCommitError(
                    f"rank 0 did not commit step {item.step} within "
                    f"{self.commit_timeout}s") from e
            return nbytes
        digests: List[Optional[str]] = [digest]
        per_rank_leaves = per_rank
        for p in range(1, nproc):
            try:
                digests.append(
                    kv.get(f"{ns}/shard/{p}",
                           timeout_s=self.commit_timeout))
            except Exception as e:
                raise CheckpointCommitError(
                    f"rank {p} did not write its shard for step "
                    f"{item.step} within {self.commit_timeout}s — "
                    f"checkpoint abandoned (uncommitted)") from e
        self._write_manifest(tmp, item.step, fmt, digests, {
            "layout": "rank0", "per_rank_leaves": per_rank_leaves})
        self._publish(tmp, final)
        kv.set(f"{ns}/committed", "1", overwrite=True)
        return nbytes

    def _rotate(self, committed_step: int) -> None:
        """Crash-safe rotation AFTER commit: drop committed checkpoints
        beyond newest-k and tmp orphans from older attempts. Only rank 0
        touches shared state (every rank sees the same list)."""
        pidx, _ = self._world()
        if pidx != 0 or self.max_to_keep is None or self.max_to_keep <= 0:
            return
        steps = list_committed_steps(self.directory)
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, step_dirname(s)),
                          ignore_errors=True)
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                try:
                    s = int(name[len(_TMP_PREFIX) + len(_STEP_PREFIX):])
                except ValueError:
                    continue
                if s < committed_step:
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_committed_step(self.directory)

    def all_steps(self) -> List[int]:
        self.wait()
        return list_committed_steps(self.directory)

    def restore_latest(self, template: Optional[Any] = None
                       ) -> Optional[Tuple[int, Any]]:
        """(step, state) from the newest committed checkpoint, or None
        when there is none. Partial/uncommitted directories are skipped.
        See module ``restore_latest`` for the topology validation rules."""
        self.wait()
        return restore_latest(self.directory, template=template)

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None) -> Any:
        self.wait()
        if step is None:
            got = restore_latest(self.directory, template=template)
            if got is None:
                raise FileNotFoundError(
                    f"no committed checkpoints in {self.directory}")
            return got[1]
        return restore_step(self.directory, step, template=template)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._worker.join(timeout=max(self.commit_timeout, 5) + 30)
        self._pool.clear()
        self._commit_kv = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# module-level restore (usable without an AsyncCheckpointer instance,
# e.g. by CheckpointManager)
# ---------------------------------------------------------------------------

def restore_step(directory: str, step: int,
                 template: Optional[Any] = None) -> Any:
    ckpt_dir = os.path.join(directory, step_dirname(step))
    manifest = read_manifest(ckpt_dir)
    if manifest is None:
        raise FileNotFoundError(
            f"no committed checkpoint for step {step} in {directory}")
    return _load(ckpt_dir, manifest, template)


def restore_latest(directory: str, template: Optional[Any] = None
                   ) -> Optional[Tuple[int, Any]]:
    """(step, state) from the newest committed checkpoint under
    ``directory``, or None when none exists. Uncommitted/partial
    directories are skipped, never errored on.

    Topology validation: the manifest's fingerprint must match the current
    world. A mismatched checkpoint whose shards are all identical, or whose
    rank 0 shard holds every leaf (the several-rank layout with no per-rank
    leaf), restores from shard 0 with a log line; any other mismatch (an
    error-feedback residual is per rank) raises CheckpointMismatchError
    naming the difference.
    """
    step = latest_committed_step(directory)
    if step is None:
        return None
    ckpt_dir = os.path.join(directory, step_dirname(step))
    manifest = read_manifest(ckpt_dir)
    if manifest is None:       # raced with rotation; rescan
        return restore_latest(directory, template=template)
    return step, _load(ckpt_dir, manifest, template)


def _load(ckpt_dir: str, manifest: Dict[str, Any],
          template: Optional[Any]) -> Any:
    mismatch = fingerprint_mismatch(manifest)
    fmt = manifest.get("format", "pickle")
    if fmt != "pickle":
        raise CheckpointMismatchError(
            f"checkpoint {ckpt_dir} is in the {fmt!r} format, which "
            f"horovod_tpu_torch does not read (it writes 'pickle')")
    pidx = schedhooks.process_world()[0]
    shard0 = os.path.join(ckpt_dir, "shard-00000.pkl")
    shard = os.path.join(ckpt_dir, f"shard-{pidx:05d}.pkl")
    if mismatch:
        digests = manifest.get("shard_digests") or []
        replicated = manifest.get("layout") == "rank0" \
            and manifest.get("per_rank_leaves") == 0
        if (len(set(digests)) == 1 and digests) or replicated:
            logger.info(
                "checkpoint %s topology changed (%s) but its state is "
                "replicated; restoring from shard 0", ckpt_dir, mismatch)
            shard = shard0
        else:
            raise CheckpointMismatchError(
                f"checkpoint {ckpt_dir} was saved under a different "
                f"topology ({mismatch}) with per-rank shard files; "
                f"restore it on the world that wrote it (the reshard path, "
                f"restore_checkpoint(template=...) of the JAX package's "
                f"orbax format, has no counterpart here)")
    if not os.path.exists(shard):
        shard = shard0
    host = _read_shard(shard)
    if shard != shard0:
        host = _merge_rank0(host, _read_shard(shard0))
    if template is None:
        return _unwrap(host)
    return _place_tree(host, template)
