"""Process-wide runtime of the port: init/shutdown, the rank/size queries,
the topology and the process groups of its axes.

The counterpart of ``horovod_tpu/runtime/context.py`` (l.92-251) over
``torch.distributed``. The unit of parallelism is the process, one per
card, as in the reference Horovod: ``size()`` is the number of processes,
``rank()`` this process's index among them and its position in the mesh
(``runtime/topology.py``).

``init`` joins the world the launcher describes (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` in the environment, with
``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` for the per-host view, as ``torchrun``
and ``hvdrun-torch`` set them). Without that environment it forms a world of one on an
in-process store, so a single process runs the same collective path. The
backend is NCCL for a CUDA device and gloo for ``device="cpu"``. A process
group the caller made before ``init`` is used as it is and outlives
``shutdown``.

**Groups.** A collective over an axis (or a tuple of axes) runs on the
process group of this rank's row along it. ``dist.new_group`` is itself a
collective of the whole world: every rank calls it, members or not, in the
same order with the same rank lists. So ``init`` builds, in a fixed order,
the groups of every axis of the mesh and of the axis tuples the
collectives use (``(hvd_cross, hvd_local)`` and ``(hvd_cross, hvd_dcn)``
where both exist, and the fast axes of a DCN mesh), and runs one small
collective on each of its own so that NCCL's communicators exist before
anything is timed. Other partitions (another axis tuple, the groups of a
size-uniform process-set partition) are built the first time a collective
needs them; that is safe because every rank makes the same calls in the
same order. A group of one rank has no process group: its collectives are
local. A group that fails to form raises.

``init`` also drives the goodput accountant's ``init`` phase
(``goodput/accountant.py``) and turns the span recorder on under
``HOROVOD_TRACE=1`` (``tracing/spans.py``), as the JAX ``init`` does. Not
ported yet: the timeline, the metrics server and the trace export and
merge at ``shutdown`` (ROADMAP A.13b).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime.topology import (CROSS_AXIS, DCN_AXIS,
                                                LOCAL_AXIS, AxisSpec,
                                                Topology, build_topology)
from horovod_tpu_torch.utils.device import resolve_device

_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

_lock = threading.RLock()
_context: Optional["Context"] = None


class NotInitializedError(RuntimeError):
    def __init__(self):
        super().__init__("horovod_tpu_torch has not been initialized; call "
                         "horovod_tpu_torch.init() first.")


class Group:
    """This rank's row of a partition: ``members`` are global ranks in
    the order of their index along the axes (or within the process set),
    ``index`` is this rank's position among them, and ``pg`` the process
    group over them (``None`` for a group of one). torch numbers a
    group's ranks in ascending global order; ``torch_order[j]`` is the
    position in ``members`` of torch's group rank j."""

    def __init__(self, members: Sequence[int], index: int, pg):
        self.members = tuple(int(m) for m in members)
        self.index = int(index)
        self.pg = pg
        self.size = len(self.members)
        ascending = sorted(self.members)
        self.torch_order = [self.members.index(m) for m in ascending]
        self.ordered = self.torch_order == list(range(self.size))

    def __repr__(self):
        return f"Group(members={self.members}, index={self.index})"


class Context:
    """What ``init`` set up: the device this process drives, the backend,
    the topology and its process groups, the per-host layout, and whether
    ``init`` created the default process group (and so ``shutdown``
    destroys it)."""

    def __init__(self, device: torch.device, backend: str,
                 topology: Topology, hosts: List[int], owns_group: bool):
        self.device = device
        self.backend = backend
        self.topology = topology
        self.hosts = hosts
        self.owns_group = owns_group
        self.process_set_table = None
        # the global set's join registry (eager.join): ranks that ran out
        # of data, in the order they joined
        self.joined_ranks: List[int] = []
        # sorted member tuple -> process group, for every group this
        # process took part in creating (members or not)
        self._pgs: Dict[Tuple[int, ...], object] = {}
        self._axis_groups: Dict[Tuple[str, ...], Group] = {}

    @property
    def size(self) -> int:
        return self.topology.size

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def local_size(self) -> int:
        """The mesh's ``hvd_local`` size, or the ranks on this host."""
        if LOCAL_AXIS in self.topology.mesh.shape:
            return self.topology.local_size
        return self.hosts.count(self.hosts[self.rank])

    @property
    def local_rank(self) -> int:
        return self.rank % self.local_size

    @property
    def cross_size(self) -> int:
        return max(self.size // self.local_size, 1)

    @property
    def cross_rank(self) -> int:
        return self.rank // self.local_size

    # -- process groups --------------------------------------------------

    def ensure_partition(self, partition: Sequence[Sequence[int]]
                         ) -> Optional[object]:
        """Create the process group of every group of ``partition`` not
        created yet, in order (every rank must call this with the same
        partition); returns the one holding this rank, ``WORLD`` for the
        whole world, None for a group of one or when this rank is in
        none."""
        me, mine = self.rank, None
        for group in partition:
            key = tuple(sorted(int(r) for r in group))
            if len(key) == self.size:
                pg = dist.group.WORLD
            elif len(key) == 1:
                pg = None
            else:
                pg = self._pgs.get(key)
                if key not in self._pgs:
                    pg = dist.new_group(list(key))
                    if me in key and (pg is None or pg ==
                                      dist.GroupMember.NON_GROUP_MEMBER):
                        raise RuntimeError(
                            f"process group over ranks {list(key)} failed "
                            f"to form on rank {me}")
                    self._pgs[key] = pg
                    if me in key:
                        self._warm(pg)
            if me in key:
                mine = pg
        return mine

    def _warm(self, pg) -> None:
        # NCCL makes a communicator at a group's first collective
        dist.all_reduce(torch.zeros(1, device=self.device), group=pg)

    def axis_group(self, axis: AxisSpec) -> Group:
        """This rank's group along ``axis`` (see :class:`Group`)."""
        axes = self.topology.resolve_axes(axis)
        g = self._axis_groups.get(axes)
        if g is None:
            partition = self.topology.axis_groups(axes)
            pg = self.ensure_partition(partition)
            row = next(p for p in partition if self.rank in p)
            g = Group(row, row.index(self.rank), pg)
            self._axis_groups[axes] = g
        return g

    def subgroup(self, members: Sequence[int], partition=None
                 ) -> Optional[Group]:
        """The group over the global ranks ``members`` (in that order),
        creating the process groups of ``partition`` (default: just
        ``members``) first; None when this rank is not a member."""
        self.ensure_partition(partition or [members])
        if self.rank not in members:
            return None
        key = tuple(sorted(members))
        pg = (dist.group.WORLD if len(key) == self.size
              else None if len(key) == 1 else self._pgs[key])
        return Group(members, list(members).index(self.rank), pg)

    def build_groups(self) -> None:
        """The groups of every axis and of the axis tuples the collectives
        use, in a fixed order (the same on every rank)."""
        topo = self.topology
        axes = list(topo.flat_axes)
        tuples = [(a,) for a in axes]
        if CROSS_AXIS in axes and LOCAL_AXIS in axes:
            tuples.append((CROSS_AXIS, LOCAL_AXIS))
        if CROSS_AXIS in axes and DCN_AXIS in axes:
            tuples.append((CROSS_AXIS, DCN_AXIS))
        if topo.has_dcn and len(topo.ici_axes) > 1:
            tuples.append(topo.ici_axes)
        tuples.append(topo.flat_axes)           # the world: no new group
        for t in dict.fromkeys(tuples):
            self.axis_group(t)

    def destroy_groups(self) -> None:
        for pg in self._pgs.values():
            if pg is not None and pg != dist.GroupMember.NON_GROUP_MEMBER:
                dist.destroy_process_group(pg)
        self._pgs.clear()
        self._axis_groups.clear()


def _gather_hosts(dev: torch.device, local_rank: int) -> List[int]:
    """Host index of every rank: a new host starts at each rank whose
    LOCAL_RANK is 0."""
    world = dist.get_world_size()
    if world == 1:
        return [0]
    mine = torch.tensor([local_rank], dtype=torch.int64, device=dev)
    out = torch.empty(world, dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(out, mine)
    hosts, h = [], -1
    for lr in out.tolist():
        h += 1 if (lr == 0 or h < 0) else 0
        hosts.append(h)
    return hosts


def init(device="cuda", backend: Optional[str] = None,
         mesh_shape: Optional[Sequence[int]] = None,
         axis_names: Optional[Sequence[str]] = None,
         hierarchical: Optional[bool] = None,
         dcn: Optional[int] = None) -> Context:
    """Initialize the runtime (idempotent: a second call returns the
    context of the first). ``device="cuda"`` raises without a GPU; with
    several cards on a host, each process takes card ``LOCAL_RANK``
    (modulo the cards it sees). ``HVD_TPU_FORCE_CPU=1`` in the environment
    (``hvdrun-torch --virtual``) makes a ``device="cuda"`` init take the
    CPU; that variable is the only way it does so.
    ``mesh_shape``, ``axis_names``, ``hierarchical`` and ``dcn`` shape the
    topology as in the JAX package's ``init``; every rank must pass the
    same ones."""
    global _context
    with _lock:
        if _context is not None:
            return _context
        from horovod_tpu_torch.goodput import accountant as _goodput
        from horovod_tpu_torch.tracing import spans as _spans
        _goodput.init_begin()
        _spans.init_from_env()
        if os.environ.get("HVD_TPU_FORCE_CPU") == "1" and \
                torch.device(device).type == "cuda":
            device = "cpu"
        dev = resolve_device(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        launched = all(k in os.environ for k in _LAUNCH_ENV)
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda",
                                   local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        owns = not dist.is_initialized()
        if owns:
            if launched:
                dist.init_process_group(backend, init_method="env://")
            else:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
        hosts = _gather_hosts(dev, local_rank)
        topology = build_topology(dist.get_world_size(), mesh_shape,
                                  axis_names, hierarchical, dcn, hosts)
        ctx = Context(dev, backend, topology, hosts, owns)
        ctx.build_groups()
        from horovod_tpu_torch.parallel import process_sets
        process_sets._attach(ctx)
        _context = ctx
        _goodput.init_end()
        return _context


def shutdown() -> None:
    """Tear the runtime down; ``init`` works again afterwards."""
    global _context
    with _lock:
        if _context is None:
            return
        if dist.is_initialized():
            if _context.owns_group:
                dist.destroy_process_group()
            else:
                _context.destroy_groups()
        _context = None


def is_initialized() -> bool:
    return _context is not None


def get_context() -> Context:
    if _context is None:
        raise NotInitializedError()
    return _context


def size() -> int:
    return get_context().size


def rank() -> int:
    return get_context().rank


def local_size() -> int:
    return get_context().local_size


def local_rank() -> int:
    return get_context().local_rank


def cross_size() -> int:
    return get_context().cross_size


def cross_rank() -> int:
    return get_context().cross_rank


def mesh():
    """The ranks on the named mesh (``topology.Mesh``)."""
    return get_context().topology.mesh


def is_homogeneous() -> bool:
    """True when every host holds the same number of ranks."""
    hosts = get_context().hosts
    return len({hosts.count(h) for h in set(hosts)}) <= 1
