"""Rank topology of the port: the named mesh the collectives reduce over.

The counterpart of ``horovod_tpu/runtime/topology.py`` (l.37-310). The
JAX package lays its chips out on a named ``jax.sharding.Mesh``; here the
unit is the process (one per card), and the mesh is the ranks
``0 .. W-1`` laid out row-major over the axis sizes, outermost axis
first: rank r sits at ``np.unravel_index(r, shape)``, which is the JAX
package's linearization of ``_mesh_device_order`` for devices in rank
order. Axis names, knobs and resolution order are the JAX package's:

- default: one axis ``hvd`` over every rank;
- ``hierarchical=True`` (or HOROVOD_HIERARCHICAL_ALLREDUCE /
  HOROVOD_TORUS_ALLREDUCE): ``(hvd_cross, hvd_local)`` with local = the
  ranks per host (``LOCAL_WORLD_SIZE`` under torchrun), or a balanced
  factor on one host;
- ``dcn=k`` (or HOROVOD_DCN_MESH / HOROVOD_DCN_VIRTUAL_SLICES): the slow
  ``hvd_dcn`` tier outermost, ``(hvd_dcn, hvd_cross, hvd_local)`` when the
  in-slice block splits, else ``(hvd_dcn, hvd_local)``. GPUs have no
  slices, so only the knobs or ``dcn=`` make one;
- an explicit ``mesh_shape``/``axis_names`` (or HOROVOD_TPU_MESH_SHAPE /
  HOROVOD_TPU_MESH_AXES) wins over everything.

``hosts[r]`` is the host of rank r (the JAX devices' ``process_index``);
``runtime.context.init`` gathers it from every rank's ``LOCAL_RANK``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger

HVD_AXIS = "hvd"
LOCAL_AXIS = "hvd_local"
CROSS_AXIS = "hvd_cross"
DCN_AXIS = "hvd_dcn"

AxisSpec = Union[str, Tuple[str, ...]]


class Mesh:
    """The ranks laid out over named axes: ``devices`` is the array of
    ranks with the mesh's shape, ``shape`` maps each axis name to its size
    (outermost first), as ``jax.sharding.Mesh`` has them."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(int(np.prod(shape))).reshape(tuple(shape))
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape})"


@dataclasses.dataclass(frozen=True)
class Topology:
    """Resolved topology: ``mesh`` carries every rank, ``flat_axes`` its
    axis names outermost first."""
    mesh: Mesh
    flat_axes: Tuple[str, ...]

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def local_size(self) -> int:
        return self.mesh.shape.get(LOCAL_AXIS, self.size)

    @property
    def cross_size(self) -> int:
        return self.mesh.shape.get(CROSS_AXIS, 1)

    @property
    def dcn_size(self) -> int:
        """Slices along the DCN tier (1 = none)."""
        return self.mesh.shape.get(DCN_AXIS, 1)

    @property
    def has_dcn(self) -> bool:
        return DCN_AXIS in self.mesh.shape

    @property
    def ici_axes(self) -> Tuple[str, ...]:
        """The fast axes: flat_axes without the DCN tier."""
        return tuple(a for a in self.flat_axes if a != DCN_AXIS)

    @property
    def is_hierarchical(self) -> bool:
        return len(self.flat_axes) > 1

    # -- rank arithmetic (the JAX package's axis_index / axis_index_groups)

    def resolve_axes(self, axis: AxisSpec) -> Tuple[str, ...]:
        """The axis names ``axis`` stands for. ``hvd`` names every rank:
        on a mesh without an ``hvd`` axis it stands for all of
        ``flat_axes`` (what the JAX package's eager layer reduces over).
        Raises ``NameError`` for a name the mesh does not have, as an
        unbound axis name does inside ``shard_map``."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        out: List[str] = []
        for a in axes:
            names = (self.flat_axes if a == HVD_AXIS
                     and HVD_AXIS not in self.mesh.shape else (a,))
            for n in names:
                if n not in self.mesh.shape:
                    raise NameError(
                        f"unbound axis name: {n!r} (the mesh has "
                        f"{self.flat_axes})")
                if n in out:
                    raise ValueError(f"axis {n!r} named twice in {axes}")
                out.append(n)
        return tuple(out)

    def axis_size(self, axis: AxisSpec) -> int:
        return int(np.prod([self.mesh.shape[a]
                            for a in self.resolve_axes(axis)]))

    def coords(self, rank: int) -> Dict[str, int]:
        idx = np.unravel_index(int(rank), self.mesh.devices.shape)
        return {a: int(i) for a, i in zip(self.flat_axes, idx)}

    def axis_rank(self, rank: int, axis: AxisSpec) -> int:
        """Rank ``rank``'s index along ``axis``: row-major over the named
        axes in the order given (the JAX ``axis_rank``)."""
        c = self.coords(rank)
        r = 0
        for a in self.resolve_axes(axis):
            r = r * self.mesh.shape[a] + c[a]
        return r

    def axis_groups(self, axis: AxisSpec) -> List[List[int]]:
        """The partition of the ranks into the groups a collective over
        ``axis`` reduces within: one group per position along the other
        axes (row-major), each listing its ranks by their ``axis_rank``."""
        axes = self.resolve_axes(axis)
        dev = self.mesh.devices
        others = [a for a in self.flat_axes if a not in axes]
        order = [self.flat_axes.index(a) for a in others + list(axes)]
        moved = np.transpose(dev, order)
        n = self.axis_size(axes)
        return [[int(r) for r in row] for row in moved.reshape(-1, n)]


def _balanced_factor(n: int, prefer: Optional[int] = None) -> int:
    """Largest factor of n that is <= sqrt(n); with ``prefer`` (ranks
    per host) a factor dividing it wins, so the local axis tiles whole
    hosts (the JAX package's rule, l.286-310)."""
    candidates = [f for f in range(2, n) if n % f == 0]
    if prefer and prefer > 1:
        aligned = [f for f in candidates if prefer % f == 0]
        if aligned:
            below = [f for f in aligned if f * f <= n]
            return max(below) if below else min(aligned)
    best = 1
    for f in range(2, int(math.isqrt(n)) + 1):
        if n % f == 0:
            best = f
    return best


def infer_local_size(hosts: Sequence[int]) -> int:
    """Ranks per host, from ``hosts[r]`` (rank r's host); 1 with a warning
    when hosts hold different numbers of ranks."""
    counts: Dict[int, int] = {}
    for h in hosts:
        counts[int(h)] = counts.get(int(h), 0) + 1
    sizes = set(counts.values())
    if len(sizes) == 1:
        return sizes.pop()
    get_logger("horovod_tpu_torch.topology").warning(
        "heterogeneous rank/host layout — per-host rank counts %s have no "
        "uniform local size; treating local_size as 1 (no local mesh "
        "axis). Hierarchical/torus collectives will fall back to a "
        "balanced split that ignores host boundaries.",
        dict(sorted(counts.items())))
    return 1


def infer_slice_count(world: int = 0) -> int:
    """Slices of the DCN tier: HOROVOD_DCN_VIRTUAL_SLICES when >= 2, else
    1 (a GPU has no slice index; HOROVOD_DCN_MESH wins over both, in
    :func:`build_topology`)."""
    virtual = int(knobs.get("HOROVOD_DCN_VIRTUAL_SLICES") or 0)
    return virtual if virtual > 1 else 1


def _resolve_dcn_shape(hosts: Sequence[int], n: int, dcn: Optional[int]
                       ) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """``(n_slices, in_slice_shape)`` of a DCN-tiered mesh, or None.
    HOROVOD_DCN_MESH > ``dcn=`` > HOROVOD_DCN_VIRTUAL_SLICES; the in-slice
    block splits into (cross, local) when a balanced factor exists."""
    env_mesh = str(knobs.get("HOROVOD_DCN_MESH") or "").strip()
    if env_mesh:
        shape = tuple(int(s) for s in env_mesh.split(",") if s)
        if len(shape) not in (2, 3):
            raise ValueError(
                f"HOROVOD_DCN_MESH={env_mesh!r}: expected 'dcn,local' or "
                f"'dcn,cross,local' (slice-major)")
        if int(np.prod(shape)) != n:
            raise ValueError(
                f"HOROVOD_DCN_MESH={env_mesh!r} does not cover {n} ranks")
        if shape[0] < 2:
            raise ValueError(
                f"HOROVOD_DCN_MESH={env_mesh!r}: the leading (DCN) dim "
                f"must be >= 2 — a single slice needs no DCN axis")
        return shape[0], shape[1:]
    n_slices = int(dcn) if dcn else infer_slice_count(n)
    if n_slices <= 1:
        return None
    if n % n_slices != 0:
        raise ValueError(
            f"{n} ranks do not split into {n_slices} equal slices "
            f"(dcn={dcn}, HOROVOD_DCN_VIRTUAL_SLICES="
            f"{knobs.get('HOROVOD_DCN_VIRTUAL_SLICES')})")
    m = n // n_slices
    local = infer_local_size(hosts[:m])
    if local in (1, m) or m % local != 0:
        local = _balanced_factor(m, prefer=local)
    if 1 < local < m and m % local == 0:
        return n_slices, (m // local, local)
    return n_slices, (m,)


def build_topology(world: int = 1, mesh_shape: Optional[Sequence[int]] = None,
                   axis_names: Optional[Sequence[str]] = None,
                   hierarchical: Optional[bool] = None,
                   dcn: Optional[int] = None,
                   hosts: Optional[Sequence[int]] = None) -> Topology:
    """The topology of ``world`` ranks (see the module docstring for the
    resolution order). ``hosts`` defaults to one host for every rank."""
    n = int(world)
    hosts = list(hosts) if hosts is not None else [0] * n
    if len(hosts) != n:
        raise ValueError(f"hosts has {len(hosts)} entries for {n} ranks")

    env_shape = knobs.get("HOROVOD_TPU_MESH_SHAPE")
    if mesh_shape is None and env_shape:
        mesh_shape = tuple(int(s) for s in env_shape.split(",") if s)
        env_axes = knobs.get("HOROVOD_TPU_MESH_AXES")
        if axis_names is None and env_axes:
            axis_names = tuple(a.strip() for a in env_axes.split(",")
                               if a.strip())
    if hierarchical is None:
        hierarchical = (knobs.get("HOROVOD_HIERARCHICAL_ALLREDUCE")
                        or knobs.get("HOROVOD_TORUS_ALLREDUCE"))

    if mesh_shape is not None:
        shape = tuple(int(s) for s in mesh_shape)
        if int(np.prod(shape)) != n:
            raise ValueError(f"mesh_shape {shape} does not cover {n} ranks")
        if axis_names is None:
            if len(shape) == 1:
                axis_names = (HVD_AXIS,)
            elif len(shape) == 2:
                axis_names = (CROSS_AXIS, LOCAL_AXIS)
            else:
                axis_names = tuple(f"hvd_{i}" for i in range(len(shape)))
        if len(axis_names) != len(shape):
            raise ValueError("axis_names length must match mesh_shape length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis_names {tuple(axis_names)} repeat a name")
        return Topology(Mesh(shape, axis_names), tuple(axis_names))

    dcn_shape = _resolve_dcn_shape(hosts, n, dcn)
    if dcn_shape is not None:
        n_slices, in_slice = dcn_shape
        names = (DCN_AXIS,) + ((CROSS_AXIS, LOCAL_AXIS)
                               if len(in_slice) == 2 else (LOCAL_AXIS,))
        return Topology(Mesh((n_slices,) + tuple(in_slice), names), names)

    if hierarchical and n > 1:
        local = infer_local_size(hosts)
        if local in (1, n):
            local = _balanced_factor(n, prefer=local)
        if local > 1 and n % local == 0 and local != n:
            names = (CROSS_AXIS, LOCAL_AXIS)
            return Topology(Mesh((n // local, local), names), names)

    return Topology(Mesh((n,), (HVD_AXIS,)), (HVD_AXIS,))
