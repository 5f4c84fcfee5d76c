"""The PyTorch port's topology and runtime context against the JAX
package, on the CPU.

``runtime.topology.build_topology`` is held against the JAX package's on
the same number of devices: axis names and shape for the flat, (2, 4),
(2, 2) and (dcn 2, cross 2, local 2) meshes and the knobs and arguments
that make them, and for each axis tuple every rank's index along it and
its group's members, against what ``lax.axis_index`` and
``lax.all_gather`` give under ``shard_map`` (the JAX linearization). The
cases replay ``tests/test_context.py:42-77`` and the topology part of
``tests/test_dcn_tier.py`` (l.78-160). One spawned 4-rank gloo world
(``test_torch_workers.phase_worker``) checks the context's queries and
the process groups ``init`` builds on a flat mesh, a (2, 2) mesh and a
hierarchical one of two hosts. Everything here is exact.
"""

import itertools
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from horovod_tpu.config import knobs as jknobs
from horovod_tpu.eager import shard_map
from horovod_tpu.ops import collectives as JC
from horovod_tpu.runtime import topology as JT
import horovod_tpu_torch as htt
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.runtime import topology as T
from horovod_tpu_torch.runtime.context import NotInitializedError
import test_torch_workers as workers

W = 4


@pytest.fixture()
def override():
    """Set a knob in both packages for one test, always cleared."""
    touched = []

    def set_(name, value):
        knobs.set_override(name, value)
        jknobs.set_override(name, value)
        touched.append(name)

    yield set_
    for name in touched:
        knobs.clear_override(name)
        jknobs.clear_override(name)


def _axis_tuples(names):
    """Every axis alone and every ordered tuple of two or more."""
    out = []
    for k in range(1, len(names) + 1):
        out += list(itertools.permutations(names, k))
    return out


def _jax_tables(topo, axes):
    """(index along ``axes``, members of the group) per mesh position,
    from lax.axis_index / lax.all_gather under shard_map."""
    mesh = topo.mesh
    names = tuple(mesh.axis_names)
    n = mesh.devices.size

    def per_shard(a):
        v = a[0]
        return (JC.axis_rank(axes)[None],
                lax.all_gather(v, axes, axis=0, tiled=False)[None])

    f = jax.jit(shard_map(per_shard, mesh=mesh, in_specs=P(names),
                          out_specs=(P(names), P(names))))
    idx, members = f(jnp.arange(n, dtype=jnp.int32))
    return np.asarray(idx), np.asarray(members)


def _assert_same_topology(port, jtopo):
    assert port.flat_axes == jtopo.flat_axes
    assert port.mesh.shape == dict(jtopo.mesh.shape)
    for prop in ("size", "local_size", "cross_size", "dcn_size", "has_dcn",
                 "ici_axes", "is_hierarchical"):
        assert getattr(port, prop) == getattr(jtopo, prop), prop
    for axes in _axis_tuples(port.flat_axes):
        idx, members = _jax_tables(jtopo, axes)
        groups = port.axis_groups(axes)
        assert sorted(r for g in groups for r in g) == list(range(port.size))
        for r in range(port.size):
            assert port.axis_rank(r, axes) == idx[r], (axes, r)
            row = next(g for g in groups if r in g)
            assert row == list(members[r]), (axes, r)
            assert row.index(r) == idx[r]


CASES = {
    "flat8": (8, {}, {}),
    "2x4": (8, {"mesh_shape": (2, 4)}, {}),
    "2x2": (4, {"mesh_shape": (2, 2)}, {}),
    "hierarchical8": (8, {"hierarchical": True}, {}),
    "dcn2x2x2": (8, {}, {"HOROVOD_DCN_VIRTUAL_SLICES": 2}),
    "dcn2x2": (4, {"dcn": 2}, {}),
    "dcn_mesh_2x4": (8, {}, {"HOROVOD_DCN_MESH": "2,4"}),
    "env_4x2": (8, {}, {"HOROVOD_TPU_MESH_SHAPE": "4,2"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_topology_tables_equal_the_jax_package(case, override):
    n, kw, knob = CASES[case]
    for k, v in knob.items():
        override(k, v)
    port = T.build_topology(n, **kw)
    jtopo = JT.build_topology(devices=jax.devices()[:n], **kw)
    _assert_same_topology(port, jtopo)
    np.testing.assert_array_equal(port.mesh.devices.reshape(-1),
                                  np.arange(n))


def test_default_explicit_and_env_meshes():
    """tests/test_context.py:42-77."""
    topo = T.build_topology(8)
    assert topo.flat_axes == (T.HVD_AXIS,) and topo.size == 8
    assert not topo.is_hierarchical
    topo = T.build_topology(8, mesh_shape=(2, 4))
    assert topo.flat_axes == (T.CROSS_AXIS, T.LOCAL_AXIS)
    assert (topo.local_size, topo.cross_size) == (4, 2)
    assert topo.is_hierarchical
    with pytest.raises(ValueError):
        T.build_topology(8, mesh_shape=(3, 4))
    topo = T.build_topology(8, hierarchical=True)
    assert topo.is_hierarchical and topo.local_size * topo.cross_size == 8


def test_hierarchical_local_axis_follows_the_hosts():
    """Two hosts of four ranks: local = 4, one host a row."""
    topo = T.build_topology(8, hierarchical=True, hosts=[0] * 4 + [1] * 4)
    assert topo.mesh.shape == {T.CROSS_AXIS: 2, T.LOCAL_AXIS: 4}
    assert topo.axis_groups(T.LOCAL_AXIS) == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_dcn_knobs_and_arguments(override):
    """tests/test_dcn_tier.py::TestDcnTopology, on the port."""
    override("HOROVOD_DCN_VIRTUAL_SLICES", 2)
    topo = T.build_topology(8)
    assert topo.flat_axes == (T.DCN_AXIS, T.CROSS_AXIS, T.LOCAL_AXIS)
    assert topo.has_dcn and topo.dcn_size == 2
    assert topo.ici_axes == (T.CROSS_AXIS, T.LOCAL_AXIS)
    override("HOROVOD_DCN_MESH", "2,4")
    assert T.build_topology(8).flat_axes == (T.DCN_AXIS, T.LOCAL_AXIS)
    override("HOROVOD_DCN_MESH", "2,2,2")
    assert T.build_topology(8).flat_axes == (T.DCN_AXIS, T.CROSS_AXIS,
                                             T.LOCAL_AXIS)
    override("HOROVOD_DCN_MESH", "3,3")
    with pytest.raises(ValueError, match="does not cover"):
        T.build_topology(8)
    override("HOROVOD_DCN_MESH", "1,8")
    with pytest.raises(ValueError, match="DCN"):
        T.build_topology(8)
    override("HOROVOD_DCN_MESH", "")
    override("HOROVOD_DCN_VIRTUAL_SLICES", 0)
    topo = T.build_topology(8, dcn=4)
    assert topo.dcn_size == 4 and topo.flat_axes[0] == T.DCN_AXIS
    with pytest.raises(ValueError, match="equal slices"):
        T.build_topology(8, dcn=3)


def test_slices_come_only_from_the_knobs(override):
    """A GPU has no slice index: one slice unless
    HOROVOD_DCN_VIRTUAL_SLICES (or HOROVOD_DCN_MESH, or dcn=) says
    otherwise."""
    assert T.infer_slice_count(8) == 1
    override("HOROVOD_DCN_VIRTUAL_SLICES", 2)
    assert T.infer_slice_count(8) == 2
    override("HOROVOD_DCN_VIRTUAL_SLICES", 1)
    assert T.infer_slice_count(8) == 1


def test_infer_local_size_heterogeneous_warns():
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    h = _Capture()
    logging.getLogger("horovod_tpu_torch").addHandler(h)
    try:
        assert T.infer_local_size([0, 0, 1]) == 1
        assert T.infer_local_size([0, 0, 1, 1]) == 2
    finally:
        logging.getLogger("horovod_tpu_torch").removeHandler(h)
    assert any("heterogeneous" in m and "{0: 2, 1: 1}" in m
               for m in records), records


@pytest.mark.parametrize("n,prefer", [(24, None), (24, 6), (24, 1),
                                      (24, 24), (8, None), (16, 9),
                                      (10, 5), (12, 4), (36, 6)])
def test_balanced_factor_matches_the_jax_package(n, prefer):
    assert T._balanced_factor(n, prefer) == JT._balanced_factor(n, prefer)


def test_axis_names_resolve_as_in_shard_map():
    topo = T.build_topology(4, mesh_shape=(2, 2))
    assert topo.resolve_axes("hvd") == (T.CROSS_AXIS, T.LOCAL_AXIS)
    assert topo.axis_size("hvd") == 4
    with pytest.raises(NameError, match="unbound axis"):
        topo.resolve_axes("dp")
    with pytest.raises(ValueError, match="twice"):
        topo.resolve_axes((T.LOCAL_AXIS, T.LOCAL_AXIS))


def test_queries_need_init_and_init_is_idempotent():
    with pytest.raises(NotInitializedError):
        htt.size()
    ctx = htt.init(device="cpu")
    try:
        assert htt.init(device="cpu") is ctx
        assert htt.mesh().devices.size == 1 and htt.is_homogeneous()
        assert htt.global_process_set.size() == 1
        assert htt.global_process_set.included()
        assert htt.process_set_ids() == [0]
    finally:
        htt.shutdown()
    assert not htt.is_initialized()
    htt.init(device="cpu", mesh_shape=(1, 1))
    try:
        assert htt.mesh().shape == {T.CROSS_AXIS: 1, T.LOCAL_AXIS: 1}
    finally:
        htt.shutdown()


# ---------------------------------------------------------------------------
# a 4-rank world
# ---------------------------------------------------------------------------

MESH2_AXES = _axis_tuples((T.CROSS_AXIS, T.LOCAL_AXIS)) + [("hvd",)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    phases = [
        dict(env={"LOCAL_RANK": "{rank}"},
             scenarios=[dict(kind="topology", name="flat",
                             axes=[("hvd",)])]),
        dict(init={"mesh_shape": (2, 2)},
             scenarios=[dict(kind="topology", name="mesh2",
                             axes=MESH2_AXES)]),
        dict(env={"LOCAL_RANK": [0, 1, 0, 1]}, init={"hierarchical": True},
             scenarios=[dict(kind="topology", name="hosts2",
                             axes=[(T.LOCAL_AXIS,), (T.CROSS_AXIS,)])])]
    load = workers.run_phases(W, phases, tmp_path_factory.mktemp("topo"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


def test_context_queries_on_one_host(world):
    """tests/test_context.py::test_init_basic at four ranks on one host:
    size, rank, local size and rank, cross size and rank, homogeneous."""
    for r in range(W):
        res = world("flat", r)
        assert list(res["queries"]) == [W, r, W, r, 1, 0, 1]
        assert str(res["flat_axes"]) == "hvd"
        assert list(res["members|hvd"]) == list(range(W))


def test_groups_of_a_2x2_mesh_equal_the_jax_tables(world):
    jtopo = JT.build_topology(devices=jax.devices()[:W], mesh_shape=(2, 2))
    for axes in MESH2_AXES:
        key = ",".join(axes)
        if axes == ("hvd",):
            idx, members = np.arange(W), np.tile(np.arange(W), (W, 1))
        else:
            idx, members = _jax_tables(jtopo, axes)
        for r in range(W):
            res = world("mesh2", r)
            assert list(res[f"members|{key}"]) == list(members[r]), key
            assert int(res[f"index|{key}"]) == idx[r], key
        assert list(world("mesh2", 1)["queries"])[2:6] == [2, 1, 2, 0]


def test_two_hosts_make_the_local_axis(world):
    """LOCAL_RANK 0,1,0,1: two hosts of two ranks, so the hierarchical
    topology is (cross 2, local 2) with a host a row."""
    for r in range(W):
        res = world("hosts2", r)
        assert str(res["flat_axes"]) == f"{T.CROSS_AXIS},{T.LOCAL_AXIS}"
        assert list(res["queries"]) == [W, r, 2, r % 2, 2, r // 2, 1]
        assert list(res[f"members|{T.LOCAL_AXIS}"]) == [r // 2 * 2,
                                                         r // 2 * 2 + 1]
