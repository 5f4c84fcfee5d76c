"""Process sets of the PyTorch port against the JAX package, on the CPU.

The registry (ids, validation, ``axis_index_groups``) and the group tables
(``_resolve_groups``, ``_uniform_partition_groups``) are compared in one
process with the JAX package's for the same registered sets. The
collectives over process sets run in one spawned 4-rank gloo world
(``test_torch_workers.phase_worker``): on a flat mesh, on a (2, 2) mesh,
and with HOROVOD_TORUS_ALLREDUCE=1, each against the JAX in-jit function
under shard_map on ``jax.devices()[:4]`` with the same sets registered
(``hvd.init(devices=...)``). The cases replay
``tests/test_process_sets.py`` at four ranks. Tolerances: data movement
and MIN/MAX bitwise; f32 SUM/AVERAGE 1e-6 relative to the largest value
of each rank's result.
"""

import numpy as np
import pytest

import jax

import horovod_tpu as hvd
from horovod_tpu.ops import collectives as JC
from horovod_tpu.runtime.topology import CROSS_AXIS, LOCAL_AXIS
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.parallel import process_sets as PS
from test_torch_collectives import _jax_per_rank
import test_torch_workers as workers

W = 4
# registered in this order on both sides (ids 1..8)
FLAT_SETS = [[0, 1], [2, 3], [1, 2, 3], [0, 2], [1, 3], [0, 1, 2],
             [0, 2, 3], [1, 2]]
MESH2_SETS = [[1, 2], [0, 3], [2, 3]]
TORUS_SETS = [[0, 3]]


class _FakeContext:
    """What the registry needs of a context: size, rank, and the group
    creation (a no-op here)."""

    def __init__(self, size, rank=0):
        self.size, self.rank = size, rank

    def ensure_partition(self, partition):
        return None


def _port_table(sets, world=W, rank=0):
    table = PS.ProcessSetTable(_FakeContext(world, rank))
    g = PS.ProcessSet(list(range(world)))
    g.process_set_id, g._table = 0, table
    table._by_id[0] = g
    return table, [table.add(PS.ProcessSet(r)) for r in sets]


@pytest.fixture()
def jax4():
    ctx = hvd.init(devices=jax.devices()[:W])
    yield ctx
    hvd.shutdown()


# ---------------------------------------------------------------------------
# the registry, in one process
# ---------------------------------------------------------------------------

def test_registry_ids_sizes_and_ranks():
    table, (ps,) = _port_table([[0, 2]], rank=2)
    assert ps.process_set_id == 1 and ps.size() == 2
    assert table.ids() == [0, 1] and table.get(1) is ps
    assert ps.rank() == 1 and ps.included()
    _, (other,) = _port_table([[1, 3]], rank=2)
    assert other.rank() == -1 and not other.included()
    table.remove(ps)
    assert table.ids() == [0]


def test_registry_rejects_what_the_jax_package_rejects(jax4):
    table, _ = _port_table([[1, 3]])
    with pytest.raises(ValueError, match="already exists"):
        table.add(PS.ProcessSet([3, 1]))
    for bad in ([0, 99], [], [1, 1]):
        with pytest.raises(ValueError):
            table.add(PS.ProcessSet(bad))
        with pytest.raises(ValueError):
            hvd.add_process_set(bad)
    with pytest.raises(ValueError):
        table.remove(table.get(0))
    with pytest.raises(ValueError, match="not registered"):
        PS.ProcessSet([0]).size()


def test_tables_equal_the_jax_package_tables(jax4):
    """axis_index_groups, _resolve_groups and _uniform_partition_groups
    (or the NotImplementedError) for every registered set, flat sets
    including two competing partitions (halves and even/odd)."""
    _, port_sets = _port_table(FLAT_SETS)
    jax_sets = [hvd.add_process_set(r) for r in FLAT_SETS]
    for ps, jps in zip(port_sets, jax_sets):
        assert ps.process_set_id == jps.process_set_id
        assert ps.axis_index_groups() == jps.axis_index_groups()
        pg, psize, prank = C._resolve_groups(ps)
        jg, jsize, jrank = JC._resolve_groups(jps, "hvd")
        assert pg == jg
        np.testing.assert_array_equal(psize, np.asarray(jsize))
        np.testing.assert_array_equal(prank, np.asarray(jrank))
        try:
            want = JC._uniform_partition_groups(jps, "allgather")
        except NotImplementedError:
            # a ragged set: the JAX eager layer's host-mediated path runs
            # in the set's own group, the other ranks on their own
            want = jps.axis_index_groups()
        assert C._uniform_partition_groups(ps, "allgather") == want
    assert C._resolve_groups(None) == (None, None, None)
    assert C._uniform_partition_groups(None, "alltoall") is None


# ---------------------------------------------------------------------------
# collectives over process sets, in a 4-rank world
# ---------------------------------------------------------------------------

def _x():
    return np.arange(W, dtype=np.float32).reshape(W, 1)


def _rows():
    return np.stack([np.full((2,), r, np.float32) for r in range(W)])


def _a2a():
    x = np.zeros((W, 2, 2), np.float32)
    for r in range(W):
        for d in range(2):
            x[r, d] = r * 10 + d
    return x


def _rs():
    return np.random.RandomState(0).randn(W, 4, 2).astype(np.float32)


def _flat_scenarios():
    x, rows = _x(), _rows()
    sc = [dict(name="ar_sum_01", fn="allreduce", args=[x], ps=0,
               kw={"op": "SUM"}),
          dict(name="ar_avg_23", fn="allreduce", args=[x], ps=1,
               kw={"op": "AVERAGE"}),
          dict(name="ar_min_023", fn="allreduce", args=[x], ps=6,
               kw={"op": "MIN"}),
          dict(name="ar_max_023", fn="allreduce", args=[x], ps=6,
               kw={"op": "MAX"}),
          dict(name="ar_prod_123", fn="allreduce", args=[x + 1], ps=2,
               kw={"op": "PRODUCT"}),
          dict(name="ag_01", fn="allgather", args=[rows], ps=0),
          dict(name="ag_02", fn="allgather", args=[rows], ps=3),
          dict(name="bc_123", fn="broadcast", args=[x], ps=2,
               kw={"root_rank": 1}),
          dict(name="a2a_01", fn="alltoall", args=[_a2a()], ps=0),
          dict(name="a2a_13", fn="alltoall", args=[_a2a()], ps=4),
          dict(name="rs_13", fn="reducescatter", args=[_rs()], ps=4,
               kw={"op": "SUM"}),
          dict(name="rs_01_avg", fn="reducescatter", args=[_rs()], ps=0,
               kw={"op": "AVERAGE"}),
          dict(name="ag_ragged", fn="allgather", args=[rows], ps=5),
          dict(name="ag_unaligned", fn="allgather", args=[rows], ps=7),
          dict(name="rs_min_subgroup", fn="reducescatter", args=[_rs()],
               ps=0, kw={"op": "MIN"}, raises=True),
          dict(name="barrier_123", fn="barrier", ps=2)]
    return sc


def _mesh2_scenarios():
    x, rows = _x(), _rows()
    return [dict(name="m2_ar_12", fn="allreduce", args=[x], ps=0,
                 kw={"op": "SUM"}),
            dict(name="m2_avg_03", fn="allreduce", args=[x], ps=1,
                 kw={"op": "AVERAGE"}),
            dict(name="m2_min_12", fn="allreduce", args=[x], ps=0,
                 kw={"op": "MIN"}),
            dict(name="m2_bc_12", fn="broadcast", args=[x], ps=0,
                 kw={"root_rank": 1}),
            dict(name="m2_ag_23", fn="allgather", args=[rows], ps=2),
            dict(name="m2_local_axis", fn="allreduce", args=[x], ps=0,
                 kw={"axis": LOCAL_AXIS}, raises=True)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    phases = [dict(sets=FLAT_SETS, scenarios=_flat_scenarios()),
              dict(init={"mesh_shape": (2, 2)}, sets=MESH2_SETS,
                   scenarios=_mesh2_scenarios()),
              dict(knobs={"HOROVOD_TORUS_ALLREDUCE": True}, sets=TORUS_SETS,
                   scenarios=[dict(kind="topology", name="torus_topo"),
                              dict(name="torus_ar_03", fn="allreduce",
                                   args=[_x()], ps=0, kw={"op": "SUM"}),
                              dict(name="torus_hier", fn="torus_allreduce",
                                   args=[np.tile(_x()[:, :, None],
                                                 (1, 2, 1))],
                                   kw={"op": "AVERAGE"})])]
    load = workers.run_phases(W, phases, tmp_path_factory.mktemp("psets"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


def _check(world, name, want, exact=True):
    for r in range(W):
        got = world(name, r)["out0"]
        if exact:
            np.testing.assert_array_equal(got, want[r], err_msg=f"{name} "
                                          f"rank {r}")
        else:
            scale = float(np.max(np.abs(want[r])))
            np.testing.assert_allclose(got, want[r], rtol=0,
                                       atol=1e-6 * scale,
                                       err_msg=f"{name} rank {r}")


def _jax_cases(sets, mesh_shape=None):
    """The JAX side's registered sets and mesh for one phase."""
    hvd.init(devices=jax.devices()[:W], mesh_shape=mesh_shape)
    return [hvd.add_process_set(r) for r in sets], hvd.mesh()


def _axes(mesh):
    return tuple(mesh.axis_names)


FLAT_CASES = [("ar_sum_01", 0, "allreduce", dict(op=hvd.Sum), "x", False),
              ("ar_avg_23", 1, "allreduce", dict(op=hvd.Average), "x",
               False),
              ("ar_min_023", 6, "allreduce", dict(op=hvd.Min), "x", True),
              ("ar_max_023", 6, "allreduce", dict(op=hvd.Max), "x", True),
              ("ar_prod_123", 2, "allreduce", dict(op=hvd.Product), "x1",
               False),
              ("ag_01", 0, "allgather", {}, "rows", True),
              ("ag_02", 3, "allgather", {}, "rows", True),
              ("bc_123", 2, "broadcast", dict(root_rank=1), "x", True),
              ("a2a_01", 0, "alltoall", {}, "a2a", True),
              ("a2a_13", 4, "alltoall", {}, "a2a", True),
              ("rs_13", 4, "reducescatter", dict(op=hvd.Sum), "rs", False),
              ("rs_01_avg", 0, "reducescatter", dict(op=hvd.Average), "rs",
               False)]
INPUTS = {"x": _x, "x1": lambda: _x() + 1, "rows": _rows, "a2a": _a2a,
          "rs": _rs}


@pytest.mark.parametrize("case", FLAT_CASES, ids=[c[0] for c in FLAT_CASES])
def test_collectives_over_process_sets(world, case):
    """Members act together, non-members keep their own value; the
    shape-changing ops run in each rank's group of the size-uniform
    partition (contiguous chunks, or the registered even/odd family)."""
    name, ps_i, fn, kw, inp, exact = case
    try:
        jsets, mesh = _jax_cases(FLAT_SETS)
        want = _jax_per_rank(lambda v: getattr(JC, fn)(
            v, process_set=jsets[ps_i], axis=_axes(mesh), **kw),
            INPUTS[inp](), mesh)
    finally:
        hvd.shutdown()
    _check(world, name, want, exact)


def test_ragged_and_unaligned_sets_raise_as_in_jit(world):
    """A ragged ([0, 1, 2]) or unaligned ([1, 2]) set, which the JAX
    in-jit layer rejects (tests/test_process_sets.py::test_injit_subgroup_
    ragged_still_rejected and ..._unaligned_contiguous_rejected), gathers
    in the set's own group as the JAX eager layer's host-mediated path
    does: members get the eager result, other ranks their own rows. A
    subgroup MIN reducescatter still raises as the JAX package's in-jit
    op does."""
    rows = _rows()
    try:
        hvd.init(devices=jax.devices()[:W])
        jsets = [hvd.add_process_set(r) for r in FLAT_SETS]
        for name, i in (("ag_ragged", 5), ("ag_unaligned", 7)):
            want = np.asarray(hvd.allgather(rows, process_set=jsets[i]))
            for r in range(W):
                got = world(name, r)["out0"]
                np.testing.assert_array_equal(
                    got, want if r in FLAT_SETS[i] else rows[r],
                    err_msg=f"{name} rank {r}")
    finally:
        hvd.shutdown()
    for r in range(W):
        err = str(world("rs_min_subgroup", r)["error"])
        assert err.startswith("NotImplementedError"), err


def test_barrier_over_a_process_set(world):
    for r in range(W):
        world("barrier_123", r)


MESH2_CASES = [("m2_ar_12", 0, "allreduce", dict(op=hvd.Sum), "x", False),
               ("m2_avg_03", 1, "allreduce", dict(op=hvd.Average), "x",
                False),
               ("m2_min_12", 0, "allreduce", dict(op=hvd.Min), "x", True),
               ("m2_bc_12", 0, "broadcast", dict(root_rank=1), "x", True),
               ("m2_ag_23", 2, "allgather", {}, "rows", True)]


@pytest.mark.parametrize("case", MESH2_CASES, ids=[c[0] for c in MESH2_CASES])
def test_process_sets_on_a_2x2_mesh(world, case):
    """Sets index the ranks linearized over (cross, local), so members may
    straddle both cross groups (tests/test_process_sets.py::*_2d)."""
    name, ps_i, fn, kw, inp, exact = case
    try:
        jsets, mesh = _jax_cases(MESH2_SETS, mesh_shape=(2, 2))
        assert _axes(mesh) == (CROSS_AXIS, LOCAL_AXIS)
        want = _jax_per_rank(lambda v: getattr(JC, fn)(
            v, process_set=jsets[ps_i], axis=_axes(mesh), **kw),
            INPUTS[inp](), mesh)
    finally:
        hvd.shutdown()
    _check(world, name, want, exact)
    err = str(world("m2_local_axis", 0)["error"])
    assert err.startswith("ValueError") and "every rank" in err


def test_subgroup_allreduce_composes_with_torus(world, monkeypatch):
    """HOROVOD_TORUS_ALLREDUCE=1 makes the topology (cross, local), and a
    subgroup allreduce and the torus allreduce both work on it."""
    from horovod_tpu.config import knobs as jknobs
    monkeypatch.setenv("HOROVOD_TORUS_ALLREDUCE", "1")
    # An override left in this process would win over the environment:
    # tests/test_faults.py's autotune follower (ParameterSynchronizer.apply)
    # sets every tuned knob, these two among them, and leaves them set.
    for name in ("HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_TORUS_ALLREDUCE"):
        jknobs.clear_override(name)
    try:
        ctx = hvd.init(devices=jax.devices()[:W])
        assert ctx.topology.is_hierarchical
        shape = tuple(ctx.topology.mesh.devices.shape)
        jps = hvd.add_process_set([0, 3])
        mesh = hvd.mesh()
        want = _jax_per_rank(lambda v: JC.allreduce(
            v, op=hvd.Sum, process_set=jps, axis=_axes(mesh)), _x(), mesh)
    finally:
        hvd.shutdown()
    topo = world("torus_topo", 0)
    assert str(topo["flat_axes"]) == f"{CROSS_AXIS},{LOCAL_AXIS}"
    assert tuple(topo["shape"]) == shape
    _check(world, "torus_ar_03", want, exact=False)
    for r in range(W):
        np.testing.assert_allclose(world("torus_hier", r)["out0"],
                                   np.full((2, 1), 1.5), rtol=1e-6)
