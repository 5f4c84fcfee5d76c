"""Collectives and tensor fusion of the PyTorch port, on the CPU.

The collectives run once, in a two-process gloo world
(``test_torch_workers.collectives_worker``); each test below checks one
part of what the ranks wrote against numpy reductions over the
rank-stacked inputs, which is what the JAX package's eager API returns
for the same stacked array. Fusion is compared with a per-tensor apply
and with the JAX package's grouping of the same tree. Tolerances: 1e-6
relative for f32 sums of two values (exact up to the scale factors).
"""

import numpy as np
import pytest
import torch

import jax

from horovod_tpu.ops import fusion as jfusion
import horovod_tpu_torch as htt
from horovod_tpu_torch.ops import collectives, fusion
import test_torch_workers as workers

WORLD = 2
REDUCE = {"Sum": lambda x: x.sum(0), "Average": lambda x: x.mean(0),
          "Min": lambda x: x.min(0), "Max": lambda x: x.max(0),
          "Product": lambda x: x.prod(0)}


@pytest.fixture(scope="module")
def world_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    workers.join_world(workers.start_world(workers.collectives_worker,
                                           WORLD, str(out)))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("op", sorted(REDUCE))
def test_allreduce_ops_with_pre_and_postscale(world_results, op):
    x, _, _ = workers.collective_inputs(WORLD)
    want = REDUCE[op](x)
    # prescale 0.5 on every input, postscale 3 on the result
    scaled = REDUCE[op](x * np.float32(0.5)) * np.float32(3.0)
    for r, res in enumerate(world_results):
        np.testing.assert_allclose(res[op], want, rtol=1e-6,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res[op + "_scaled"], scaled, rtol=1e-6,
                                   err_msg=f"rank {r} scaled")
        assert res[op].dtype == np.float32


def test_allreduce_of_integers(world_results):
    _, ints, _ = workers.collective_inputs(WORLD)
    for res in world_results:
        np.testing.assert_array_equal(res["int_sum"], ints.sum(0))
        assert res["int_sum"].dtype == np.int32
        np.testing.assert_allclose(res["int_average"], ints.mean(0),
                                   rtol=1e-6)


def test_grouped_allreduce_on_mixed_dtypes(world_results):
    _, _, mixed = workers.collective_inputs(WORLD)
    for res in world_results:
        for i, a in enumerate(mixed):
            np.testing.assert_allclose(res[f"grouped_{i}"], a.sum(0),
                                       rtol=1e-6)
            assert res[f"grouped_{i}"].dtype == a.dtype
            assert res[f"grouped_{i}"].shape == a.shape[1:]


def test_broadcast_from_the_last_rank(world_results):
    x, _, _ = workers.collective_inputs(WORLD)
    for res in world_results:
        np.testing.assert_array_equal(res["broadcast"], x[WORLD - 1])


def test_collectives_need_init_and_refuse_adasum():
    from horovod_tpu_torch.runtime import NotInitializedError
    with pytest.raises(NotInitializedError):
        htt.allreduce(torch.ones(2))
    htt.init(device="cpu")
    try:
        # Adasum of one rank is its own tensor (the butterfly has no level)
        assert htt.allreduce(torch.arange(3.0), op=collectives.ReduceOp.
                             ADASUM).tolist() == [0.0, 1.0, 2.0]
        with pytest.raises(ValueError, match="Unsupported reduce op"):
            htt.allreduce(torch.ones(2), op=9)
        t = torch.ones(3)
        assert htt.allreduce(t, htt.Sum, postscale_factor=2.0).tolist() == [
            2.0] * 3 and t.tolist() == [1.0] * 3        # input untouched
        with pytest.raises(TypeError, match="in place"):
            collectives.allreduce_(torch.ones(2, dtype=torch.int32))
    finally:
        htt.shutdown()


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------

def _mixed_tensors():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(3, 4, generator=g),
            torch.randn(5, generator=g).double(),
            torch.randn(2, 2, 2, generator=g),
            torch.randint(0, 9, (6,), generator=g),
            torch.randn(1, generator=g).bfloat16()]


def test_fuse_apply_matches_per_tensor_apply_on_mixed_dtypes():
    xs = _mixed_tensors()
    calls = []

    def fn(buf):
        calls.append((buf.dtype, buf.numel()))
        return buf * 3 + 1

    out = fusion.fuse_apply(fn, xs)
    for o, x in zip(out, xs):
        assert o.shape == x.shape and o.dtype == x.dtype
        torch.testing.assert_close(o, x * 3 + 1)
    # one call per dtype; the two f32 tensors share one buffer of 12 + 8
    assert sorted(calls, key=str) == sorted(
        [(torch.float32, 20), (torch.float64, 5), (torch.int64, 6),
         (torch.bfloat16, 1)], key=str)
    assert fusion.fuse_apply(fn, []) == []


def test_batch_d2d_memcopies_off_takes_the_per_tensor_path(monkeypatch):
    xs = _mixed_tensors()
    calls = []
    make_fn = lambda axes: (lambda b: calls.append(b.shape) or b * 2)  # noqa
    monkeypatch.setenv("HOROVOD_BATCH_D2D_MEMCOPIES", "0")
    out = fusion.fused_group_apply({str(i): x for i, x in enumerate(xs)},
                                   ("dp",), make_fn)
    assert sorted(calls, key=str) == sorted((x.shape for x in xs), key=str)
    torch.testing.assert_close(out["2"], xs[2] * 2)
    calls.clear()
    monkeypatch.setenv("HOROVOD_BATCH_D2D_MEMCOPIES", "1")
    fusion.fused_group_apply({str(i): x for i, x in enumerate(xs)},
                             ("dp",), make_fn)
    assert len(calls) == 4                           # one per dtype


def test_flatten_and_unflatten_round_trip():
    xs = [torch.arange(6.0).reshape(2, 3), torch.ones(4), torch.zeros(1, 1)]
    buf, specs = fusion.flatten_for_fusion(xs)
    assert buf.shape == (11,) and specs == [((2, 3), 6), ((4,), 4),
                                            ((1, 1), 1)]
    for a, b in zip(fusion.unflatten_from_fusion(buf, specs), xs):
        torch.testing.assert_close(a, b)
    with pytest.raises(ValueError, match="uniform dtype"):
        fusion.flatten_for_fusion([torch.ones(2), torch.ones(2).double()])


def test_grouping_matches_the_jax_package():
    """Coarse axes over a subtree, filtered falsy names and leaf order are
    the JAX package's, on the same tree."""
    tree = {"b": {"y": np.ones(2), "x": np.ones(3)}, "a": np.ones(1),
            "c": np.ones(4)}
    axes = {"b": ("dp", None), "a": ("dp", "tp"), "c": ()}
    _, j_leaves, j_groups = jfusion.group_leaves_by_axes(tree, axes)
    ttree = jax.tree.map(torch.from_numpy, tree)
    _, leaves, groups = fusion.group_leaves_by_axes(ttree, axes)
    assert groups == j_groups == {("dp", "tp"): [0], ("dp",): [1, 2],
                                  (): [3]}
    assert [t.numel() for t in leaves] == [a.size for a in j_leaves]
    with pytest.raises(ValueError):
        fusion.group_leaves_by_axes(ttree, {"b": ("dp",)})
    out = fusion.apply_by_groups(ttree, axes, lambda ls, ax: [
        t + len(ax) for t in ls])
    assert out["a"].tolist() == [3.0] and out["c"].tolist() == [1.0] * 4
    assert out["b"]["x"].tolist() == [2.0] * 3


# ---------------------------------------------------------------------------
# allgather, alltoall, reducescatter, ppermute, broadcast over axes, the
# hierarchical allreduce and the sparse allreduce: one 4-rank gloo world
# (test_torch_workers.phase_worker) against the JAX package's functions
# under shard_map on jax.devices()[:4], or its eager layer (hvd.init on
# the same 4 devices) for the uneven forms. The cases replay
# tests/test_collectives.py:142-314 and 341-420 at four ranks.
# Tolerances: data movement, integer sums and MIN/MAX bitwise; f32
# SUM/AVERAGE 1e-6 relative to the largest value of each rank's result.
# ---------------------------------------------------------------------------

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import horovod_tpu as hvd  # noqa: E402
from horovod_tpu.eager import shard_map  # noqa: E402
from horovod_tpu.ops import collectives as JC  # noqa: E402
from horovod_tpu.ops import sparse as jsparse  # noqa: E402
from horovod_tpu.runtime.topology import CROSS_AXIS, LOCAL_AXIS  # noqa

W4 = 4
WIDE = ["float32", "int32", "uint8", "bool", "bfloat16"]


def _rng(seed):
    return np.random.RandomState(seed)


def _alltoall_parts(splits):
    parts = []
    for r in range(W4):
        part = np.zeros((int(splits[r].sum()), 2), np.float32)
        off = 0
        for d in range(W4):
            part[off:off + splits[r, d]] = r * 100 + d
            off += splits[r, d]
        parts.append(part)
    return parts


def _sparse_inputs(nnz):
    rng = _rng(5)
    vals = [rng.randn(n, 2).astype(np.float32) for n in nnz]
    idx = [rng.randint(0, 6, n).astype(np.int64) for n in nnz]
    return vals, idx


def _wide(dtype):
    x = _rng(0).randint(0, 2, (W4, W4))
    return x.astype(np.bool_) if dtype == "bool" else (
        x.astype(np.float32) if dtype == "bfloat16" else x.astype(dtype))


def _inputs():
    rng = _rng(11)
    splits = rng.randint(0, 4, (W4, W4))
    return {
        "ag": rng.randn(W4, 2, 3).astype(np.float32),
        "ag_uneven": [rng.randn(r + 1, 2).astype(np.float32)
                      for r in range(W4)],
        "a2a": rng.randn(W4, W4 * 2, 3).astype(np.float32),
        "splits": splits, "a2a_parts": _alltoall_parts(splits),
        "rs": rng.randn(W4, W4 * 2, 3).astype(np.float32),
        "rs_uneven": rng.randn(W4, W4 + 3, 2).astype(np.float32),
        "rs_int": rng.randint(-50, 50, (W4, W4 * 2, 2)).astype(np.int32),
        "pp": rng.randn(W4, 3, 2).astype(np.float32),
        "mesh2": rng.randn(W4, 4, 3).astype(np.float32),
    }


RING = [(i, (i + 1) % W4) for i in range(W4)]
PARTIAL = [(0, 2), (2, 0), (1, 1)]
AXES_2D = {"local": LOCAL_AXIS, "cross": CROSS_AXIS,
           "cross_local": (CROSS_AXIS, LOCAL_AXIS),
           "local_cross": (LOCAL_AXIS, CROSS_AXIS)}


def _flat_scenarios(x):
    sc = [dict(name="ag", fn="allgather", args=[x["ag"]]),
          dict(name="ag_uneven", fn="allgather", args=[x["ag_uneven"]]),
          dict(name="a2a", fn="alltoall", args=[x["a2a"]]),
          dict(name="a2a_splits", fn="alltoall", args=[x["a2a_parts"]],
               rank_kw={"splits": [list(s) for s in x["splits"]]}),
          dict(name="rs_uneven", fn="reducescatter", args=[x["rs_uneven"]],
               kw={"op": "SUM"}),
          dict(name="rs_uneven_max", fn="reducescatter",
               args=[x["rs_uneven"]], kw={"op": "MAX"}),
          dict(name="rs_int", fn="reducescatter", args=[x["rs_int"]],
               kw={"op": "SUM"}),
          dict(name="pp_ring", fn="ppermute", args=[x["pp"]],
               kw={"perm": RING}),
          dict(name="pp_partial", fn="ppermute", args=[x["pp"]],
               kw={"perm": PARTIAL}),
          dict(name="bc3", fn="broadcast", args=[x["pp"]],
               kw={"root_rank": 3})]
    sc += [dict(name=f"rs_{op}", fn="reducescatter", args=[x["rs"]],
                kw={"op": op.upper()})
           for op in ("sum", "average", "min", "max")]
    for dt in WIDE:
        w = _wide(dt)
        tdt = "bfloat16" if dt == "bfloat16" else None
        sc += [dict(name=f"wide_ag_{dt}", fn="allgather", args=[w],
                    dtype=tdt),
               dict(name=f"wide_bc_{dt}", fn="broadcast", args=[w],
                    kw={"root_rank": 3}, dtype=tdt),
               dict(name=f"wide_a2a_{dt}", fn="alltoall", args=[w],
                    dtype=tdt)]
    vals, idx = _sparse_inputs([3] * W4)
    uvals, uidx = _sparse_inputs([1, 4, 0, 2])
    for avg in (True, False):
        sc.append(dict(name=f"sparse_{avg}", fn="sparse_allreduce",
                       args=[vals, idx], kw={"dense_first_dim": 6,
                                             "average": avg}))
    sc.append(dict(name="sparse_uneven", fn="sparse_allreduce",
                   args=[uvals, uidx], kw={"dense_first_dim": 6}))
    return sc


def _mesh2_scenarios(x):
    sc = []
    for tag, axes in AXES_2D.items():
        sc += [dict(name=f"m2_ar_{tag}", fn="allreduce", args=[x["mesh2"]],
                    kw={"op": "SUM", "axis": axes}),
               dict(name=f"m2_ag_{tag}", fn="allgather", args=[x["mesh2"]],
                    kw={"axis": axes}),
               dict(name=f"m2_a2a_{tag}", fn="alltoall", args=[x["mesh2"]],
                    kw={"axis": axes}),
               dict(name=f"m2_rs_{tag}", fn="reducescatter",
                    args=[x["mesh2"]], kw={"op": "SUM", "axis": axes})]
    sc += [dict(name=f"m2_hier_{op}", fn=fn, args=[x["mesh2"]],
                kw={"op": op.upper()})
           for op, fn in (("sum", "hierarchical_allreduce"),
                          ("average", "torus_allreduce"))]
    sc.append(dict(name="m2_pp_local", fn="ppermute", args=[x["mesh2"]],
                   kw={"perm": [(0, 1), (1, 0)], "axis": LOCAL_AXIS}))
    sc.append(dict(name="m2_ag_hier", fn="allgather", args=[x["mesh2"]],
                   kw={"axis": AXES_2D["cross_local"]},
                   knobs={"HOROVOD_HIERARCHICAL_ALLGATHER": True}))
    sc.append(dict(name="m2_hier_indivisible", fn="hierarchical_allreduce",
                   args=[x["rs_uneven"]], raises=True))
    return sc


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    x = _inputs()
    phases = [dict(scenarios=_flat_scenarios(x)),
              dict(init={"mesh_shape": (2, 2)},
                   scenarios=_mesh2_scenarios(x))]
    load = workers.run_phases(W4, phases, tmp_path_factory.mktemp("coll4"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


def _jax_mesh(shape=(W4,), names=("hvd",)):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def _jax_per_rank(fn, x, mesh):
    """``fn`` on each device's row of the rank-stacked ``x`` (dim 0 over
    every mesh axis, row-major): the stacked per-device results."""
    names = mesh.axis_names
    f = jax.jit(shard_map(lambda a: fn(a[0])[None], mesh=mesh,
                          in_specs=P(names), out_specs=P(names)))
    return np.asarray(f(jnp.asarray(x)))


def _port(world4, name, key="out0"):
    return [world4(name, r)[key] for r in range(W4)]


def _same(port, want, what):
    for r in range(W4):
        np.testing.assert_array_equal(port[r], want[r], err_msg=f"{what} "
                                      f"rank {r}")


def _close(port, want, what, rtol=1e-6):
    """Within ``rtol`` of the largest value of the rank's result (sums in
    another order differ in their last bits, which an element near zero
    shows as a large relative error)."""
    for r in range(W4):
        scale = float(np.max(np.abs(want[r]))) if np.size(want[r]) else 0.
        np.testing.assert_allclose(port[r], want[r], rtol=0,
                                   atol=rtol * scale,
                                   err_msg=f"{what} rank {r}")


@pytest.fixture()
def jax_ctx4():
    ctx = hvd.init(devices=jax.devices()[:W4])
    yield ctx
    hvd.shutdown()


def test_allgather_even_and_uneven(world4, jax_ctx4):
    x = _inputs()
    _same(_port(world4, "ag"), _jax_per_rank(JC.allgather, x["ag"],
                                             _jax_mesh()), "allgather")
    want = np.asarray(hvd.allgather(x["ag_uneven"]))
    _same(_port(world4, "ag_uneven"), [want] * W4, "allgatherv")


def test_alltoall_even_and_splits(world4, jax_ctx4):
    x = _inputs()
    _same(_port(world4, "a2a"), _jax_per_rank(JC.alltoall, x["a2a"],
                                              _jax_mesh()), "alltoall")
    outs, recv = hvd.alltoall(x["a2a_parts"], splits=x["splits"])
    for r in range(W4):
        res = world4("a2a_splits", r)
        np.testing.assert_array_equal(res["out0"], np.asarray(outs[r]))
        np.testing.assert_array_equal(res["out1"], np.asarray(recv)[r])
        np.testing.assert_array_equal(res["out1"], x["splits"][:, r])


@pytest.mark.parametrize("op", ["sum", "average", "min", "max"])
def test_reducescatter_ops(world4, op):
    x = _inputs()
    jop = getattr(hvd, op.capitalize())
    want = _jax_per_rank(lambda v: JC.reducescatter(v, op=jop), x["rs"],
                         _jax_mesh())
    port = _port(world4, f"rs_{op}")
    if op in ("min", "max"):
        _same(port, want, f"reducescatter {op}")
    else:
        _close(port, want, f"reducescatter {op}")


def test_reducescatter_uneven_and_integer(world4, jax_ctx4):
    """rows % W = 3: the first three ranks take one more row
    (tests/test_collectives.py::test_reducescatter_uneven)."""
    x = _inputs()
    for name, op in (("rs_uneven", hvd.Sum), ("rs_uneven_max", hvd.Max)):
        outs = hvd.reducescatter(x["rs_uneven"], op=op)
        port = _port(world4, name)
        assert [p.shape[0] for p in port] == [2, 2, 2, 1]
        (_same if op == hvd.Max else _close)(
            port, [np.asarray(o) for o in outs], name)
    want = _jax_per_rank(lambda v: JC.reducescatter(v, op=hvd.Sum),
                         x["rs_int"], _jax_mesh())
    port = _port(world4, "rs_int")
    _same(port, want, "int reducescatter")
    assert port[0].dtype == np.int32


@pytest.mark.parametrize("name,perm", [("pp_ring", RING),
                                       ("pp_partial", PARTIAL)])
def test_ppermute(world4, name, perm):
    """Ranks no pair sends to receive zeros, as lax.ppermute gives them."""
    x = _inputs()
    want = _jax_per_rank(lambda v: JC.ppermute(v, perm), x["pp"],
                         _jax_mesh())
    _same(_port(world4, name), want, name)


def test_broadcast_from_rank_3(world4):
    x = _inputs()
    want = _jax_per_rank(lambda v: JC.broadcast(v, root_rank=3), x["pp"],
                         _jax_mesh())
    _same(_port(world4, "bc3"), want, "broadcast")


@pytest.mark.parametrize("dtype", WIDE)
def test_movement_of_every_dtype(world4, dtype):
    """tests/test_collectives.py::test_allgather_broadcast_alltoall_wide_
    dtypes: the bytes move unchanged, in the tensor's own dtype."""
    w = _wide(dtype)
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bfloat16" else None)
    mesh = _jax_mesh()
    for kind, fn in (("ag", JC.allgather),
                     ("bc", lambda v: JC.broadcast(v, root_rank=3)),
                     ("a2a", JC.alltoall)):
        want = np.asarray(_jax_per_rank(fn, jw, mesh), np.float64)
        port = _port(world4, f"wide_{kind}_{dtype}")
        _same([np.asarray(p, np.float64) for p in port], want,
              f"{kind} {dtype}")
        assert str(world4(f"wide_{kind}_{dtype}", 0)["dtype"]) == \
            f"torch.{'bool' if dtype == 'bool' else dtype}"


@pytest.mark.parametrize("avg", [True, False])
def test_sparse_allreduce_matches_jax(world4, jax_ctx4, avg):
    vals, idx = _sparse_inputs([3] * W4)
    dense, counts = jsparse.sparse_allreduce(
        jnp.asarray(np.stack(vals)), jnp.asarray(np.stack(idx), jnp.int32),
        6, average=avg)
    for r in range(W4):
        res = world4(f"sparse_{avg}", r)
        np.testing.assert_allclose(res["out0"], np.asarray(dense),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(res["out1"], np.asarray(counts))


def test_sparse_allreduce_of_uneven_nnz(world4):
    vals, idx = _sparse_inputs([1, 4, 0, 2])
    dense = np.zeros((6, 2), np.float32)
    counts = np.zeros(6, np.int32)
    for v, i in zip(vals, idx):
        np.add.at(dense, i, v)
        np.add.at(counts, i, 1)
    for r in range(W4):
        res = world4("sparse_uneven", r)
        np.testing.assert_allclose(res["out0"], dense / W4, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(res["out1"], counts)


@pytest.mark.parametrize("tag", sorted(AXES_2D))
def test_collectives_over_axes_of_a_2x2_mesh(world4, tag):
    """Over one axis, both, and both in the other order (the groups'
    members then run in the axis order, not the global one;
    tests/test_collectives.py::test_alltoall_on_2d_mesh and friends)."""
    x = _inputs()["mesh2"]
    axes = AXES_2D[tag]
    mesh = _jax_mesh((2, 2), (CROSS_AXIS, LOCAL_AXIS))
    for kind, fn, check in (
            ("ar", lambda v: JC.allreduce(v, op=hvd.Sum, axis=axes), _close),
            ("ag", lambda v: JC.allgather(v, axis=axes), _same),
            ("a2a", lambda v: JC.alltoall(v, axis=axes), _same),
            ("rs", lambda v: JC.reducescatter(v, op=hvd.Sum, axis=axes),
             _close)):
        check(_port(world4, f"m2_{kind}_{tag}"), _jax_per_rank(fn, x, mesh),
              f"{kind} over {axes}")


def test_hierarchical_and_torus_allreduce(world4):
    """reduce-scatter(local) -> allreduce(cross) -> allgather(local)
    against JAX's in-jit composite and the flat sum
    (tests/test_collectives.py::test_torus_allreduce_in_jit)."""
    x = _inputs()["mesh2"]
    mesh = _jax_mesh((2, 2), (CROSS_AXIS, LOCAL_AXIS))
    for op in ("sum", "average"):
        jop = getattr(hvd, op.capitalize())
        want = _jax_per_rank(lambda v: JC.torus_allreduce(v, op=jop), x,
                             mesh)
        port = _port(world4, f"m2_hier_{op}")
        _close(port, want, f"hierarchical {op}")
        flat = x.sum(0) / (W4 if op == "average" else 1)
        _close(port, [flat] * W4, f"hierarchical {op} vs flat", rtol=1e-5)
    err = str(world4("m2_hier_indivisible", 0)["error"])
    assert err.startswith("ValueError") and "divisible" in err


def test_hierarchical_allgather_and_ppermute_along_an_axis(world4):
    x = _inputs()["mesh2"]
    mesh = _jax_mesh((2, 2), (CROSS_AXIS, LOCAL_AXIS))
    _same(_port(world4, "m2_ag_hier"),
          _jax_per_rank(lambda v: JC.allgather(
              v, axis=(CROSS_AXIS, LOCAL_AXIS)), x, mesh),
          "hierarchical allgather")
    _same(_port(world4, "m2_pp_local"),
          _jax_per_rank(lambda v: JC.ppermute(v, [(0, 1), (1, 0)],
                                              axis=LOCAL_AXIS), x, mesh),
          "ppermute over hvd_local")


def test_join_neutral_matches_the_jax_identities():
    for op in (collectives.ReduceOp.SUM, collectives.ReduceOp.MIN,
               collectives.ReduceOp.MAX, collectives.ReduceOp.PRODUCT):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.int32, jnp.int32), (torch.int8, jnp.int8)):
            port = torch.tensor(collectives._join_neutral(op, tdt),
                                dtype=tdt)
            want = JC._join_neutral(op, jdt)
            assert float(port) == float(want), (op, tdt)
