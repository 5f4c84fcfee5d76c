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
        with pytest.raises(NotImplementedError, match="Adasum"):
            htt.allreduce(torch.ones(2), op=collectives.ReduceOp.ADASUM)
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
