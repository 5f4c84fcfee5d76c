"""The port's collectives over one mesh axis against the JAX package's
``lax`` collectives under ``shard_map``, on the CPU.

One 4-rank gloo world (``test_torch_workers.run_phases``) on a (dp 2, tp
2) mesh and then a (dp 2, sp 2) mesh, against the JAX functions on
``jax.devices()[:4]`` laid out the same way (rank r at row-major
position r). Inputs are rank-stacked numpy arrays (rank r takes row r).

- ``psum`` over ``tp`` and its gradient: the sum runs over the axis's
  group (2 ranks), and its backward sums the cotangents over it;
- ``pmean``, ``pmax`` (no gradient), ``axis_index``/``axis_size``, the
  tiled ``all_gather`` and ``all_to_all`` (several dims) and
  ``ppermute`` over ``tp`` and ``dp``, each with its gradient (the
  transposes: reduce-scatter, the swapped all-to-all, the inverse
  permutation);
- ``sync_gradients`` over ``("dp", "sp")``: one sum over each axis's
  group, then 1/W, bound or not.

Outputs and gradients must match to 1e-6 (f32 sums of two or four
terms).
"""

import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as JP

from horovod_tpu.eager import shard_map
from horovod_tpu.parallel import trainer as jtrainer
from horovod_tpu_torch.ops import collectives
import test_torch_workers as workers

LIMIT_S = 90
TOL = dict(atol=1e-6, rtol=1e-6)
W = 4


@pytest.fixture(scope="module", autouse=True)
def _limit():
    def expired(*_):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")
    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _ops():
    rng = np.random.RandomState(0)

    def arr(*shape):
        return rng.randn(W, *shape).astype(np.float32)

    ops = []
    for ax in ("tp", "dp"):
        ops += [
            dict(tag=f"psum_{ax}", name="psum", axis=ax, x=arr(3, 4)),
            dict(tag=f"pmean_{ax}", name="pmean", axis=ax, x=arr(5)),
            dict(tag=f"pmax_{ax}", name="pmax", axis=ax, x=arr(2, 3)),
            dict(tag=f"index_{ax}", name="axis_index", axis=ax, x=arr(3)),
            dict(tag=f"gather0_{ax}", name="all_gather", axis=ax, dim=0,
                 x=arr(3, 4)),
            dict(tag=f"gather1_{ax}", name="all_gather", axis=ax, dim=1,
                 x=arr(3, 4)),
            dict(tag=f"a2a_10_{ax}", name="all_to_all", axis=ax, split=1,
                 concat=0, x=arr(3, 4, 2)),
            dict(tag=f"a2a_21_{ax}", name="all_to_all", axis=ax, split=2,
                 concat=1, x=arr(2, 3, 4, 5)),
            dict(tag=f"ppermute_{ax}", name="ppermute", axis=ax,
                 perm=[(0, 1), (1, 0)], x=arr(4, 3)),
            dict(tag=f"ppermute_half_{ax}", name="ppermute", axis=ax,
                 perm=[(0, 1)], x=arr(2, 2)),
        ]
    for op in ops:
        op["ct"] = rng.randn(*_out_shape(op)).astype(np.float32)
    return ops


def _out_shape(op):
    shape = list(op["x"].shape[1:])
    if op["name"] == "all_gather":
        shape[op["dim"]] *= 2
    elif op["name"] == "all_to_all":
        shape[op["split"]] //= 2
        shape[op["concat"]] *= 2
    return (W, *shape)


SYNC = dict(grads={"a": np.random.RandomState(1).randn(W, 5, 3).astype(
                np.float32),
                   "b": np.random.RandomState(2).randn(W, 6).astype(
                np.float32)},
            sync={"a": ("dp", "sp"), "b": ("sp",)}, world=W)


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    phases = [
        dict(init=dict(mesh_shape=(2, 2), axis_names=("dp", "tp")),
             scenarios=[dict(name="coll", kind="ad_collectives",
                             axes=("dp", "tp"), ops=_ops())]),
        dict(init=dict(mesh_shape=(2, 2), axis_names=("dp", "sp")),
             scenarios=[dict(name="sync", kind="sync", axes=("dp", "sp"),
                             **SYNC)]),
    ]
    load = workers.run_phases(W, phases,
                              tmp_path_factory.mktemp("axis_collectives"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


def _mesh(names):
    return Mesh(np.array(jax.devices()[:W]).reshape(2, 2), names)


def _jax_op(op):
    ax, name = op["axis"], op["name"]

    def fn(x):
        if name == "psum":
            return lax.psum(x, ax)
        if name == "pmean":
            return lax.pmean(x, ax)
        if name == "pmax":
            return lax.pmax(lax.stop_gradient(x), ax) + 0 * x
        if name == "axis_index":
            return x * (1 + lax.axis_index(ax)) + lax.psum(1, ax)
        if name == "all_gather":
            return lax.all_gather(x, ax, axis=op["dim"], tiled=True)
        if name == "all_to_all":
            return lax.all_to_all(x, ax, op["split"], op["concat"],
                                  tiled=True)
        return lax.ppermute(x, ax, op["perm"])

    def local(x, ct):
        x, ct = x[0], ct[0]
        y, vjp = jax.vjp(fn, x)
        (g,) = vjp(ct)
        return y[None], g[None]

    spec = JP(("dp", "tp"))
    return jax.jit(shard_map(local, _mesh(("dp", "tp")),
                             in_specs=(spec, spec), out_specs=(spec, spec)))(
        jnp.asarray(op["x"]), jnp.asarray(op["ct"]))


OPS = {op["tag"]: op for op in _ops()}


@pytest.mark.parametrize("tag", sorted(OPS))
def test_axis_collective_and_its_gradient_match_jax(port_world, tag):
    op = OPS[tag]
    y, g = _jax_op(op)
    for rank in range(W):
        got = port_world("coll", rank)
        np.testing.assert_allclose(got[f"{tag}|out"], np.asarray(y[rank]),
                                   **TOL, err_msg=f"{tag} out, rank {rank}")
        np.testing.assert_allclose(got[f"{tag}|grad"], np.asarray(g[rank]),
                                   **TOL, err_msg=f"{tag} grad, rank {rank}")


def test_psum_over_tp_sums_over_its_group_only(port_world):
    """The sum of a (dp 2, tp 2) mesh's tp axis has two terms: rank r's
    result is x[r] + x[r ^ 1], not the world's sum."""
    x = OPS["psum_tp"]["x"]
    for rank in range(W):
        got = port_world("coll", rank)["psum_tp|out"]
        np.testing.assert_allclose(got, x[rank] + x[rank ^ 1], **TOL)


def test_sync_gradients_over_dp_and_sp_match_jax(port_world):
    spec = JP(("dp", "sp"))

    def local(a, b):
        out = jtrainer.sync_gradients({"a": a[0], "b": b[0]}, SYNC["sync"],
                                      SYNC["world"])
        return out["a"][None], out["b"][None]

    a, b = jax.jit(shard_map(local, _mesh(("dp", "sp")),
                             in_specs=(spec, spec),
                             out_specs=(spec, spec)))(
        jnp.asarray(SYNC["grads"]["a"]), jnp.asarray(SYNC["grads"]["b"]))
    for rank in range(W):
        got = port_world("sync", rank)
        for mode in ("bound", "free"):
            np.testing.assert_allclose(got[f"{mode}|a"], np.asarray(a[rank]),
                                       **TOL)
            np.testing.assert_allclose(got[f"{mode}|b"], np.asarray(b[rank]),
                                       **TOL)


def test_axis_collectives_need_a_bound_axis():
    x = torch.ones(2)
    for fn in (lambda: collectives.psum(x, "tp"),
               lambda: collectives.all_gather(x, "tp"),
               lambda: collectives.all_to_all(x, "tp", 0, 0),
               lambda: collectives.axis_index("tp"),
               lambda: collectives.mesh_axis("tp")):
        with pytest.raises(NameError, match="unbound axis"):
            fn()
