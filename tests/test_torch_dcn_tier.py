"""The DCN tier of the PyTorch port against the JAX package, on the CPU.

Two spawned gloo worlds (``test_torch_workers.phase_worker``) with
HOROVOD_DCN_VIRTUAL_SLICES=2: four ranks as (hvd_dcn 2, hvd_local 2) and
eight as (hvd_dcn 2, hvd_cross 2, hvd_local 2), against the JAX package
under shard_map on ``jax.devices()[:4]`` / ``[:8]`` with the same mesh.
They replay ``tests/test_dcn_tier.py`` l.78-258 (the two-level primitive:
the equivalence matrix against the flat allreduce, the bf16 and fp8 cross
tiers, the hierarchical allreduce's DCN extension), l.326-400 (the
bucketed sync through the tier: flat against two_level, several buckets,
fp8 with the error-feedback residual, the DCN stage's bytes) and l.438
(ops the tier does not take), plus the schedule's resolution.

The wire codec's repair: the fp8 scale of the DCN stage is the amax of the
ranks that stage sums (one DCN group), not of the world. A gradient whose
halves differ by 1e4 gives the two DCN groups different amaxes; the port's
bucket must equal JAX's ``two_level_allreduce(wire_codec=...)``, which a
world-wide amax does not (the small half would lose its low bits).

Tolerances: integer sums and MIN/MAX bitwise; f32 SUM/AVERAGE 1e-6
relative to the largest value of the result; the port against JAX's own
fp8 and bf16 tiers 1e-6 of the largest value (every wire value equal; the
residuals 1e-6 of four times the largest parameter, which bounds the
quadratic's gradient, as ``tests/test_torch_grad_sync.py`` holds them), and
the fp8 tier against the flat f32 sum the JAX test's own bound (0.1 of the
largest value; parameters after the fp8 steps 0.2).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.compression import WireCodec as JWireCodec
from horovod_tpu.config import knobs as jknobs
from horovod_tpu.eager import shard_map
from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops.reduce_ops import ReduceOp as JOp
from horovod_tpu.parallel import distributed as JD
from horovod_tpu.runtime.topology import (CROSS_AXIS, DCN_AXIS,
                                          LOCAL_AXIS)
from horovod_tpu_torch import autotune
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.ops.reduce_ops import ReduceOp
from horovod_tpu_torch.parallel import distributed as D
from test_torch_collectives import _jax_per_rank
import test_torch_workers as workers

AXES4 = (DCN_AXIS, LOCAL_AXIS)
AXES8 = (DCN_AXIS, CROSS_AXIS, LOCAL_AXIS)
DIMS = (8, 7, 13)
OPT_KNOBS = {
    "opt_flat": {"HOROVOD_DCN_SCHEDULE": "flat"},
    "opt_two": {"HOROVOD_DCN_SCHEDULE": "two_level"},
    "opt_two_multi": {"HOROVOD_DCN_SCHEDULE": "two_level",
                      "HOROVOD_GRADIENT_BUCKET_BYTES": 2 * 48 * 4},
    "opt_two_bf16": {"HOROVOD_DCN_SCHEDULE": "two_level",
                     "HOROVOD_GRADIENT_COMPRESSION": "bf16"},
    "opt_two_fp8": {"HOROVOD_DCN_SCHEDULE": "two_level",
                    "HOROVOD_GRADIENT_COMPRESSION": "fp8_e4m3",
                    "HOROVOD_GRADIENT_ERROR_FEEDBACK": "1"},
    "opt_two_fp8_multi": {"HOROVOD_DCN_SCHEDULE": "two_level",
                          "HOROVOD_GRADIENT_COMPRESSION": "fp8_e4m3",
                          "HOROVOD_GRADIENT_ERROR_FEEDBACK": "1",
                          "HOROVOD_GRADIENT_BUCKET_BYTES": 2 * 48 * 4},
}
REPAIR_KNOBS = {"HOROVOD_DCN_SCHEDULE": "two_level",
                "HOROVOD_GRADIENT_COMPRESSION": "fp8_e4m3",
                "HOROVOD_GRADIENT_ERROR_FEEDBACK": "0"}


def _quad_params(n=8, base=48):
    rng = np.random.RandomState(0)
    return {f"w{i:02d}": rng.randn(base + i).astype(np.float32)
            for i in range(n)}


def _xs(world, steps=3):
    rng = np.random.RandomState(1)
    return [rng.rand(world, 2).astype(np.float32) for _ in range(steps)]


def _two_level_x(dim0, world, kind):
    rng = np.random.RandomState(dim0)
    if kind == "f32":
        return rng.randn(world, dim0, 3).astype(np.float32)
    if kind == "minmax":
        return rng.randn(world, dim0).astype(np.float32)
    if kind == "int":
        return rng.randint(-50, 50, (world, dim0, 2)).astype(np.int32)
    return rng.randint(-8, 8, (world, dim0)).astype(np.float32)   # bf16


def _repair_grad(world):
    """Per rank, a leaf whose first half is ~1 and second half ~1e4."""
    rng = np.random.RandomState(4)
    g = rng.randn(world, 16).astype(np.float32)
    g[:, 8:] *= 1e4
    return g


def _scenarios4():
    sc = [dict(kind="topology", name="topo",
               axes=[(DCN_AXIS,), (LOCAL_AXIS,), AXES4])]
    two = dict(fn="two_level_allreduce",
               kw={"ici_axes": (LOCAL_AXIS,), "dcn_axis": DCN_AXIS})
    for d in DIMS:
        for op in ("SUM", "AVERAGE"):
            x = _two_level_x(d, 4, "f32")
            sc += [dict(two, name=f"two_{op}_{d}", args=[x],
                        kw=dict(two["kw"], op=op)),
                   dict(name=f"flat_{op}_{d}", fn="allreduce", args=[x],
                        kw={"op": op, "axis": AXES4})]
        for op in ("MIN", "MAX"):
            x = _two_level_x(d, 4, "minmax")
            sc += [dict(two, name=f"two_{op}_{d}", args=[x],
                        kw=dict(two["kw"], op=op)),
                   dict(name=f"flat_{op}_{d}", fn="allreduce", args=[x],
                        kw={"op": op, "axis": AXES4})]
        sc.append(dict(two, name=f"two_int_{d}",
                       args=[_two_level_x(d, 4, "int")],
                       kw=dict(two["kw"], op="SUM")))
    for d in (8, 7):
        sc.append(dict(two, name=f"two_bf16_{d}",
                       args=[_two_level_x(d, 4, "bf16")],
                       kw=dict(two["kw"], op="SUM", wire_codec="bf16")))
    x = np.random.RandomState(3).randn(4, 13).astype(np.float32)
    sc.append(dict(two, name="two_fp8", args=[x],
                   kw=dict(two["kw"], op="AVERAGE",
                           wire_codec="fp8_e4m3")))
    params = _quad_params()
    sc += [dict(kind="optimizer", name=name, params=params, xs=_xs(4),
                knobs=kn) for name, kn in OPT_KNOBS.items()]
    sc.append(dict(kind="transform", name="repair", axis=AXES4,
                   grads={"g": _repair_grad(4)}, knobs=REPAIR_KNOBS))
    sc.append(dict(kind="transform", name="spy", axis=AXES4,
                   compression="spy", grads={"g": _repair_grad(4)},
                   knobs={"HOROVOD_DCN_SCHEDULE": "two_level"}))
    return sc


def _scenarios8():
    from test_torch_topology import _axis_tuples
    sc = [dict(kind="topology", name="topo8", axes=_axis_tuples(AXES8))]
    x = _two_level_x(13, 8, "f32")
    sc += [dict(name="two8_sum", fn="two_level_allreduce", args=[x],
                kw={"op": "SUM"}),
           dict(name="hier8_avg", fn="hierarchical_allreduce",
                args=[_two_level_x(8, 8, "f32")],
                kw={"op": "AVERAGE", "dcn_axis": DCN_AXIS}),
           dict(name="flat8_avg", fn="allreduce",
                args=[_two_level_x(8, 8, "f32")], kw={"op": "AVERAGE"})]
    sc += [dict(name=f"ar8_{a}", fn="allreduce", args=[x],
                kw={"op": "SUM", "axis": a}) for a in AXES8]
    sc.append(dict(kind="optimizer", name="opt8_fp8", params=_quad_params(),
                   xs=_xs(8), knobs=OPT_KNOBS["opt_two_fp8"]))
    return sc


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    phases = [dict(knobs={"HOROVOD_DCN_VIRTUAL_SLICES": 2},
                   scenarios=_scenarios4())]
    load = workers.run_phases(4, phases, tmp_path_factory.mktemp("dcn4"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    phases = [dict(knobs={"HOROVOD_DCN_VIRTUAL_SLICES": 2},
                   scenarios=_scenarios8())]
    load = workers.run_phases(8, phases, tmp_path_factory.mktemp("dcn8"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


def _mesh(names):
    n = 2 ** len(names)
    return Mesh(np.array(jax.devices()[:n]).reshape((2,) * len(names)),
                names)


def _out(world, name, n, key="out0"):
    return [world(name, r)[key] for r in range(n)]


def _close(port, want, what, rel=1e-6):
    for r, (p, w) in enumerate(zip(port, want)):
        scale = float(np.max(np.abs(w)))
        np.testing.assert_allclose(p, w, rtol=0, atol=rel * scale,
                                   err_msg=f"{what} rank {r}")


def _same(port, want, what):
    for r, (p, w) in enumerate(zip(port, want)):
        np.testing.assert_array_equal(p, w, err_msg=f"{what} rank {r}")


def _with_jknobs(settings, fn):
    for k, v in settings.items():
        jknobs.set_override(k, v)
    try:
        return fn()
    finally:
        for k in settings:
            jknobs.clear_override(k)


def _jax_two(op, codec=None, ici=(LOCAL_AXIS,)):
    return lambda v: JC.two_level_allreduce(v, op=op, ici_axes=ici,
                                            dcn_axis=DCN_AXIS,
                                            wire_codec=codec)


# ---------------------------------------------------------------------------
# the schedule, in one process
# ---------------------------------------------------------------------------

def test_schedule_resolution():
    """'auto' resolves flat in the port (the cost model's constants are a
    TPU's); a pinned schedule holds; one slice or one fast rank is always
    flat."""
    try:
        assert autotune.resolve_dcn_schedule(1 << 20, 4, 2) == "flat"
        knobs.set_override("HOROVOD_DCN_SCHEDULE", "two_level")
        assert autotune.resolve_dcn_schedule(1 << 20, 4, 2) == "two_level"
        assert autotune.resolve_dcn_schedule(1 << 20, 4, 1) == "flat"
        assert autotune.resolve_dcn_schedule(1 << 20, 1, 2) == "flat"
        knobs.set_override("HOROVOD_DCN_SCHEDULE", "flat")
        assert autotune.resolve_dcn_schedule(1 << 20, 4, 2) == "flat"
        assert not autotune._dcn_tier_present()
        knobs.set_override("HOROVOD_DCN_VIRTUAL_SLICES", 2)
        assert autotune._dcn_tier_present()
    finally:
        knobs.clear_override("HOROVOD_DCN_SCHEDULE")
        knobs.clear_override("HOROVOD_DCN_VIRTUAL_SLICES")


@pytest.mark.parametrize("axes", [(DCN_AXIS, LOCAL_AXIS), AXES8,
                                  (DCN_AXIS,), (LOCAL_AXIS,), ("hvd",)])
def test_tier_split_matches_the_jax_package(axes):
    assert D._tier_split(axes) == JD._tier_split(axes)


def test_min_op_and_local_groups_bypass_the_tier():
    """tests/test_dcn_tier.py::test_min_op_bypasses_tier: the tier's
    cross stage is a wire SUM, so MIN never takes it (the port's gradient
    sync refuses MIN altogether)."""
    g = [torch.ones(4)]
    assert D._resolve_tier(g, AXES4, ReduceOp.MIN) is None
    with pytest.raises(NotImplementedError):
        D._GradSync(g, {AXES4: [0]}, ReduceOp.MIN, None, None)


# ---------------------------------------------------------------------------
# the two-level primitive, four ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim0", DIMS)
@pytest.mark.parametrize("op", ["SUM", "AVERAGE"])
def test_sum_average_match_jax_and_flat_f32(world4, op, dim0):
    x = _two_level_x(dim0, 4, "f32")
    want = _jax_per_rank(_jax_two(JOp[op]), x, _mesh(AXES4))
    port = _out(world4, f"two_{op}_{dim0}", 4)
    _close(port, want, f"two_level {op} {dim0}")
    _close(port, _out(world4, f"flat_{op}_{dim0}", 4), "against flat")


@pytest.mark.parametrize("dim0", DIMS)
@pytest.mark.parametrize("op", ["MIN", "MAX"])
def test_min_max_match_flat_bitwise(world4, op, dim0):
    x = _two_level_x(dim0, 4, "minmax")
    want = _jax_per_rank(_jax_two(JOp[op]), x, _mesh(AXES4))
    port = _out(world4, f"two_{op}_{dim0}", 4)
    _same(port, want, f"two_level {op}")
    _same(port, _out(world4, f"flat_{op}_{dim0}", 4), "against flat")


@pytest.mark.parametrize("dim0", DIMS)
def test_int_sum_bitwise(world4, dim0):
    x = _two_level_x(dim0, 4, "int")
    want = _jax_per_rank(_jax_two(JOp.SUM), x, _mesh(AXES4))
    port = _out(world4, f"two_int_{dim0}", 4)
    _same(port, want, "int two_level")
    _same(port, [x.sum(0)] * 4, "int against the sum")
    assert port[0].dtype == np.int32


@pytest.mark.parametrize("dim0", [8, 7])
def test_bf16_cross_tier_exact_on_representable_values(world4, dim0):
    x = _two_level_x(dim0, 4, "bf16")
    want = _jax_per_rank(_jax_two(JOp.SUM, JWireCodec("bf16")), x,
                         _mesh(AXES4))
    port = _out(world4, f"two_bf16_{dim0}", 4)
    _close(port, want, "bf16 tier")
    _close(port, [x.sum(0)] * 4, "bf16 tier against the sum")


def test_fp8_cross_tier_matches_jax_and_stays_close_to_flat(world4):
    x = np.random.RandomState(3).randn(4, 13).astype(np.float32)
    want = _jax_per_rank(_jax_two(JOp.AVERAGE, JWireCodec("fp8_e4m3")), x,
                         _mesh(AXES4))
    port = _out(world4, "two_fp8", 4)
    _close(port, want, "fp8 tier")
    flat = x.mean(0)
    for p in port:
        assert float(np.max(np.abs(p - flat))) < 0.1 * float(
            np.max(np.abs(flat)))


def test_topology_of_the_virtual_slices(world4):
    for r in range(4):
        res = world4("topo", r)
        assert str(res["flat_axes"]) == f"{DCN_AXIS},{LOCAL_AXIS}"
        assert list(res[f"members|{DCN_AXIS}"]) == [r % 2, r % 2 + 2]
        assert list(res[f"members|{LOCAL_AXIS}"]) == [r // 2 * 2,
                                                      r // 2 * 2 + 1]


# ---------------------------------------------------------------------------
# the bucketed sync through the tier
# ---------------------------------------------------------------------------

def _jax_optimizer(name, world, names):
    """Three SGD steps of the quadratic through the JAX
    DistributedOptimizer over every axis, with ``name``'s knobs."""
    mesh = _mesh(names)
    params = {k: jnp.asarray(v) for k, v in _quad_params().items()}

    def run():
        opt = hvd.DistributedOptimizer(optax.sgd(0.1), op=hvd.Average,
                                       axis=names, mesh=mesh)
        st = opt.init(params)
        sspec = JD.wire_state_specs(st, axis=names)

        def step(p, s, x):
            grads = jax.grad(lambda q: sum(jnp.sum(v * v)
                                           for v in q.values())
                             * jnp.sum(x))(p)
            upd, s = opt.update(grads, s, p)
            return optax.apply_updates(p, upd), s

        fn = jax.jit(shard_map(step, mesh=mesh,
                               in_specs=(P(), sspec, P(names)),
                               out_specs=(P(), sspec)))
        p = params
        for x in _xs(world):
            p, st = fn(p, st, jnp.asarray(x))
        return p, st, JD.last_wire_trace()

    return _with_jknobs(OPT_KNOBS.get(name, OPT_KNOBS["opt_two_fp8"]), run)


TRACE_KEYS = ("schedule", "n_buckets", "logical_bytes", "wire_bytes",
              "dcn_wire_bytes", "tier", "error_feedback")


def _check_optimizer(world, name, n, names, rel):
    jp, jst, trace = _jax_optimizer(name, n, names)
    ef = isinstance(jst[0], JD.WireState)
    for r in range(n):
        out = world(name, r)
        for key in TRACE_KEYS:
            assert out[f"trace|{key}"] == trace[key], (name, key)
        for k in jp:
            _close([out[f"param|{k}"]], [np.asarray(jp[k])], f"{name} {k}",
                   rel)
            if ef:
                # the residual carries the gradient's rounding: 1e-6 of
                # the largest gradient (below 4 max|v| on the quadratic),
                # as tests/test_torch_grad_sync.py holds it
                want = np.asarray(jst[0].residual[k])[r]
                lim = rel * 4 * float(np.max(np.abs(np.asarray(jp[k]))))
                np.testing.assert_allclose(out[f"residual|{k}"], want,
                                           rtol=0, atol=lim,
                                           err_msg=f"{name} residual {k}")
    return trace


@pytest.mark.parametrize("name", sorted(OPT_KNOBS))
def test_distributed_optimizer_through_the_tier_matches_jax(world4, name):
    """The quadratic's three steps at flat and two_level (one and several
    buckets), bf16 and fp8 with error feedback on the DCN stage: the
    parameters, the per-rank residual and the wire trace (schedule,
    buckets, logical, wire and DCN-stage bytes) equal the JAX package's."""
    trace = _check_optimizer(world4, name, 4, AXES4, 1e-6)
    assert trace["schedule"] == ("flat" if name == "opt_flat"
                                 else "two_level")
    if name.endswith("multi"):
        assert trace["n_buckets"] >= 3


def test_two_level_equals_flat_and_the_dcn_stage_bytes(world4):
    """tests/test_dcn_tier.py::test_two_level_matches_flat and
    ..._fp8_cross_tier_close_with_residual: two_level equals flat to 1e-6,
    fp8 stays within 0.2, a residual is carried, and each rank's DCN stage
    carries 1/local of each bucket in the wire dtype plus its scale."""
    for r in range(4):
        flat, two = world4("opt_flat", r), world4("opt_two", r)
        fp8 = world4("opt_two_fp8", r)
        for k in _quad_params():
            _close([two[f"param|{k}"]], [flat[f"param|{k}"]], k)
            _close([fp8[f"param|{k}"]], [flat[f"param|{k}"]], k, rel=0.2)
        assert any(np.abs(fp8[f"residual|{k}"]).max() > 0
                   for k in _quad_params())
        sizes = [v.size for v in _quad_params().values()]
        for name, buckets in (("opt_two_fp8", [sum(sizes)]),):
            want = sum(-(-n // 2) * 1 + 4 for n in buckets)
            assert int(world4(name, r)["trace|dcn_wire_bytes"]) == want
        assert int(two["trace|dcn_wire_bytes"]) == -(-sum(sizes) // 2) * 4


def test_wire_codec_amax_spans_one_dcn_group(world4):
    """The repair: under (dcn 2, local 2) the two DCN groups hold the
    gradient's two halves, ~1 and ~1e4; the port's fp8 two-level bucket
    equals JAX's two_level_allreduce with the codec, whose amax is
    pmax-ed over hvd_dcn alone."""
    g = _repair_grad(4)
    want = _jax_per_rank(_jax_two(JOp.AVERAGE, JWireCodec("fp8_e4m3")), g,
                         _mesh(AXES4))
    port = _out(world4, "repair", 4, key="param|g")
    for r in range(4):
        for half in (slice(0, 8), slice(8, 16)):
            _close([port[r][half]], [want[r][half]], f"rank {r} {half}")
    assert str(world4("repair", 0)["trace|schedule"]) == "two_level"


def test_custom_compressor_bypasses_the_tier_and_still_applies(world4):
    """A duck-typed per-leaf compressor has no wire tier: the sync stays
    flat and the compressor runs (tests/test_dcn_tier.py l.400)."""
    g = _repair_grad(4)
    for r in range(4):
        out = world4("spy", r)
        assert str(out["trace|schedule"]) == "flat"
        assert out["spy_calls"].min() >= 1
        _close([out["param|g"]], [g.mean(0)], "spy")


# ---------------------------------------------------------------------------
# eight ranks: (dcn 2, cross 2, local 2)
# ---------------------------------------------------------------------------

def test_three_axis_groups_equal_the_jax_tables(world8):
    from test_torch_topology import _axis_tuples, _jax_tables
    from horovod_tpu.runtime import topology as JT
    knobs_ = {"HOROVOD_DCN_VIRTUAL_SLICES": 2}
    jtopo = _with_jknobs(knobs_, lambda: JT.build_topology(
        devices=jax.devices()[:8]))
    assert jtopo.flat_axes == AXES8
    for axes in _axis_tuples(AXES8):
        idx, members = _jax_tables(jtopo, axes)
        key = ",".join(axes)
        for r in range(8):
            res = world8("topo8", r)
            assert list(res[f"members|{key}"]) == list(members[r]), key
            assert int(res[f"index|{key}"]) == idx[r], key


def test_three_axis_two_level_hierarchical_and_axis_sums(world8):
    mesh = _mesh(AXES8)
    x = _two_level_x(13, 8, "f32")
    _close(_out(world8, "two8_sum", 8),
           _jax_per_rank(_jax_two(JOp.SUM, ici=(CROSS_AXIS, LOCAL_AXIS)),
                         x, mesh), "two_level (cross, local) x dcn")
    x8 = _two_level_x(8, 8, "f32")
    want = _jax_per_rank(lambda v: JC.hierarchical_allreduce(
        v, op=JOp.AVERAGE, dcn_axis=DCN_AXIS), x8, mesh)
    _close(_out(world8, "hier8_avg", 8), want, "hierarchical + dcn")
    _close(_out(world8, "flat8_avg", 8), want, "flat against it")
    for a in AXES8:
        _close(_out(world8, f"ar8_{a}", 8), _jax_per_rank(
            lambda v: JC.allreduce(v, op=JOp.SUM, axis=a), x, mesh), a)


def test_three_axis_fp8_sync_moves_a_quarter_of_a_quarter(world8):
    """With four fast ranks the fp8 DCN stage carries under 1/8 of the
    logical f32 bytes (tests/test_dcn_tier.py l.380-384), and the run
    equals the JAX package's."""
    trace = _check_optimizer(world8, "opt8_fp8", 8, AXES8, 1e-6)
    assert 0 < trace["dcn_wire_bytes"] < trace["logical_bytes"] / 8
