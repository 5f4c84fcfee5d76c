"""The port's fusion-cycle coordinator (``horovod_tpu_torch.ops.coordinator``)
against the JAX package's, on the CPU.

``tests/test_coordinator.py`` (l.43-628) replayed as scripts
(``test_torch_workers.run_coord_script``): the same enqueues, cycles,
waits and knob changes go through the JAX coordinator on the rank-stacked
inputs (``hvd.init(devices=jax.devices()[:W])``) and through the port's in
a world of W ranks, W = 1 (a thread-less coordinator, as ``manual_coord``),
2 and 4 (gloo worlds, deterministic dispatch). Each world is started once
for the module (``test_torch_workers.run_phases``), with a second phase on
the (2, 2) mesh in the world of four. Where the port's world of several
ranks is deterministic, the JAX coordinator is forced deterministic too
(as ``det_coord`` does), so both flush at the same points.

For every script these are equal: the bins (member names and their
order), ``stats`` (cycles, tensors, dispatched programs,
``fused_tensors_max``), the per-step records (cycles' bin counts,
``done``, probes, error types) and, where the JAX cache sees only the
coordinator's lookups, the cache's hits, misses and evictions. Rank r's
results equal the JAX result (or its row r): bitwise for integers,
movement, MIN and MAX; within 1e-6 of the largest value for f32 sums.

Not replayed: the sync-path executable-cache cases (l.177-265; the port's
synchronous collectives compile nothing and use no plan cache, ROADMAP C)
and the autotune cases (l.393-424, 629-744): the tuner driven by the cycle
is ``test_unported_knobs_make_the_coordinator_raise[HOROVOD_AUTOTUNE-1]``,
the cross-rank synchronization is ``tests/test_torch_param_sync.py``.
The JAX ``_pool`` of ``HOROVOD_NUM_STREAMS`` has no counterpart on the CPU
(the port's lanes are CUDA streams), so that case holds bins and results.
"""

import json
import os
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import horovod_tpu as hvd
import test_torch_workers as workers

LIMIT_S = 240
WORLDS = (1, 2, 4)
F32_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


# ---------------------------------------------------------------------------
# the scripts (rank-stacked inputs of W rows; rank r's row differs by r)
# ---------------------------------------------------------------------------

def _rows(w, val, cols=4, dtype=np.float32):
    return np.stack([np.full((cols,), val + r, dtype) for r in range(w)])


def _enq(fn, arg, name, op=None, **kw):
    st = {"do": "enqueue", "fn": fn, "arg": arg, "name": name, "kw": kw}
    if op:
        st["kw"]["op"] = op
    return st


def _wait(name, out=None, cmp="same", tol=0.0, **kw):
    return dict({"do": "wait", "name": name, "out": out or name, "cmp": cmp,
                 "tol": tol}, **kw)


def _knob(**kw):
    return {"do": "knob", "set": kw}


CYCLE = {"do": "cycle"}
PROBE = {"do": "probe"}


def _fuse_one(w):
    # Deterministic (w > 1): done() is a flush point, and whether the JAX
    # result is ready right after it is a matter of timing, so only the
    # flush it made is recorded (the probe).
    a = {f"g{i}": _rows(w, i + 1.0) for i in range(5)}
    return {"arrays": a, "steps": (
        [_enq("allreduce_async", f"g{i}", f"g{i}", "SUM") for i in range(5)]
        + [{"do": "done", "name": f"g{i}", "quiet": w > 1}
           for i in range(5)] + [PROBE, CYCLE]
        + [_wait(f"g{i}", tol=F32_TOL) for i in range(5)])}


def _cache_steady(w):
    a, steps = {}, []
    for step in range(3):
        for i in range(4):
            a[f"s{step}.{i}"] = _rows(w, step + i)
            steps.append(_enq("allreduce_async", f"s{step}.{i}",
                              f"s{step}.{i}", "SUM"))
        steps += [CYCLE] + [_wait(f"s{step}.{i}", tol=F32_TOL)
                            for i in range(4)]
    return {"arrays": a, "steps": steps}


def _mixed_ops(w):
    a = {"ar": _rows(w, 2.0), "mx": _rows(w, 3.0), "bc": _rows(w, 5.0)}
    return {"arrays": a, "steps": [
        _enq("allreduce_async", "ar", "ar", "SUM"),
        _enq("allreduce_async", "mx", "mx", "MAX"),
        _enq("broadcast_async", "bc", "bc", root_rank=min(1, w - 1)),
        CYCLE, _wait("ar", tol=F32_TOL), _wait("mx"),
        _wait("bc")]}


def _mixed_dtypes(w):
    a = {"f32": _rows(w, 1.0), "i32": _rows(w, 2, dtype=np.int32)}
    return {"arrays": a, "steps": [
        _enq("allreduce_async", "f32", "f32", "SUM"),
        _enq("allreduce_async", "i32", "i32", "SUM"),
        CYCLE, _wait("f32", tol=F32_TOL), _wait("i32")]}


def _partial_group(w):
    a = {"pg.0": _rows(w, 1.0), "pg.1": _rows(w, 2.0)}

    def raw(name):
        return {"do": "raw", "op_type": "allreduce", "arg": name,
                "name": name, "kw": {"op": "SUM", "group_id": 9999,
                                     "group_size": 2}}
    return {"arrays": a, "steps": [
        raw("pg.0"), CYCLE, {"do": "done", "name": "pg.0"}, raw("pg.1"),
        CYCLE, _wait("pg.0", tol=F32_TOL), _wait("pg.1", tol=F32_TOL)]}


def _allgather_fused(w):
    a = {"ag0": np.arange(w * 2, dtype=np.float32).reshape(w, 2),
         "ag1": np.arange(w * 3, dtype=np.float32).reshape(w, 1, 3)}
    return {"arrays": a, "steps": [
        _enq("allgather_async", "ag0", "ag0"),
        _enq("allgather_async", "ag1", "ag1"), CYCLE,
        _wait("ag0"), _wait("ag1")]}


def _subgroup_allgather(w):
    a = {"x": np.arange(w * 2, dtype=np.float32).reshape(w, 2)}
    return {"arrays": a, "sets": [[r for r in (0, 2, 5) if r < w]],
            "cache": False, "steps": [
                dict(_enq("allgather_async", "x", "subag"), ps=0), CYCLE,
                _wait("subag", cmp="members", members=0, own="x")]}


def _alltoall_never_fused(w):
    a = {"x": np.arange(w * w, dtype=np.float32).reshape(w, w)}
    return {"arrays": a, "cache": False, "steps": [
        _enq("alltoall_async", "x", "a2a.0"),
        _enq("alltoall_async", "x", "a2a.1"), CYCLE,
        _wait("a2a.0", cmp="rank"), _wait("a2a.1", cmp="rank")]}


def _threshold_limits(w):
    # each tensor is w x 4 x 4 bytes stacked; the capacity admits one
    a = {f"t{i}": _rows(w, float(i)) for i in range(4)}
    return {"arrays": a, "steps": (
        [_knob(HOROVOD_FUSION_THRESHOLD=24 * w)]
        + [_enq("allreduce_async", f"t{i}", f"t{i}", "SUM")
           for i in range(4)] + [CYCLE]
        + [_wait(f"t{i}", tol=F32_TOL) for i in range(4)]
        + [{"do": "unknob", "names": ["HOROVOD_FUSION_THRESHOLD"]}]
        + [_enq("allreduce_async", f"t{i}", f"u{i}", "SUM")
           for i in range(4)] + [CYCLE]
        + [_wait(f"u{i}", tol=F32_TOL) for i in range(4)])}


def _capacity_evicts(w):
    a = {"c2": _rows(w, 1.0, cols=2), "c3": _rows(w, 1.0, cols=3)}
    steps = [_knob(HOROVOD_CACHE_CAPACITY=1), {"do": "capacity", "value": 1}]
    for rep in range(2):
        steps += [_enq("allreduce_async", "c2", f"a{rep}", "SUM"), CYCLE,
                  _wait(f"a{rep}", tol=F32_TOL),
                  _enq("allreduce_async", "c3", f"b{rep}", "SUM"), CYCLE,
                  _wait(f"b{rep}", tol=F32_TOL)]
    return {"arrays": a, "steps": steps}


def _grouped(name, args, op="SUM"):
    return {"do": "enqueue", "fn": "grouped_allreduce_async", "args": args,
            "name": name, "kw": {"op": op}}


def _disable_group_fusion(w):
    a = {"s1": _rows(w, 1.0), "s2": _rows(w, 2.0), "s3": _rows(w, 3.0)}
    return {"arrays": a, "steps": [
        _knob(HOROVOD_DISABLE_GROUP_FUSION=True),
        _grouped("grp", ["s1", "s2"]),
        _enq("allreduce_async", "s3", "lone", "SUM"), CYCLE,
        _wait("grp", tol=F32_TOL), _wait("lone", tol=F32_TOL),
        _knob(HOROVOD_DISABLE_GROUP_FUSION=False),
        _grouped("grp2", ["s1", "s2"]),
        _enq("allreduce_async", "s3", "lone2", "SUM"), CYCLE,
        _wait("grp2", tol=F32_TOL), _wait("lone2", tol=F32_TOL)]}


def _group_atomic(w):
    a = {"b1": _rows(w, 1.0, cols=16), "b2": _rows(w, 2.0, cols=16)}
    return {"arrays": a, "steps": [
        _knob(HOROVOD_FUSION_THRESHOLD=100),
        _grouped("bigGrp", ["b1", "b2"]), CYCLE,
        _wait("bigGrp", tol=F32_TOL)]}


def _batch_memcopies(w):
    a = {"m0": _rows(w, 1.0), "m1": _rows(w, 2.0)}
    return {"arrays": a, "steps": [
        _enq("allreduce_async", "m0", "m0", "SUM"),
        _enq("allreduce_async", "m1", "m1", "SUM"), CYCLE,
        _wait("m0", tol=F32_TOL), _wait("m1", tol=F32_TOL),
        _knob(HOROVOD_BATCH_D2D_MEMCOPIES=False),
        _enq("allreduce_async", "m0", "n0", "SUM"),
        _enq("allreduce_async", "m1", "n1", "SUM"), CYCLE,
        _wait("n0", tol=F32_TOL), _wait("n1", tol=F32_TOL)]}


def _async_completion(w):
    return {"arrays": {"x": _rows(w, 4.0)}, "steps": [
        _knob(HOROVOD_ENABLE_ASYNC_COMPLETION=False),
        _enq("allreduce_async", "x", "syncdone", "SUM"), CYCLE,
        {"do": "done", "name": "syncdone"}, _wait("syncdone", tol=F32_TOL)]}


def _num_streams(w):
    a = {"x1": _rows(w, 1.0), "x2": _rows(w, 2.0)}
    return {"arrays": a, "steps": [
        _knob(HOROVOD_NUM_STREAMS=2),
        _enq("allreduce_async", "x1", "st0", "SUM"),
        _enq("allreduce_async", "x2", "st1", "MAX"), CYCLE,
        _wait("st0", tol=F32_TOL), _wait("st1")]}


def _elastic_wraps(w):
    return {"arrays": {"x": np.ones((w, 3), np.float32)}, "cache": False,
            "steps": [
                _knob(HOROVOD_ELASTIC=True),
                _enq("alltoall_async", "x", "badsplit"), CYCLE,
                _wait("badsplit", raises=True),
                _knob(HOROVOD_ELASTIC=False),
                _enq("alltoall_async", "x", "badsplit2"), CYCLE,
                _wait("badsplit2", raises=True)]}


def _duplicate_name(w):
    a = {"x1": _rows(w, 1.0), "x2": _rows(w, 2.0), "x3": _rows(w, 3.0)}
    return {"arrays": a, "steps": [
        _enq("allreduce_async", "x1", "dup"),
        dict(_enq("allreduce_async", "x2", "dup"), raises=True), CYCLE,
        _enq("allreduce_async", "x3", "dup", "SUM"), CYCLE,
        _wait("dup", tol=F32_TOL)]}


def _timeline(w, tmp):
    a = {f"tl{i}": _rows(w, float(i)) for i in range(3)}
    return {"arrays": a, "steps": (
        [_knob(HOROVOD_TIMELINE_MARK_CYCLES=True),
         {"do": "timeline_start", "path": os.path.join(tmp, "tl-{rank}.json")}]
        + [_enq("allreduce_async", f"tl{i}", f"tl{i}", "SUM")
           for i in range(3)] + [CYCLE]
        + [_wait(f"tl{i}", tol=F32_TOL) for i in range(3)]
        + [{"do": "timeline_stop"}])}


def _background(w):
    a = {f"bg{i}": _rows(w, i + 1.0) for i in range(4)}
    return {"arrays": a, "lazy": True, "steps": (
        [_enq("allreduce_async", f"bg{i}", f"bg{i}", "SUM")
         for i in range(4)] + [_wait(f"bg{i}", tol=F32_TOL)
                               for i in range(4)])}


def _shutdown_flushes(w):
    return {"arrays": {"x": _rows(w, 2.0)}, "steps": [
        _enq("allreduce_async", "x", "flush", "SUM"),
        {"do": "coord_shutdown"}, _wait("flush", tol=F32_TOL)]}


def _det_defers(w):
    a = {f"det/{i}": _rows(w, float(i)) for i in range(5)}
    return {"arrays": a, "det": True, "steps": (
        [_enq("allreduce_async", f"det/{i}", f"det/{i}", "SUM")
         for i in range(5)] + [PROBE, _wait("det/0", tol=F32_TOL), PROBE]
        + [_wait(f"det/{i}", tol=F32_TOL) for i in range(1, 5)] + [PROBE])}


def _det_poll(w):
    return {"arrays": {"x": _rows(w, 2.0)}, "det": True, "steps": [
        _enq("allreduce_async", "x", "det/poll", "SUM"), PROBE,
        {"do": "poll", "name": "det/poll", "quiet": True}, PROBE,
        _wait("det/poll", tol=F32_TOL)]}


def _det_threshold(w):
    cols = 512                       # 2 KiB a rank, w x 2 KiB stacked
    a = {f"th/{i}": _rows(w, 1.0, cols=cols) for i in range(4)}
    return {"arrays": a, "det": True, "steps": (
        [_knob(HOROVOD_FUSION_THRESHOLD=3 * w * cols * 4)]
        + [_enq("allreduce_async", f"th/{i}", f"th/{i}", "SUM")
           for i in range(4)] + [PROBE]
        + [_wait(f"th/{i}", tol=F32_TOL) for i in range(4)])}


def _det_floor(w):
    a = {f"fl/{i}": _rows(w, 1.0) for i in range(3)}
    return {"arrays": a, "det": True, "steps": (
        [_knob(HOROVOD_FUSION_THRESHOLD=0), {"do": "min_threshold"}]
        + [_enq("allreduce_async", f"fl/{i}", f"fl/{i}", "SUM")
           for i in range(3)] + [PROBE]
        + [_wait(f"fl/{i}", tol=F32_TOL) for i in range(3)] + [PROBE])}


def _det_join_mask(w):
    x = np.arange(w, dtype=np.float32).reshape(w, 1) * np.ones((1, 4),
                                                               np.float32)
    return {"arrays": {"x": x}, "det": True, "steps": [
        {"do": "join", "rank": w - 1},
        _enq("allreduce_async", "x", "jm/in", "AVERAGE"),
        {"do": "join_clear"},
        _enq("allreduce_async", "x", "jm/after", "AVERAGE"),
        _wait("jm/in", tol=F32_TOL), _wait("jm/after", tol=F32_TOL)]}


def _burst(tag, key, ps=None):
    out = []
    for i in range(4):
        st = _enq("allreduce_async", key, f"{tag}/{i}", "SUM")
        if ps is not None:
            st["ps"] = ps
        out.append(st)
    return out


def _waits(tag, cmp="same"):
    return [_wait(f"{tag}/{i}", cmp=cmp, tol=F32_TOL) for i in range(4)]


def _hier_allreduce(w):
    x = np.random.RandomState(0).randn(w, 7).astype(np.float32)
    return {"arrays": {"x": x}, "mesh": True, "steps": [
        _enq("allreduce_async", "x", "flat", "SUM"), CYCLE,
        _wait("flat", tol=F32_TOL),
        _knob(HOROVOD_HIERARCHICAL_ALLREDUCE=True),
        _enq("allreduce_async", "x", "hier", "SUM"), CYCLE,
        _wait("hier", tol=F32_TOL)]}


def _hier_allgather(w):
    a = {"x": np.arange(w * 3, dtype=np.float32).reshape(w, 3),
         "y": np.arange(w * 2, dtype=np.float32).reshape(w, 2)}
    return {"arrays": a, "mesh": True, "cache": False, "steps": [
        {"do": "call", "fn": "allgather", "arg": "x", "out": "flat"},
        _knob(HOROVOD_HIERARCHICAL_ALLGATHER=True),
        {"do": "call", "fn": "allgather", "arg": "x", "out": "hier"},
        _enq("allgather_async", "x", "hx"), _enq("allgather_async", "y", "hy"),
        CYCLE, _wait("hx"), _wait("hy")]}


def _per_axis(w):
    a = {"x": np.ones((w, 512), np.float32)}     # 8 KiB stacked at w=4
    return {"arrays": a, "mesh": True, "sets": [[0, 1], [0, 2]], "steps": (
        [_knob(HOROVOD_FUSION_THRESHOLD={"local": 1 << 20,
                                         "cross": 16 << 10})]
        + _burst("globl", "x") + [CYCLE] + _waits("globl")
        + _burst("local", "x", ps=0) + [CYCLE] + _waits("local", "rank")
        + _burst("span", "x", ps=1) + [CYCLE] + _waits("span", "rank"))}


def _cross_override(w):
    a = {"x": np.ones((w, 512), np.float32)}
    return {"arrays": a, "mesh": True, "steps": (
        [_knob(HOROVOD_FUSION_THRESHOLD=1 << 20,
               HOROVOD_FUSION_THRESHOLD_CROSS=16 << 10),
         {"do": "threshold_for", "kind": "local"},
         {"do": "threshold_for", "kind": "cross"}]
        + _burst("co", "x") + [CYCLE] + _waits("co"))}


# name -> (script maker, worlds); ``mesh`` scripts run on (2, 2) only
SCRIPTS = {
    "async_allreduces_fuse_into_one_program": (_fuse_one, WORLDS),
    "cache_hit_on_steady_state": (_cache_steady, WORLDS),
    "mixed_ops_split_programs": (_mixed_ops, WORLDS),
    "mixed_dtypes_share_one_program": (_mixed_dtypes, WORLDS),
    "partial_group_deferred_until_complete": (_partial_group, WORLDS),
    "allgather_fused": (_allgather_fused, WORLDS),
    "subgroup_allgather_async_routes_member_path": (_subgroup_allgather,
                                                    WORLDS),
    "alltoall_never_fused": (_alltoall_never_fused, WORLDS),
    "fusion_threshold_limits_bins": (_threshold_limits, WORLDS),
    "cache_capacity_evicts": (_capacity_evicts, WORLDS),
    "disable_group_fusion": (_disable_group_fusion, WORLDS),
    "group_atomic_within_bin": (_group_atomic, WORLDS),
    "batch_memcopies_knob_changes_signature": (_batch_memcopies, WORLDS),
    "async_completion_knob": (_async_completion, WORLDS),
    "num_streams_parallel_dispatch": (_num_streams, WORLDS),
    "elastic_knob_wraps_errors": (_elastic_wraps, (2, 4)),
    "duplicate_name_rejected": (_duplicate_name, WORLDS),
    "timeline_cycle_spans": (None, WORLDS),
    "background_thread_resolves": (_background, WORLDS),
    "shutdown_flushes_queue": (_shutdown_flushes, WORLDS),
    "deterministic_mode_defers_and_fuses_at_synchronize": (_det_defers,
                                                           WORLDS),
    "deterministic_mode_poll_flushes": (_det_poll, WORLDS),
    "deterministic_mode_threshold_flush": (_det_threshold, WORLDS),
    "deterministic_flush_floor": (_det_floor, WORLDS),
    "deterministic_mode_join_mask_snapshotted_at_enqueue": (_det_join_mask,
                                                            (2, 4)),
    "hierarchical_allreduce_knob_on_2d_mesh": (_hier_allreduce, (4,)),
    "hierarchical_allgather_knob_on_2d_mesh": (_hier_allgather, (4,)),
    "per_axis_thresholds_change_bin_plans": (_per_axis, (4,)),
    "cross_threshold_env_override": (_cross_override, (4,)),
}
CASES = [(name, w) for name, (_, ws) in SCRIPTS.items() for w in ws]


def _script(name, w, tmp):
    maker = SCRIPTS[name][0]
    return _timeline(w, tmp) if maker is None else maker(w)


# ---------------------------------------------------------------------------
# the worlds (one per W for the module) and the JAX side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the three worlds at once; ``worlds[w](name, rank)`` loads a
    script's result (joining that world on first use)."""
    loads = {}
    for w in WORLDS:
        out = tmp_path_factory.mktemp(f"coord{w}")
        flat, mesh = [], []
        for name, (_, ws) in SCRIPTS.items():
            if w not in ws:
                continue
            sc = dict(_script(name, w, str(out)), kind="coord", name=name)
            (mesh if sc.get("mesh") else flat).append(sc)
        phases = [{"threads": 1, "scenarios": [
            sc for sc in flat if not sc.get("sets")]}]
        for sc in flat:
            if sc.get("sets"):
                phases.append({"threads": 1, "sets": sc["sets"],
                               "scenarios": [sc]})
        if mesh:
            phases.append({"threads": 1, "init": {"mesh_shape": (2, 2)},
                           "sets": [[0, 1], [0, 2]], "scenarios": mesh})
        loads[w] = (workers.run_phases(w, phases, out), str(out))
    return loads


class _JaxCoordAPI:
    """``run_coord_script``'s adapter over the JAX package (the whole
    rank-stacked arrays)."""

    def __init__(self, sc, coord, sets):
        from horovod_tpu.config import knobs
        from horovod_tpu.runtime.context import get_context
        self.sc, self.coord, self.sets = sc, coord, sets
        self.knobs, self.ctx = knobs, get_context()

    def arr(self, key):
        return jnp.asarray(self.sc["arrays"][key])

    def ps(self, i):
        return self.sets[i]

    def op(self, name):
        return hvd.ReduceOp[name]

    def call(self, fn, x, kw):
        return getattr(hvd, fn)(x, **kw)

    def enqueue_raw(self, op_type, x, name, kw):
        from horovod_tpu.eager import _enqueue_async
        return _enqueue_async(op_type, x, name, **kw)

    def to_np(self, v):
        if isinstance(v, (list, tuple)):
            return [self.to_np(e) for e in v]
        return np.asarray(v)

    def timeline(self, path):
        if path is None:
            hvd.stop_timeline()
        else:
            hvd.start_timeline(path.format(rank="jax"))


def run_jax(sc, w):
    """The script through the JAX coordinator on ``w`` devices: thread-less
    (or the context's own under ``lazy`` in a world of one), deterministic
    where the port's is."""
    from horovod_tpu.ops.coordinator import Coordinator, get_coordinator
    from horovod_tpu.runtime.context import get_context
    hvd.init(devices=jax.devices()[:w],
             mesh_shape=(2, 2) if sc.get("mesh") else None)
    try:
        ctx = get_context()
        sets = [hvd.add_process_set(r) for r in sc.get("sets") or ()]
        if sc.get("lazy") and w == 1:
            coord = get_coordinator(ctx)
        else:
            coord = Coordinator(ctx, start_thread=False)
            ctx.coordinator = coord
        if sc.get("det") or w > 1:
            coord.deterministic = True
        cache0 = (coord.cache.hits, coord.cache.misses, coord.cache.evictions)
        res = workers.run_coord_script(sc, _JaxCoordAPI(sc, coord, sets))
        res["cache"] = [a - b for a, b in zip(res["cache"], cache0)]
        return res
    finally:
        hvd.shutdown()


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol and np.issubdtype(want.dtype, np.floating):
        lim = tol * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got.astype(np.float64) - want).max()) <= lim, \
            what
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want), what


def _check_values(sc, port, jres, w):
    """Every kept value of the script on every rank against the JAX
    result by the step's ``cmp``: ``same`` (the JAX result on every rank),
    ``rank`` (row r), ``members`` (members get the JAX result, the others
    their own row of ``own``)."""
    for st in sc["steps"]:
        if st["do"] not in ("wait", "call") or st.get("raises") \
                or "out" not in st:
            continue
        key, want = st["out"], jres["values"][st["out"]]
        for r in range(w):
            got = ([port[r][f"{key}|{i}"] for i in range(len(want))]
                   if isinstance(want, list) else port[r][key])
            cmp = st.get("cmp", "same")
            if cmp == "rank":
                ref = np.asarray(want)[r]
            elif cmp == "members":
                members = sc["sets"][st["members"]]
                ref = want if r in members else sc["arrays"][st["own"]][r]
            else:
                ref = want
            if isinstance(ref, list):
                for i, (g, x) in enumerate(zip(got, ref)):
                    _close(g, x, st.get("tol", 0.0), f"{key}|{i} rank {r}")
            else:
                _close(got, ref, st.get("tol", 0.0), f"{key} rank {r}")


@pytest.mark.parametrize("name,w", CASES,
                         ids=[f"{n}-w{w}" for n, w in CASES])
def test_coordinator_matches_jax(worlds, name, w):
    load, out_dir = worlds[w]
    sc = _script(name, w, out_dir)
    sc["name"] = name
    jres = run_jax(sc, w)
    port = [dict(load(name, r)) for r in range(w)]
    recs = [json.loads(str(p["record"])) for p in port]
    thread_mode = bool(sc.get("lazy")) and w == 1
    for r, rec in enumerate(recs):
        if not thread_mode:     # the cycle thread's bins follow its clock
            assert rec["bins"] == jres["bins"], (r, rec["bins"])
            assert rec["stats"] == jres["stats"], (r, rec["stats"])
            if sc.get("cache", True):
                assert rec["cache"] == jres["cache"], (r, rec["cache"])
        assert rec["records"] == jres["records"], (r, rec["records"])
        # a cycle thread runs exactly in a world of one under lazy
        assert rec["thread"] == [thread_mode, False]
    _check_values(sc, port, jres, w)
    if name == "timeline_cycle_spans":
        jev = json.load(open(os.path.join(out_dir, "tl-jax.json")))
        jcats = {e.get("cat") for e in jev if isinstance(e, dict)}
        for r in range(w):
            ev = json.load(open(os.path.join(out_dir, f"tl-{r}.json")))
            cats = {e.get("cat") for e in ev if isinstance(e, dict)}
            names = {e.get("name") for e in ev if isinstance(e, dict)}
            assert {"QUEUE", "MEMCPY_IN_FUSION_BUFFER",
                    "DISPATCH"} <= cats
            # the port's divergence checks (several ranks) add NEGOTIATE;
            # the forced-deterministic JAX coordinator has no checker
            assert cats - {"NEGOTIATE"} == jcats
            assert ("NEGOTIATE" in cats) == (w > 1)
            assert "CYCLE" in names and {f"tl{i}" for i in range(3)} <= names


# ---------------------------------------------------------------------------
# the rest of the contract, in a world of one in this process
# ---------------------------------------------------------------------------

@pytest.fixture()
def port_ctx():
    import horovod_tpu_torch as htt
    ctx = htt.init(device="cpu")
    yield ctx
    htt.shutdown()


def _manual(ctx, det=False):
    from horovod_tpu_torch.ops.coordinator import Coordinator
    coord = Coordinator(ctx, start_thread=False)
    coord.deterministic = det
    ctx.coordinator = coord
    return coord


def test_fusion_threshold_parse_forms(monkeypatch):
    """tests/test_coordinator.py::test_fusion_threshold_parse_forms, both
    registries (one environment configures both packages)."""
    from horovod_tpu.config import knobs as jknobs
    from horovod_tpu_torch.config import knobs
    for reg in (knobs, jknobs):
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "64MB")
        assert reg.get("HOROVOD_FUSION_THRESHOLD") == 64 * 1024 * 1024
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "local:1MB,cross:16KB")
        assert reg.get("HOROVOD_FUSION_THRESHOLD") == {
            "local": 1 << 20, "cross": 16 << 10}
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "foo:1MB")
        with pytest.raises(ValueError, match="local/cross"):
            reg.get("HOROVOD_FUSION_THRESHOLD")
    monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD")
    for name in ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_FUSION_THRESHOLD_CROSS",
                 "HOROVOD_CYCLE_TIME", "HOROVOD_CACHE_CAPACITY",
                 "HOROVOD_TIMELINE", "HOROVOD_TIMELINE_MARK_CYCLES",
                 "HOROVOD_DIVERGENCE_CHECK_EVERY",
                 "HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL",
                 "HOROVOD_DIVERGENCE_TIMEOUT", "HOROVOD_DISABLE_GROUP_FUSION",
                 "HOROVOD_ENABLE_ASYNC_COMPLETION", "HOROVOD_NUM_STREAMS",
                 "HOROVOD_TPU_NATIVE", "HOROVOD_AUTOTUNE"):
        assert knobs.get(name) == jknobs.get(name), name


@pytest.mark.parametrize("knob,value", [("HOROVOD_AUTOTUNE", "1"),
                                        ("HOROVOD_ARTIFACT_STORE", "/tmp/s")])
def test_unported_knobs_make_the_coordinator_raise(port_ctx, monkeypatch,
                                                   tmp_path, knob, value):
    """Both knobs the coordinator once refused are ported. HOROVOD_AUTOTUNE
    (tests/test_coordinator.py::test_autotune_driven_by_cycle): the
    tuner is fed by the cycle, overrides the knobs the planner reads next
    and converges. The artifact store: a coordinator built with it
    dispatches, a plan it built is published, and a fresh coordinator
    reads the plan back instead of building it."""
    import torch
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.store import artifact_store
    if knob == "HOROVOD_AUTOTUNE":
        for k, v in ((knob, value), ("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "0"),
                     ("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "1"),
                     ("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "3")):
            monkeypatch.setenv(k, v)
        coord = _manual(port_ctx)
        assert coord.autotune.enabled and coord._param_sync is None
        tuned = ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_CYCLE_TIME")
        before = tuple(knobs.get(k) for k in tuned)
        try:
            changed = False
            for i in range(6):
                h = htt.allreduce_async(torch.full((3,), float(i)),
                                        op=htt.Sum, name=f"at{i}")
                coord.run_cycle()
                torch.testing.assert_close(h.wait(),
                                           torch.full((3,), float(i)))
                changed = changed or tuple(knobs.get(k)
                                           for k in tuned) != before
            assert changed and coord.autotune.converged
            assert coord.autotune._samples == 3
        finally:
            coord.shutdown()
            port_ctx.coordinator = None
            knobs.clear_all_overrides()
        return
    monkeypatch.setenv(knob, str(tmp_path / value.strip("/")))
    artifact_store.reset_for_tests()
    try:
        counts = []
        for _ in range(2):
            coord = _manual(port_ctx)
            h = htt.allreduce_async(torch.ones(3), name="st")
            coord.run_cycle()
            torch.testing.assert_close(h.wait(), torch.ones(3))
            snap = coord.cache.snapshot()
            counts.append((snap["builds"], snap["store_hits"]))
            coord.shutdown()
            port_ctx.coordinator = None
        assert counts == [(1, 0), (0, 1)]
        assert artifact_store.store_stats()["publishes"] == 1
    finally:
        artifact_store.reset_for_tests()


def test_reset_resolves_queued_handles_and_stays_usable(port_ctx):
    """Coordinator.reset (through eager.reset_outstanding, as the elastic
    reset and the live resize call it) resolves every queued handle with
    ResizeInterrupt; the coordinator then serves new requests."""
    import torch
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import eager
    from horovod_tpu_torch.elastic import ResizeInterrupt
    coord = _manual(port_ctx)
    hs = [htt.allreduce_async(torch.ones(3), name=f"r{i}") for i in range(2)]
    assert eager.reset_outstanding() >= 2
    for h in hs:
        with pytest.raises(ResizeInterrupt):
            h.wait()
    assert len(coord.queue) == 0
    h = htt.allreduce_async(torch.ones(3), op=htt.Sum, name="r0")
    coord.run_cycle()
    assert torch.equal(h.wait(), torch.ones(3))


def test_deterministic_stall_clock_starts_at_dispatch(port_ctx):
    import torch
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.stall_inspector import get_stall_inspector
    insp = get_stall_inspector()
    insp.reset()
    coord = _manual(port_ctx, det=True)
    h = htt.allreduce_async(torch.ones(3), name="parked")
    assert insp.pending_count() == 0          # parked: not a stall
    coord.run_cycle()
    assert insp.pending_count() == 1          # dispatched: tracked
    h.wait()
    assert insp.pending_count() == 0


def test_queued_bytes_collector_and_cycle_metrics(port_ctx):
    """hvd_queued_bytes is read when the metrics are scraped: the queued
    bytes every rank shares (world x a rank's; gathers left out)."""
    import torch
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import metrics as M
    coord = _manual(port_ctx, det=True)
    reg = M.get_registry()
    cycles0 = reg.get("hvd_cycles_total").value
    hs = [htt.allreduce_async(torch.ones(16), name="qb"),
          htt.allgather_async(torch.ones(5), name="qg")]
    M.metrics_snapshot()
    assert reg.get("hvd_queued_bytes").value == 64
    coord.run_cycle()
    M.metrics_snapshot()
    assert reg.get("hvd_queued_bytes").value == 0
    assert reg.get("hvd_cycles_total").value == cycles0 + 1
    assert reg.get("hvd_bytes_reduced_total").value >= 84
    for h in hs:
        h.wait()


def test_results_are_copies_and_plans_hold_no_buffers(port_ctx):
    """A result outlives the next cycle on the same fusion buffer (it was
    copied out); the buffer is the coordinator's, one per dtype, and an
    evicted plan leaves it in place."""
    import torch
    import horovod_tpu_torch as htt
    coord = _manual(port_ctx)
    coord.cache.capacity = 1
    hs = [htt.allreduce_async(torch.full((4,), float(i)), op=htt.Sum,
                              name=f"c{i}") for i in range(2)]
    coord.run_cycle()
    first = [h.wait() for h in hs]
    assert coord.buffers.nbytes() == 8 * 4    # the persistent buffer
    (plan,) = coord.cache._d.values()
    assert not hasattr(plan, "buffers")
    hs = [htt.allreduce_async(torch.full((4,), 9.0), op=htt.Sum,
                              name=f"c{i}") for i in range(2)]
    coord.run_cycle()
    [h.wait() for h in hs]
    assert [float(t[0]) for t in first] == [0.0, 1.0]
    hs = [htt.allreduce_async(torch.ones(6), op=htt.Sum, name=f"d{i}")
          for i in range(2)]
    coord.run_cycle()
    assert [h.wait().tolist() for h in hs] == [[1.0] * 6] * 2
    assert coord.cache.evictions == 1 and len(coord.cache) == 1
    assert coord.buffers.nbytes() == 16 * 4   # doubled once, still one


@pytest.mark.parametrize("threshold", [256, 4096])
def test_fusion_buffers_stay_under_the_threshold(port_ctx, threshold):
    """Many distinct bin signatures (every cycle new shapes, two dtypes)
    fill the plan cache, but the coordinator's fusion buffers stay one per
    dtype and within the fusion threshold; a registered group larger than
    the threshold packs into a buffer that is not kept."""
    import torch
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.config import knobs
    knobs.set_override("HOROVOD_FUSION_THRESHOLD", threshold)
    try:
        coord = _manual(port_ctx)
        for k in range(40):
            n = 1 + k
            hs = [htt.allreduce_async(torch.full((n + j,), float(j), dtype=dt),
                                      op=htt.Sum, name=f"s{k}.{j}.{dt}")
                  for j in range(3) for dt in (torch.float32, torch.int32)]
            coord.run_cycle()
            for h, (j, dt) in zip(hs, [(j, dt) for j in range(3)
                                       for dt in (torch.float32,
                                                  torch.int32)]):
                assert torch.equal(h.wait(),
                                   torch.full((n + j,), float(j), dtype=dt))
            assert coord.buffers.nbytes() <= 2 * threshold
            assert all(t.numel() * t.element_size() <= threshold
                       for t, _ in coord.buffers._bufs.values())
        assert len(coord.cache) >= 40 and len(coord.buffers._bufs) == 2
        before = coord.buffers.nbytes()
        big = [torch.full((threshold // 4,), float(i)) for i in range(3)]
        h = htt.grouped_allreduce_async(big, op=htt.Sum, name="big")
        coord.run_cycle()
        assert all(torch.equal(a, b) for a, b in zip(h.wait(), big))
        assert coord.buffers.nbytes() == before
    finally:
        knobs.clear_override("HOROVOD_FUSION_THRESHOLD")
