"""The port's eager API (``horovod_tpu_torch.eager``: join, async
handles, the collectives reading the join registry) against the JAX
package's, on the CPU.

Every scenario is one script of eager calls, run by both packages: the
port's ranks run it in ONE spawned 8-rank gloo world
(``test_torch_workers.phase_worker``, scenario kind ``eager``), each rank
on its own row of the rank-stacked inputs; the JAX side runs the same
calls on the rank-stacked inputs with ``hvd.init(devices=
jax.devices()[:8])`` (:func:`run_jax`). The scenarios replay
``tests/test_join.py`` (less its three Adasum cases, which
``test_torch_adasum.py`` has) and the async-handle cases of
``tests/test_collectives.py`` (l.322, 331), with the grouped and uneven
async forms; and, in one process, the stall inspector against the JAX
package's. Both packages dispatch an async op through their cycle
coordinators (the port's deterministic in its 8-rank world) and snapshot
the join registry at the enqueue. Tolerances: movement, integers, MIN/MAX and join's
results bitwise; f32 sums and averages within 1e-6 of the largest value
of the result (sums in another order differ in their last bits).
"""

import signal

import numpy as np
import pytest

import jax

import horovod_tpu as hvd
import test_torch_workers as workers

W = 8
LIMIT_S = 150
SETS = [[1, 3, 5, 7], [0, 2], [2, 4, 6], [1, 4, 6], [1, 2], [0, 1, 2]]


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
# the JAX side of a script, and the comparison
# ---------------------------------------------------------------------------

def run_jax(steps, sets=(), mesh_shape=None, world=W):
    """The script on the JAX eager API: every step's ``fn`` from
    ``horovod_tpu`` on the whole rank-stacked arguments (``rank_kw`` whole
    too; ``jax_kw`` overrides). Returns ``{out: result}``."""
    from horovod_tpu.runtime.context import get_context
    hvd.init(devices=jax.devices()[:world], mesh_shape=mesh_shape)
    try:
        jsets = [hvd.add_process_set(r) for r in sets]
        env, res = {}, {}
        for st in steps:
            ps = jsets[st["ps"]] if "ps" in st else None
            if st["fn"] == "clear_registry":
                (ps.joined_ranks if ps is not None
                 else get_context().joined_ranks).clear()
                continue
            if st["fn"] == "reregister":
                hvd.remove_process_set(ps)
                jsets[st["ps"]] = hvd.add_process_set(ps)
                continue
            args = list(st.get("args", ()))
            if st.get("as_list"):
                args = [args]
            if "ref" in st:
                args.insert(0, env[st["ref"]])
            kw = dict(st.get("kw", {}))
            kw.update(st.get("rank_kw", {}))
            kw.update(st.get("jax_kw", {}))
            if "op" in kw:
                kw["op"] = hvd.ReduceOp[kw["op"]]
            if ps is not None:
                kw["process_set"] = ps
            try:
                out = getattr(hvd, st["fn"])(*args, **kw)
            except (NotImplementedError, ValueError) as e:
                if not st.get("raises"):
                    raise
                out = f"{type(e).__name__}: {e}"
            if "save" in st:
                env[st["save"]] = out
            if "out" in st:
                res[st["out"]] = out
        return res
    finally:
        hvd.shutdown()


def port_outs(world, name, world_size=W):
    return [dict(world(name, r)) for r in range(world_size)]


def check(port, jres, steps, world_size=W):
    """Each step's ``out`` on every rank against the JAX result by the
    step's ``cmp``: ``same`` (default: every rank gets the JAX result),
    ``rank`` (rank r gets the JAX result's row r), ``members`` (the ranks
    of the step's ``members`` get the JAX result, the others their own
    row of ``own``, else of the first argument; ``others="skip"``: not
    compared) or ``set`` (member j gets the JAX result's row j, the others
    as for ``members``). ``tol`` (relative to the largest value) for f32
    sums; exact otherwise. List results compare part by part."""
    for st in steps:
        if "out" not in st:
            continue
        key, want = st["out"], jres[st["out"]]
        cmp = st.get("cmp", "same")
        members = st.get("members")
        for r in range(world_size):
            if cmp == "rank":
                w = want[r]
            elif cmp in ("members", "set"):
                if r not in members:
                    if st.get("others") == "skip":
                        continue
                    w = st.get("own", st.get("args", [None]))[0][r]
                else:
                    w = want if cmp == "members" else \
                        want[members.index(r)]
            else:
                w = want
            _close(port[r], key, w, st.get("tol"), f"{key} rank {r}")


def _close(got, key, want, tol, what):
    if isinstance(want, str):
        assert str(got[key]).split(":")[0] == want.split(":")[0], (what,
                                                                   got[key])
        return
    if isinstance(want, (list, tuple)):
        for i, w in enumerate(want):
            _close(got, f"{key}|{i}", w, tol, f"{what}[{i}]")
        return
    want = np.asarray(want)
    g = np.asarray(got[key])
    assert g.shape == want.shape, (what, g.shape, want.shape)
    if tol is None:
        np.testing.assert_array_equal(g, want, err_msg=what)
    else:
        scale = float(np.max(np.abs(want))) if want.size else 0.0
        np.testing.assert_allclose(g, want, rtol=0, atol=tol * scale,
                                   err_msg=what)


# ---------------------------------------------------------------------------
# the scenarios (tests/test_join.py, tests/test_collectives.py)
# ---------------------------------------------------------------------------

def _data():
    rng = np.random.RandomState(0)
    return rng.randn(W, 5, 4).astype(np.float32)


BATCHES = [3, 5, 2, 5, 4, 1, 5, 3]


def _uneven_epoch():
    data = _data()
    steps = []
    for step in range(max(BATCHES)):
        for r in range(W):
            if BATCHES[r] == step:
                steps.append(dict(fn="join", kw={"rank": r},
                                  out=f"join{step}_{r}"))
        steps.append(dict(fn="allreduce", args=[data[:, step]],
                          kw={"op": "AVERAGE"}, out=f"s{step}", tol=1e-6))
    steps += [dict(fn="join", out="final"),
              dict(fn="allreduce", args=[data[:, 0]], kw={"op": "AVERAGE"},
                   out="after", tol=1e-6)]
    return steps


def _x():
    return np.arange(W, dtype=np.float32).reshape(W, 1)


def _rows(width=2):
    return np.stack([np.full((width,), r, np.float32) for r in range(W)])


def _identities():
    x = np.stack([np.full((3,), float(r + 1), np.float32) for r in range(W)])
    return [dict(fn="join", kw={"rank": 7}, out="j7"),
            dict(fn="allreduce", args=[x], kw={"op": "MIN"}, out="min"),
            dict(fn="allreduce", args=[x], kw={"op": "MAX"}, out="max"),
            dict(fn="allreduce", args=[x], kw={"op": "PRODUCT"}, out="prod"),
            dict(fn="allreduce", args=[x], kw={"op": "SUM"}, out="sum"),
            dict(fn="join", out="last"),
            dict(fn="allreduce", args=[x], kw={"op": "SUM"}, out="after")]


def _drop_rows():
    x = np.arange(W * 2, dtype=np.float32).reshape(W, 2)
    return [dict(fn="join", kw={"rank": [0, 5]}, out="j"),
            dict(fn="allgather", args=[x], out="gathered"),
            dict(fn="join", out="last")]


def _async_joined():
    x = np.stack([np.full((4,), float(r), np.float32) for r in range(W)])
    return [dict(fn="allreduce_async", args=[x], kw={"op": "AVERAGE",
                                                     "name": "all"},
                 save="h1"),
            dict(fn="synchronize", ref="h1", out="all", tol=1e-6),
            dict(fn="join", kw={"rank": 2}, out="j2"),
            dict(fn="allreduce_async", args=[x], kw={"op": "AVERAGE",
                                                     "name": "joined"},
                 save="h2"),
            dict(fn="synchronize", ref="h2", out="joined", tol=1e-6),
            dict(fn="join", out="last")]


def _bad_rank():
    return [dict(fn="join", kw={"rank": 99}, raises=True, out="err")]


def _subgroup_average():
    return [dict(fn="join", ps=0, kw={"rank": 3}, out="j3"),
            dict(fn="allreduce", ps=0, args=[_x()], kw={"op": "AVERAGE"},
                 out="avg", cmp="rank", tol=1e-6),
            dict(fn="clear_registry", ps=0)]


def _subgroup_no_leak():
    return [dict(fn="join", ps=1, kw={"rank": 0}, out="j0"),
            dict(fn="allreduce", args=[_x()], kw={"op": "AVERAGE"},
                 out="global", tol=1e-6),
            dict(fn="join", ps=1, kw={"rank": 2}, out="last")]


def _subgroup_min():
    return [dict(fn="join", ps=2, kw={"rank": 4}, out="j4"),
            dict(fn="allreduce", ps=2, args=[_x()], kw={"op": "MIN"},
                 out="min", cmp="rank"),
            dict(fn="clear_registry", ps=2)]


def _subgroup_gather():
    return [dict(fn="join", ps=3, kw={"rank": 4}, out="j4"),
            dict(fn="allgather", ps=3, args=[_rows()], out="gathered",
                 cmp="members", members=SETS[3]),
            dict(fn="clear_registry", ps=3)]


def _subgroup_non_member():
    return [dict(fn="join", ps=4, kw={"rank": 5}, raises=True, out="err")]


def _subgroup_async_snapshot():
    return [dict(fn="join", ps=5, kw={"rank": 2}, out="j2"),
            dict(fn="allreduce_async", ps=5, args=[_x()],
                 kw={"op": "AVERAGE", "name": "sj/in"}, save="h"),
            dict(fn="clear_registry", ps=5),
            dict(fn="synchronize", ref="h", out="avg", cmp="rank",
                 tol=1e-6)]


def _subgroup_grouped():
    x = _x()
    return [dict(fn="join", ps=0, kw={"rank": 3}, out="j3"),
            dict(fn="grouped_allreduce", ps=0, args=[x, 2 * x],
                 as_list=True, kw={"op": "AVERAGE"}, out="grouped"),
            dict(fn="clear_registry", ps=0)]


def _async_gather_snapshot():
    return [dict(fn="join", ps=5, kw={"rank": 1}, out="j1"),
            dict(fn="allgather_async", ps=5, args=[_rows()],
                 kw={"name": "jg/in"}, save="h"),
            dict(fn="join", ps=5, kw={"rank": 0}, out="j0"),
            dict(fn="join", ps=5, kw={"rank": 2}, out="j2"),
            dict(fn="synchronize", ref="h", out="gathered", cmp="members",
                 members=SETS[5], own=[_rows()])]


def _global_async_gather():
    x = np.stack([np.full((1,), r, np.float32) for r in range(W)])
    return [dict(fn="join", kw={"rank": 4}, out="j4"),
            dict(fn="allgather_async", args=[x], kw={"name": "jg/global"},
                 save="h"),
            dict(fn="synchronize", ref="h", out="gathered"),
            dict(fn="clear_registry")]


def _reregistered():
    return [dict(fn="join", ps=4, kw={"rank": 1}, out="j1"),
            dict(fn="reregister", ps=4),
            dict(fn="allreduce", ps=4, args=[_x()], kw={"op": "AVERAGE"},
                 out="avg", cmp="rank", tol=1e-6)]


def _handles():
    rng = np.random.RandomState(1)
    x = rng.randn(W, 3).astype(np.float32)
    parts = [rng.randn(2 + r % 3, 3).astype(np.float32) for r in range(W)]
    split = np.asarray([[(r + d) % 3 for d in range(W)] for r in range(W)])
    a2a = [np.arange(int(split[r].sum()) * 2, dtype=np.float32).reshape(
        -1, 2) + 100 * r for r in range(W)]
    rs = rng.randn(W, 2 * W + 3, 2).astype(np.float32)
    ints = rng.randint(-50, 50, (W, 6)).astype(np.int32)
    return [dict(fn="allreduce_async", args=[x], kw={"op": "SUM",
                                                     "name": "grad/w1"},
                 save="h", out="name"),
            dict(fn="synchronize", ref="h", out="sum", tol=1e-6),
            dict(fn="poll", ref="h", out="polled"),
            dict(fn="allreduce_async", args=[x], save="a1", out="auto1"),
            dict(fn="allreduce_async", args=[x], save="a2", out="auto2"),
            dict(fn="synchronize", ref="a1"),
            dict(fn="synchronize", ref="a2"),
            dict(fn="grouped_allreduce_async", args=[x, ints],
                 as_list=True, kw={"op": "SUM"}, save="g"),
            dict(fn="synchronize", ref="g", out="grouped", tol=1e-6),
            dict(fn="allgather_async", args=[parts], save="ag"),
            dict(fn="synchronize", ref="ag", out="allgatherv"),
            dict(fn="alltoall_async", args=[a2a], rank_kw={"splits": split},
                 save="aa"),
            dict(fn="synchronize", ref="aa", out="alltoallv",
                 cmp="alltoallv"),
            dict(fn="reducescatter_async", args=[rs], kw={"op": "SUM"},
                 save="rs"),
            dict(fn="synchronize", ref="rs", out="reducescatter",
                 cmp="rank", tol=1e-6),
            dict(fn="broadcast_async", args=[x], kw={"root_rank": 5},
                 save="bc"),
            dict(fn="synchronize", ref="bc", out="broadcast"),
            dict(fn="barrier"),
            dict(fn="join", out="join")]


SCENARIOS = {
    "uneven_epoch": _uneven_epoch, "identities": _identities,
    "drop_rows": _drop_rows, "async_joined": _async_joined,
    "bad_rank": _bad_rank, "subgroup_average": _subgroup_average,
    "subgroup_no_leak": _subgroup_no_leak, "subgroup_min": _subgroup_min,
    "subgroup_gather": _subgroup_gather,
    "subgroup_non_member": _subgroup_non_member,
    "subgroup_async_snapshot": _subgroup_async_snapshot,
    "subgroup_grouped": _subgroup_grouped,
    "async_gather_snapshot": _async_gather_snapshot,
    "global_async_gather": _global_async_gather,
    "reregistered": _reregistered, "handles": _handles}
STEPS = {name: fn() for name, fn in SCENARIOS.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    phases = [dict(sets=SETS, scenarios=[
        dict(kind="eager", name=name, steps=steps)
        for name, steps in STEPS.items()])]
    load = workers.run_phases(W, phases, tmp_path_factory.mktemp("eager"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


def _run(world, name):
    steps = STEPS[name]
    port = port_outs(world, name)
    return port, run_jax(steps, SETS), steps


def test_uneven_epoch_with_correct_averages(world):
    """tests/test_join.py::test_uneven_epoch_with_correct_averages: the
    averages at every step cover the active ranks only, every join before
    the last returns -1, the closing join() the last rank to join (the
    remaining ranks join in rank order: 6), and the next epoch averages
    over every rank again."""
    port, jres, steps = _run(world, "uneven_epoch")
    check(port, jres, steps)
    assert int(jres["final"]) == 6


def test_join_identity_elements_min_max_product(world):
    port, jres, steps = _run(world, "identities")
    check(port, jres, steps)
    assert int(jres["last"]) == 6


def test_join_allgather_drops_joined_rows(world):
    port, jres, steps = _run(world, "drop_rows")
    check(port, jres, steps)
    assert np.asarray(jres["gathered"]).shape == (12,)


def test_join_async_snapshots_the_registry(world):
    """tests/test_join.py::test_join_async_through_coordinator: an async
    allreduce issued while rank 2 is joined averages over the others."""
    port, jres, steps = _run(world, "async_joined")
    check(port, jres, steps)


def test_join_bad_rank(world):
    port, jres, steps = _run(world, "bad_rank")
    check(port, jres, steps)


def test_subgroup_join_average_counts_active_members(world):
    port, jres, steps = _run(world, "subgroup_average")
    check(port, jres, steps)
    assert port[1]["avg"][0] == pytest.approx((1 + 5 + 7) / 3)


def test_subgroup_join_does_not_leak_to_global(world):
    port, jres, steps = _run(world, "subgroup_no_leak")
    check(port, jres, steps)
    assert int(port[0]["last"]) == 2


def test_subgroup_join_min_identity(world):
    port, jres, steps = _run(world, "subgroup_min")
    check(port, jres, steps)


def test_subgroup_join_gather_drops_joined_rows(world):
    port, jres, steps = _run(world, "subgroup_gather")
    check(port, jres, steps)
    np.testing.assert_array_equal(port[1]["gathered"], [1, 1, 6, 6])


def test_subgroup_join_rejects_non_member(world):
    port, jres, steps = _run(world, "subgroup_non_member")
    check(port, jres, steps)
    assert "not a member" in str(port[0]["err"])


def test_subgroup_join_async_snapshot(world):
    port, jres, steps = _run(world, "subgroup_async_snapshot")
    check(port, jres, steps)
    assert port[0]["avg"][0] == pytest.approx(0.5)


def test_subgroup_grouped_allreduce_rank_stacked(world):
    steps = STEPS["subgroup_grouped"]
    port = port_outs(world, "subgroup_grouped")
    jres = run_jax(steps, SETS)
    for i, want in enumerate(jres["grouped"]):
        for r in range(W):
            _close(port[r], f"grouped|{i}", np.asarray(want)[r], 1e-6,
                   f"grouped[{i}] rank {r}")


def test_async_allgather_joined_snapshot(world):
    port, jres, steps = _run(world, "async_gather_snapshot")
    check(port, jres, steps)
    np.testing.assert_array_equal(port[0]["gathered"], [0, 0, 2, 2])


def test_global_join_async_allgather_drops_rows(world):
    port, jres, steps = _run(world, "global_async_gather")
    check(port, jres, steps)


def test_reregistered_set_has_fresh_join_registry(world):
    port, jres, steps = _run(world, "reregistered")
    check(port, jres, steps)


def test_async_handles_names_and_the_async_forms(world):
    """tests/test_collectives.py::test_async_handles and
    ::test_async_auto_names_unique, then the grouped and uneven async forms
    (allgatherv, alltoallv, uneven reducescatter) and broadcast, and
    test_join's bare join() (the last rank, 7)."""
    steps = STEPS["handles"]
    port = port_outs(world, "handles")
    jres = run_jax(steps, SETS)
    for r in range(W):
        assert str(port[r]["name"]) == "grad/w1"
        assert bool(port[r]["polled"])
        assert str(port[r]["auto1"]) != str(port[r]["auto2"])
        assert int(port[r]["join"]) == W - 1
    check(port, jres, [s for s in steps if s.get("out") in (
        "sum", "grouped", "allgatherv", "reducescatter", "broadcast")])
    outs, recv = jres["alltoallv"]
    for r in range(W):
        np.testing.assert_array_equal(port[r]["alltoallv|0"],
                                      np.asarray(outs[r]))
        np.testing.assert_array_equal(port[r]["alltoallv|1"],
                                      np.asarray(recv)[r])


def test_stall_inspector_warns_and_aborts_as_the_jax_package_does():
    """The same starts, completions and clock readings through both
    packages' inspectors: the same warnings (once per operation past
    HOROVOD_STALL_CHECK_TIME_SECONDS), the same abort past
    HOROVOD_STALL_SHUTDOWN_TIME_SECONDS (the operation dropped, the
    callback told), and nothing tracked under HOROVOD_STALL_CHECK_DISABLE."""
    from horovod_tpu import stall_inspector as jstall
    from horovod_tpu.config import knobs as jknobs
    from horovod_tpu_torch import stall_inspector as stall
    from horovod_tpu_torch.config import knobs
    now = [0.0]
    outcomes = []
    for mod, reg in ((stall, knobs), (jstall, jknobs)):
        reg.set_override("HOROVOD_STALL_CHECK_TIME_SECONDS", 5)
        reg.set_override("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 20)
        try:
            now[0] = 0.0
            insp = mod.StallInspector(clock=lambda: now[0])
            aborts = []
            insp.set_abort_callback(aborts.append)
            insp.record_start("a")
            insp.record_start("b")
            now[0] = 6.0
            insp.check_for_stalls()
            insp.check_for_stalls()
            seen = [insp.pending_count(), insp.warned_count()]
            insp.record_done("a")
            now[0] = 21.0
            insp.check_for_stalls()
            seen += [insp.pending_count(), insp.warned_count(),
                     insp.stalled_shutdown, len(aborts)]
            insp.reset()
            reg.set_override("HOROVOD_STALL_CHECK_DISABLE", True)
            insp.record_start("c")
            seen.append(insp.pending_count())
            outcomes.append(seen)
        finally:
            for k in ("HOROVOD_STALL_CHECK_TIME_SECONDS",
                      "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
                      "HOROVOD_STALL_CHECK_DISABLE"):
                reg.clear_override(k)
    assert outcomes[0] == outcomes[1] == [2, 2, 0, 1, True, 1, 0]


def test_handle_raises_the_collectives_error_at_wait(monkeypatch):
    """An error of the collective surfaces at ``wait()``, never swallowed
    (the handle is then done), and with HOROVOD_ELASTIC set a work that
    fails surfaces as ``elastic.HorovodInternalError``, the error
    ``elastic.run`` recovers from (the JAX ``eager.py:218-225``), while a
    work that succeeds still returns its result. The wait histogram is a private one here, so the
    process's metrics stay untouched."""
    import torch
    from horovod_tpu_torch import eager
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.elastic import HorovodInternalError
    from horovod_tpu_torch.ops.collectives import _Pending
    hist = M.MetricsRegistry().histogram("t_wait_seconds", "t")
    monkeypatch.setattr(eager, "_wait_hist", lambda: hist)

    def lost():
        raise RuntimeError("peer lost")

    h = eager.Handle("t/err", _Pending([], lost), torch.device("cpu"))
    with pytest.raises(RuntimeError, match="peer lost") as plain:
        eager.synchronize(h)
    assert not isinstance(plain.value, HorovodInternalError)
    assert eager.poll(h)
    class LostWork:                 # a torch.distributed work whose peer died
        def wait(self):
            raise RuntimeError("peer lost")

    ok = eager.Handle("t/ok", _Pending([], lambda: 1), torch.device("cpu"))
    knobs.set_override("HOROVOD_ELASTIC", True)
    try:
        failed = eager.Handle("t/err2", _Pending([LostWork()], lambda: 1),
                              torch.device("cpu"))
        with pytest.raises(HorovodInternalError, match="peer lost"):
            failed.wait()
        assert ok.wait() == 1
    finally:
        knobs.clear_override("HOROVOD_ELASTIC")
    unwrapped = eager.Handle("t/err3", _Pending([LostWork()], lambda: 1),
                             torch.device("cpu"))
    with pytest.raises(RuntimeError, match="peer lost") as plain:
        unwrapped.wait()
    assert not isinstance(plain.value, HorovodInternalError)
    assert hist.total_count == 4
