"""The port's cross-rank divergence check (``horovod_tpu_torch.ops.
divergence``) against the JAX package's, on the CPU.

``tests/test_divergence.py`` replayed: its unit cases run the protocol
over an in-memory KV store (two checkers on two threads), the port's
beside the JAX package's where the outcome is a trajectory (the adaptive
cadence: ``checks`` and ``effective_interval`` flush by flush, equal in
both); its two-process cases run in ONE two-rank gloo world
(``test_torch_workers.run_phases``, scenario kind ``divergence``) over
the c10d store the world rendezvoused on: identical programs pass, a
divergent enqueue raises ``DivergenceError`` on both ranks naming the
tensor and the ranks, a peer that never flushes raises after
``HOROVOD_DIVERGENCE_TIMEOUT`` (3 s here) and never hangs, and a cadence
desync surfaces as a mismatch naming the cadence line, not as a timeout.

A request's signature is this rank's own tensor: its shape and the numpy
name of its dtype, an allgather's or alltoall's first dim as ``*`` (it
may differ between ranks).
"""

import logging
import signal
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu.config import knobs as jknobs
from horovod_tpu.ops import coordinator as jcoord
from horovod_tpu.ops import divergence as jdiv
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.ops.coordinator import Entry
from horovod_tpu_torch.ops.divergence import (DivergenceChecker,
                                              DivergenceError,
                                              entry_signature)
import test_torch_workers as workers

LIMIT_S = 120
TIMEOUT_S = 3


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


class FakeKV:
    """In-memory stand-in for the store (tests/test_divergence.py's)."""

    def __init__(self):
        self._d = {}
        self._cond = threading.Condition()

    def set(self, key, value):
        with self._cond:
            self._d[key] = value
            self._cond.notify_all()

    def get(self, key, timeout_s):
        with self._cond:
            end = time.monotonic() + timeout_s
            while key not in self._d:
                left = end - time.monotonic()
                if left <= 0:
                    raise TimeoutError(key)
                self._cond.wait(left)
            return self._d[key]

    def try_get(self, key):
        with self._cond:
            return self._d.get(key)

    def delete(self, key):
        with self._cond:
            self._d.pop(key, None)


def _entry(name, shape=(4,), op_type="allreduce", dtype=torch.float32):
    return Entry(name=name, op_type=op_type, x=torch.zeros(shape, dtype=dtype),
                 handle=None)


def _jentry(name, shape=(4,), op_type="allreduce", dtype=np.float32):
    return jcoord.Entry(name=name, op_type=op_type,
                        x=np.zeros(shape, dtype), handle=None)


def _run_pair(kv, flushes_a, flushes_b, checker=DivergenceChecker, **kw):
    """Two checkers on two threads over ``kv``; each rank's outcome (None
    or the exception raised)."""
    results = [None, None]

    def rank(pidx, flushes):
        c = checker(kv, pidx, 2, **kw)
        try:
            for i, entries in enumerate(flushes):
                c.observe(i + 1, entries)
        except Exception as e:
            results[pidx] = e

    ts = [threading.Thread(target=rank, args=(0, flushes_a)),
          threading.Thread(target=rank, args=(1, flushes_b))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    return results


def test_matching_flushes_pass():
    flushes = [[_entry("g1"), _entry("g2")], [_entry("g3")]]
    assert _run_pair(FakeKV(), flushes, flushes) == [None, None]


def test_shape_mismatch_raises_on_both_ranks_naming_tensor():
    ra, rb = _run_pair(FakeKV(), [[_entry("grad", shape=(4,))]],
                       [[_entry("grad", shape=(8,))]])
    for r in (ra, rb):
        assert isinstance(r, DivergenceError)
        assert "grad" in str(r) and "(4,)" in str(r) and "(8,)" in str(r)


def test_extra_tensor_raises_on_both_ranks():
    shared = [_entry("g1"), _entry("g2")]
    ra, rb = _run_pair(FakeKV(), [list(shared)],
                       [[_entry("extra")] + list(shared)])
    for r in (ra, rb):
        assert isinstance(r, DivergenceError) and "extra" in str(r)


def test_dtype_mismatch_detected():
    ra, rb = _run_pair(FakeKV(), [[_entry("g", dtype=torch.float32)]],
                       [[_entry("g", dtype=torch.bfloat16)]])
    assert isinstance(ra, DivergenceError)
    assert isinstance(rb, DivergenceError)
    assert "bfloat16" in str(ra) and "float32" in str(ra)


def test_peer_timeout_raises_and_warns_with_rank_attribution():
    t = [0.0]

    def clock():
        return t[0]

    def wait(_key, seconds):
        t[0] += seconds
        return None

    c = DivergenceChecker(FakeKV(), 0, 2, clock=clock, wait=wait)
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    lg = logging.getLogger("horovod_tpu_torch.stall")
    h = _Capture()
    lg.addHandler(h)
    try:
        with pytest.raises(DivergenceError) as ei:
            c.observe(1, [_entry("lonely")])
    finally:
        lg.removeHandler(h)
    msg = str(ei.value)
    assert "never reached" in msg and "[1]" in msg and "lonely" in msg
    assert any("have not reached" in r.getMessage() for r in records)


def test_check_every_zero_disables():
    knobs.set_override("HOROVOD_DIVERGENCE_CHECK_EVERY", 0)
    try:
        c = DivergenceChecker(FakeKV(), 0, 2)
        c.observe(1, [_entry("x")])
        assert c.checks == 0
    finally:
        knobs.clear_override("HOROVOD_DIVERGENCE_CHECK_EVERY")


def test_check_every_k_accumulates():
    knobs.set_override("HOROVOD_DIVERGENCE_CHECK_EVERY", 2)
    try:
        ra, rb = _run_pair(FakeKV(), [[_entry("g1")], [_entry("g2")]],
                           [[_entry("g1", shape=(9,))], [_entry("g2")]])
        assert isinstance(ra, DivergenceError) and "g1" in str(ra)
        assert isinstance(rb, DivergenceError)
    finally:
        knobs.clear_override("HOROVOD_DIVERGENCE_CHECK_EVERY")


def test_key_pruning():
    kv = FakeKV()
    flushes = [[_entry(f"g{i}")] for i in range(5)]
    assert _run_pair(kv, flushes, flushes) == [None, None]
    assert not any("/d/1/" in k or "/d/2/" in k or "/d/3/" in k
                   for k in kv._d)
    assert any("/d/5/" in k for k in kv._d)


def test_entry_signature_covers_validated_fields():
    sig = entry_signature(_entry("t", shape=(2, 3)))
    for part in ("t", "allreduce", "float32", "(2, 3)", "ps0", "root0"):
        assert part in sig
    # the JAX signature of the rank-stacked array names the same fields
    jsig = jdiv.entry_signature(_jentry("t", shape=(2, 3)))
    assert sig == jsig
    # a gather's first dim may differ between ranks
    for op_type in ("allgather", "alltoall"):
        assert "|(*, 3)|" in entry_signature(_entry("t", (2, 3), op_type))
        assert entry_signature(_entry("t", (2, 3), op_type)) == \
            entry_signature(_entry("t", (5, 3), op_type))
    assert "|(*,)|" in entry_signature(_entry("t", (7,), "allgather"))


def _trajectory(pkg_checker, make_entry, reg, n_flushes, entries_fn,
                then=None):
    """Two checkers of one package over a FakeKV; rank 0's (flush, checks,
    effective interval) after each flush, then after ``then`` (a last
    flush of a fresh signature on both ranks)."""
    kv = FakeKV()
    reg.set_override("HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL", 4)
    traj = {0: [], 1: []}
    cs = {}
    try:
        def rank(p):
            c = cs.setdefault(p, pkg_checker(kv, p, 2))
            for i in range(n_flushes):
                c.observe(i + 1, entries_fn(make_entry, i))
                traj[p].append((i + 1, c.checks, c.effective_interval))
            if then is not None:
                c.observe(n_flushes + 1, [make_entry(then)])
                traj[p].append((n_flushes + 1, c.checks,
                                c.effective_interval))

        ths = [threading.Thread(target=rank, args=(p,)) for p in (0, 1)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=30)
    finally:
        reg.clear_override("HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL")
    assert traj[0] == traj[1]
    return traj[0], cs[0]


def test_cadence_widens_in_steady_state_and_snaps_back():
    """The JAX trajectory flush by flush: checks at flush 1, 2, 3 (then the
    interval doubles to 2), 5, 7, 9 (to 4, the cap), 13; a fresh
    signature snaps back to 1; a requeue event too."""
    def same(make, i):
        return [make("same")]
    port, c0 = _trajectory(DivergenceChecker, _entry, knobs, 14, same,
                           then="brand_new")
    jax_, _ = _trajectory(jdiv.DivergenceChecker, _jentry, jknobs, 14, same,
                          then="brand_new")
    assert port == jax_
    assert port[13] == (14, 7, 4) and port[14][2] == 1
    c0._effective = 4
    c0.reset_cadence()
    assert c0.effective_interval == 1


def test_cadence_widens_for_auto_named_and_grouped_traffic():
    def fresh(make, i):
        e = make(f"hvd.noname.{i}")
        e.group_id, e.group_size = 100 + i, 1
        return [e]
    port, c0 = _trajectory(DivergenceChecker, _entry, knobs, 14, fresh)
    jax_, _ = _trajectory(jdiv.DivergenceChecker, _jentry, jknobs, 14, fresh)
    assert port == jax_
    assert c0.effective_interval == 4 and c0.checks == 7


def test_cadence_divergence_still_detected_at_widened_interval():
    knobs.set_override("HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL", 4)
    try:
        same = [[_entry("same")] for _ in range(4)]
        ra, rb = _run_pair(FakeKV(), same + [[_entry("same")]] * 2,
                           same + [[_entry("same", shape=(9,))],
                                   [_entry("same")]])
        assert isinstance(ra, DivergenceError) and "same" in str(ra)
        assert isinstance(rb, DivergenceError)
    finally:
        knobs.clear_override("HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL")


def test_cadence_desync_raises_descriptive_mismatch_not_timeout():
    kv = FakeKV()
    results = [None, None]
    warmed = threading.Barrier(2, timeout=20)

    def rank(pidx, effective):
        c = DivergenceChecker(kv, pidx, 2)
        try:
            for i in (1, 2):
                c.observe(i, [_entry("g")])
            warmed.wait()
            c._effective, c._streak = effective, 0
            for i in (3, 4):
                c.observe(i, [_entry("g")])
        except Exception as e:
            results[pidx] = e

    ts = [threading.Thread(target=rank, args=(0, 1)),
          threading.Thread(target=rank, args=(1, 2))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    for r in results:
        assert isinstance(r, DivergenceError), r
    assert "#cadence" in (str(results[0]) + str(results[1]))


def test_cadence_state_is_digested_but_identical_cadences_pass():
    flushes = [[_entry(n)] for n in "abcdef"]
    assert _run_pair(FakeKV(), flushes, flushes) == [None, None]


# ---------------------------------------------------------------------------
# a two-rank gloo world over the c10d store
# ---------------------------------------------------------------------------

CASES = ("clean", "extra", "widened", "never", "cadence")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("divergence")
    phases = [{"threads": 1,
               "knobs": {"HOROVOD_DIVERGENCE_TIMEOUT": TIMEOUT_S,
                         "HOROVOD_STALL_CHECK_TIME_SECONDS": 1},
               "scenarios": [{"kind": "divergence", "name": c, "case": c}
                             for c in CASES]}]
    return workers.run_phases(2, phases, out)


def _outs(world, case):
    return [{k: v.item() for k, v in world(case, r).items()} for r in (0, 1)]


def test_two_rank_identical_programs_pass_checking(world):
    for out in _outs(world, "clean"):
        assert out["error"] == "" and out["checks"] >= 3


def test_two_rank_divergence_raises_on_both_ranks(world):
    for r, out in enumerate(_outs(world, "extra")):
        msg = out["error"]
        assert "extra_tensor" in msg and f"rank {r}" in msg, msg
        assert f"rank(s) [{1 - r}]" in msg, msg
        assert out["seconds"] < TIMEOUT_S


def test_two_rank_divergence_at_a_widened_interval_raises_on_both(world):
    """Rank 1's new tensor snaps only its own cadence back: it checks a
    flush rank 0 dispatches unchecked. Rank 0's wait in that collective
    publishes the flush, rank 1 names the divergent request, and rank 0's
    wait raises it too, both well inside the timeout."""
    for r, out in enumerate(_outs(world, "widened")):
        msg = out["error"]
        assert "late_extra" in msg and "rank(s) [0]" in msg, msg
        assert "unchecked" in msg and out["seconds"] < TIMEOUT_S, (msg, out)
    assert "while rank 0 waited" in _outs(world, "widened")[0]["error"]


def test_two_rank_peer_that_never_flushes_raises_after_the_timeout(world):
    waiting, idle = _outs(world, "never")
    msg = waiting["error"]
    assert "never reached" in msg and "[1]" in msg and "lonely" in msg, msg
    assert TIMEOUT_S <= waiting["seconds"] < TIMEOUT_S + 10
    assert idle["error"] == ""


def test_two_rank_cadence_desync_is_a_mismatch_not_a_timeout(world):
    outs = _outs(world, "cadence")
    for out in outs:
        assert out["error"] and "never reached" not in out["error"]
        assert out["seconds"] < TIMEOUT_S
    assert "#cadence" in outs[0]["error"] + outs[1]["error"]
