"""hvdmodel-torch seeded-bug corpus: mutated protocol variants, each caught
by exactly one HVD6xx rule, paired with a clean twin that explores clean.

The port's copy of ``tests/data/modellint/protocols.py``, importing
``horovod_tpu_torch`` where that imports ``horovod_tpu``; the fixtures are
the same, line for line. ``bad_*`` scenarios carry a deliberately
re-introduced protocol bug —
the non-write-once stop step, rotation before commit, a dropped barrier
ack, an unlocked drain window, an off-by-one snapshot label, a
lock-order inversion — distilled to the smallest protocol that still
exhibits it, built on the SAME shimmed primitives (schedhooks locks/
events/conditions, the real utils.kvstore.DistributedKV wrapper over the
simulated c10d store, the atomic-rename commit point) the real modules
run through, so the checker exercises the identical yield-point
semantics.

CLI: ``hvdmodel-torch tests/modelcheck_torch/protocols.py:all_bad``
(exits 1, one finding per fixture) and ``...:all_clean`` (exits 0).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from horovod_tpu_torch.analysis.model import Harness, Scenario
from horovod_tpu_torch.utils import schedhooks


# ---------------------------------------------------------------------------
# HVD601 — stop-step agreement: write-once vs overwrite
# ---------------------------------------------------------------------------

def _stop_agreement(overwrite: bool):
    def fn(h: Harness) -> None:
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        stops: Dict[int, int] = {}
        procs = [h.process(f"ctl{r}", pidx=r, nproc=2) for r in range(2)]

        def ctl(r):
            def run():
                kv = distributed_kv()
                # Concurrent eviction notices: each controller proposes
                # its own (skewed) stop step. The write-once store makes
                # whoever lands first win for everyone; overwrite=True
                # is the seeded bug (last writer wins only for late
                # readers).
                try:
                    kv.set("preempt/stop", str(3 + r), overwrite=overwrite)
                except Exception:
                    pass           # a peer won the write-once race
                stops[r] = int(kv.get("preempt/stop", timeout_s=5))
            return run

        for r, p in enumerate(procs):
            h.spawn(p, ctl(r), "ctl")
        h.go()
        if len(set(stops.values())) > 1:
            h.violation(
                "HVD601",
                f"controllers adopted different stop steps {stops}: the "
                f"final snapshots span different steps")
    return fn


def bad_stop_step() -> Scenario:
    return Scenario("bad_stop_step", _stop_agreement(overwrite=True),
                    codes=("HVD601",))


def clean_stop_step() -> Scenario:
    return Scenario("clean_stop_step", _stop_agreement(overwrite=False),
                    codes=("HVD601",))


# ---------------------------------------------------------------------------
# HVD602 — rotation before commit
# ---------------------------------------------------------------------------

def _rotation(rotate_before_commit: bool):
    def fn(h: Harness) -> None:
        from horovod_tpu_torch.resilience.async_checkpoint import (
            list_committed_steps, step_dirname,
        )
        d = os.path.join(h.tmpdir, "ckpt")
        os.makedirs(d, exist_ok=True)
        state: Dict[str, bool] = {}

        def monitor():
            steps = list_committed_steps(d)
            if state.get("ever") and not steps:
                h.violation(
                    "HVD602",
                    "rotation deleted the last committed snapshot before "
                    "the new one was published — a crash here leaves "
                    "nothing restorable")
            if steps:
                state["ever"] = True

        h.monitor = monitor

        def rotate(keep_newest_of: List[int]) -> None:
            import shutil
            for s in sorted(keep_newest_of)[:-1]:
                shutil.rmtree(os.path.join(d, step_dirname(s)),
                              ignore_errors=True)

        def save(step: int) -> None:
            tmp = os.path.join(d, f".tmp-{step_dirname(step)}")
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "committed": True,
                           "format": "json", "shards": 0,
                           "shard_digests": []}, f)
            final = os.path.join(d, step_dirname(step))
            if rotate_before_commit:
                # seeded bug: make room BEFORE the new snapshot is
                # durable — the window between rotate and rename has no
                # committed checkpoint at all
                rotate(list_committed_steps(d) + [step])
                schedhooks.rename(tmp, final)
            else:
                schedhooks.rename(tmp, final)
                rotate(list_committed_steps(d))
            # protocol truth, not monitor sampling: the rename above
            # durably committed `step`
            state["ever"] = True

        proc = h.process("train", crashable=True)

        def loop():
            save(1)
            save(2)

        h.spawn(proc, loop, "train")
        h.go()
        monitor()
    return fn


def bad_rotation() -> Scenario:
    return Scenario("bad_rotation", _rotation(rotate_before_commit=True),
                    max_crashes=1, codes=("HVD602",))


def clean_rotation() -> Scenario:
    return Scenario("clean_rotation", _rotation(rotate_before_commit=False),
                    max_crashes=1, codes=("HVD602",))


# ---------------------------------------------------------------------------
# HVD602 — dropped barrier ack
# ---------------------------------------------------------------------------

def _barrier(follower_waits_for_commit: bool):
    def fn(h: Harness) -> None:
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        d = os.path.join(h.tmpdir, "ckpt")
        os.makedirs(d, exist_ok=True)
        view: Dict[int, Optional[bool]] = {0: None, 1: None}
        procs = [h.process(f"host{r}", pidx=r, nproc=2) for r in range(2)]

        def leader():
            kv = distributed_kv()
            try:
                kv.get("ckpt/ack/1", timeout_s=5)
            except Exception:
                view[0] = False          # abandoned uncommitted
                return
            with open(os.path.join(d, "manifest.json.part"), "w") as f:
                json.dump({"committed": True}, f)
            schedhooks.rename(os.path.join(d, "manifest.json.part"),
                              os.path.join(d, "manifest.json"))
            try:
                kv.set("ckpt/commit", "1")
            except Exception:
                pass        # advisory record; the rename IS the commit
            view[0] = True

        def follower():
            kv = distributed_kv()
            try:
                kv.set("ckpt/ack/1", "ok")
            except Exception:
                pass                     # "best effort" ack send
            if follower_waits_for_commit:
                try:
                    kv.get("ckpt/commit", timeout_s=5)
                    view[1] = True
                except Exception:
                    view[1] = False
            else:
                # seeded bug: assume the ack arrived, so the commit
                # "must" happen — records the checkpoint as committed
                # without confirmation
                view[1] = True

        h.spawn(procs[0], leader, "writer")
        h.spawn(procs[1], follower, "writer")
        h.go()
        on_disk = os.path.exists(os.path.join(d, "manifest.json"))
        for r, saw in view.items():
            if saw and not on_disk:
                h.violation(
                    "HVD602",
                    f"host {r} observed the checkpoint as committed but "
                    f"no commit was ever published (its barrier ack was "
                    f"dropped and nobody confirmed) — a resume on that "
                    f"host adopts a checkpoint that does not exist")
    return fn


def bad_dropped_ack() -> Scenario:
    return Scenario("bad_dropped_ack",
                    _barrier(follower_waits_for_commit=False),
                    max_losses=1, codes=("HVD602",))


def clean_dropped_ack() -> Scenario:
    return Scenario("clean_dropped_ack",
                    _barrier(follower_waits_for_commit=True),
                    max_losses=1, codes=("HVD602",))


# ---------------------------------------------------------------------------
# HVD603 — lock-order inversion (the dynamic twin of static HVD301)
# ---------------------------------------------------------------------------

def _two_locks(inverted: bool):
    def fn(h: Harness) -> None:
        lock_a = schedhooks.Lock()
        lock_b = schedhooks.Lock()
        proc = h.process("ctl0")

        def one():
            with lock_a:
                with lock_b:
                    pass

        def two():
            if inverted:
                with lock_b:           # seeded bug: opposite order
                    with lock_a:
                        pass
            else:
                with lock_a:
                    with lock_b:
                        pass

        h.spawn(proc, one, "cycle")
        h.spawn(proc, two, "shutdown")
        h.go()
    return fn


def bad_lock_order() -> Scenario:
    return Scenario("bad_lock_order", _two_locks(inverted=True),
                    codes=("HVD603",))


def clean_lock_order() -> Scenario:
    return Scenario("clean_lock_order", _two_locks(inverted=False),
                    codes=("HVD603",))


# ---------------------------------------------------------------------------
# HVD604 — unlocked drain window (missing lock)
# ---------------------------------------------------------------------------

def _drain(locked: bool):
    def fn(h: Harness) -> None:
        lock = schedhooks.Lock()
        flushed = schedhooks.Event()
        entries: List[str] = []
        dispatched: List[str] = []

        def add(name):
            def run():
                if locked:
                    with lock:
                        entries.append(name)
                else:
                    entries.append(name)
            return run

        def drain():
            if locked:
                with lock:
                    batch = list(entries)
                    entries.clear()
            else:
                # seeded bug: the snapshot and the clear are not atomic
                # — the notify between them is a scheduling window where
                # a concurrent enqueue is silently wiped
                batch = list(entries)
                flushed.set()
                entries.clear()
            dispatched.extend(batch)

        proc = h.process("ctl0")
        ta = h.spawn(proc, add("grad.a"), "prod_a")
        tb = h.spawn(proc, add("grad.b"), "prod_b")
        tc = h.spawn(proc, drain, "cycler")

        def closer():
            ta.join()
            tb.join()
            tc.join()
            drain()                      # shutdown flush

        h.spawn(proc, closer, "closer")
        h.go()
        lost = {"grad.a", "grad.b"} - set(dispatched)
        if lost:
            h.violation(
                "HVD604",
                f"lost tensor(s) {sorted(lost)}: enqueued, never "
                f"dispatched, and no longer queued — the owning step "
                f"blocks in synchronize() forever")
    return fn


def bad_unlocked_drain() -> Scenario:
    return Scenario("bad_unlocked_drain", _drain(locked=False),
                    codes=("HVD604",))


def clean_locked_drain() -> Scenario:
    return Scenario("clean_locked_drain", _drain(locked=True),
                    codes=("HVD604",))


# ---------------------------------------------------------------------------
# HVD604 — fleet drain that drops an admitted request
# ---------------------------------------------------------------------------

def _fleet_drain(locked: bool):
    """Replica scale-down (serving/fleet.py drain) over the real
    MemberRegistry: the draining replica hands its admitted queue to
    the survivor. Seeded bug: the queue snapshot and the clear are not
    atomic with a concurrent admission — the drain publishes its
    'draining' notice between them, and a request the router admitted
    in that window is silently wiped (the client waits forever)."""
    def fn(h: Harness) -> None:
        from horovod_tpu_torch.elastic.registry import MemberRegistry
        reg = MemberRegistry(clock=lambda: 0.0)
        reg.join("replica-0", 1)
        reg.join("replica-1", 1)
        lock = schedhooks.Lock()
        draining = schedhooks.Event()
        aboard: List[str] = []          # replica 1's admitted queue
        survivor: List[str] = []        # re-admitted on replica 0

        def admit(name):
            def run():
                if locked:
                    with lock:
                        aboard.append(name)
                else:
                    aboard.append(name)
            return run

        def drain():
            if locked:
                with lock:
                    batch = list(aboard)
                    aboard.clear()
            else:
                # seeded bug: snapshot, THEN publish the draining
                # notice (a scheduling window), THEN clear — an
                # admission landing in the window is wiped
                batch = list(aboard)
                draining.set()
                aboard.clear()
            survivor.extend(batch)

        proc = h.process("fleet0")
        ta = h.spawn(proc, admit("req.a"), "admit_a")
        tb = h.spawn(proc, admit("req.b"), "admit_b")
        tc = h.spawn(proc, drain, "drain")

        def closer():
            ta.join()
            tb.join()
            tc.join()
            drain()                     # admission-stop flush
            reg.leave("replica-1")

        h.spawn(proc, closer, "closer")
        h.go()
        lost = {"req.a", "req.b"} - set(survivor)
        if lost:
            h.violation(
                "HVD604",
                f"drain dropped admitted request(s) {sorted(lost)}: "
                f"admitted to the draining replica, never re-admitted "
                f"on a survivor — the client blocks forever")
    return fn


def bad_fleet_drain_drop() -> Scenario:
    return Scenario("bad_fleet_drain_drop", _fleet_drain(locked=False),
                    codes=("HVD604",))


def clean_fleet_drain() -> Scenario:
    return Scenario("clean_fleet_drain", _fleet_drain(locked=True),
                    codes=("HVD604",))


# ---------------------------------------------------------------------------
# HVD605 — snapshot labeled with the wrong step (off-by-one resume)
# ---------------------------------------------------------------------------

def _mini_resume(save_after_update: bool):
    STEPS = 3

    def step_fn(w: float) -> float:
        return w * 2.0 + 1.0

    def fn(h: Harness) -> None:
        d = os.path.join(h.tmpdir, "ckpt")
        os.makedirs(d, exist_ok=True)

        def save(step: int, w: float) -> None:
            part = os.path.join(d, f"step-{step}.json.part")
            with open(part, "w") as f:
                json.dump({"step": step, "w": w}, f)
            schedhooks.rename(part, os.path.join(d, f"step-{step}.json"))

        def latest():
            best = None
            for name in sorted(os.listdir(d)):
                if not name.endswith(".json"):
                    continue
                with open(os.path.join(d, name)) as f:
                    rec = json.load(f)
                if best is None or rec["step"] > best["step"]:
                    best = rec
            return best

        def loop(out: List[float]):
            rec = latest()
            start = rec["step"] if rec else 0
            w = rec["w"] if rec else 0.0
            for s in range(start, STEPS):
                if save_after_update:
                    w = step_fn(w)
                    save(s + 1, w)
                else:
                    # seeded bug: the snapshot is labeled step s+1 but
                    # holds the PRE-update state — a resume replays from
                    # one step behind its label and diverges
                    save(s + 1, w)
                    w = step_fn(w)
            out.append(w)

        expected = 0.0
        for _ in range(STEPS):
            expected = step_fn(expected)

        proc = h.process("train0", crashable=True)
        out1: List[float] = []
        h.spawn(proc, lambda: loop(out1), "train")
        h.go()
        if proc.crashed:
            proc2 = h.process("train1")
            out2: List[float] = []
            h.spawn(proc2, lambda: loop(out2), "train")
            h.go()
            final = out2[0] if out2 else None
        else:
            final = out1[0] if out1 else None
        if final is None or final != expected:
            h.violation(
                "HVD605",
                f"crash+restore replay finished with {final!r}; the "
                f"uninterrupted run computes {expected!r} — the "
                f"snapshot's step label does not match its state")
    return fn


def bad_resume_offbyone() -> Scenario:
    return Scenario("bad_resume_offbyone",
                    _mini_resume(save_after_update=False),
                    max_crashes=1, codes=("HVD605",))


def clean_resume() -> Scenario:
    return Scenario("clean_resume", _mini_resume(save_after_update=True),
                    max_crashes=1, codes=("HVD605",))


# ---------------------------------------------------------------------------
# HVD602 — resize plan committed before its snapshot (hvdresize)
# ---------------------------------------------------------------------------

def _resize_plan_order(plan_after_snapshot: bool):
    """The live-resize commit window distilled: a quiescing controller
    writes its stop-step snapshot and publishes the ResizePlan through
    the REAL ``elastic.resize.commit_plan`` atomic rename. The seeded
    bug flips the order — a crash between the two leaves a committed
    plan whose snapshot does not exist, and the cold start into the new
    world adopts a resize it cannot restore."""

    def fn(h: Harness) -> None:
        from horovod_tpu_torch.elastic.resize import (
            ResizePlan, commit_plan, load_plan,
        )
        d = os.path.join(h.tmpdir, "ckpt")
        os.makedirs(d, exist_ok=True)
        plan = ResizePlan(step=4, old_world=4, new_world=3,
                          dead_ranks=(1,),
                          notice={"kind": "host_loss", "host": 1})
        snap = os.path.join(d, f"snap-step{plan.step}.json")

        def write_snapshot() -> None:
            part = snap + ".part"
            with open(part, "w") as f:
                json.dump({"step": plan.step}, f)
            schedhooks.rename(part, snap)

        def monitor() -> None:
            if load_plan(d, plan.step) is not None \
                    and not os.path.exists(snap):
                h.violation(
                    "HVD602",
                    "resize plan is committed but its stop-step "
                    "snapshot is missing — the plan was published "
                    "before the snapshot was durable")

        h.monitor = monitor
        proc = h.process("ctl0", crashable=True)

        def quiesce():
            if plan_after_snapshot:
                write_snapshot()
                commit_plan(d, plan)
            else:
                # seeded bug: the plan publishes first — the crash
                # window between the two renames dangles the plan
                commit_plan(d, plan)
                write_snapshot()

        h.spawn(proc, quiesce, "quiesce")
        h.go()
        monitor()
    return fn


def bad_resize_plan_order() -> Scenario:
    return Scenario("bad_resize_plan_order",
                    _resize_plan_order(plan_after_snapshot=False),
                    max_crashes=1, codes=("HVD602",))


def clean_resize_plan_order() -> Scenario:
    return Scenario("clean_resize_plan_order",
                    _resize_plan_order(plan_after_snapshot=True),
                    max_crashes=1, codes=("HVD602",))


# ---------------------------------------------------------------------------
# aggregates (the CLI/CI entry points)
# ---------------------------------------------------------------------------

def all_bad() -> List[Scenario]:
    return [bad_stop_step(), bad_rotation(), bad_dropped_ack(),
            bad_lock_order(), bad_unlocked_drain(), bad_resume_offbyone(),
            bad_resize_plan_order(), bad_fleet_drain_drop()]


def all_clean() -> List[Scenario]:
    return [clean_stop_step(), clean_rotation(), clean_dropped_ack(),
            clean_lock_order(), clean_locked_drain(), clean_resume(),
            clean_resize_plan_order(), clean_fleet_drain()]
