"""Serving fleet: N engine replicas behind one router, with a drain-safe
lifecycle and an occupancy autoscaler, the counterpart of
``horovod_tpu/serving/fleet.py``. The elastic driver's membership
machinery (discovery diff, blacklist with cooldown, listener fan-out,
packaged as :class:`~horovod_tpu_torch.elastic.registry.MemberRegistry`)
is recast from training hosts to serving replicas.

One replica = one :class:`~horovod_tpu_torch.serving.engine.ServeEngine`
(its own KV page pool and prefix index, on its own device) plus one
:class:`~horovod_tpu_torch.serving.scheduler.ServeScheduler` built on the
engine's device. ``make_engine(rid)`` decides the device: on a host with
several cards, replica ``i`` may serve on ``cuda:i``. Every tensor a
replica makes names its engine's device, and each replica steps under
``torch.cuda.device(engine.device)``, since a fresh thread's current
device is ``cuda:0``.

**What a build is here.** The JAX engine compiles its steps ahead of time
and a warm replica loads them from the artifact store. The port compiles
nothing per engine: its steps run eagerly and its one kernel on this path,
paged decode, is built by ``nvcc`` once per build directory
(``ops/_build.py``), or written from the artifact store when
``HOROVOD_ARTIFACT_STORE`` points every replica at one directory
(``engine.store_outcomes``). ``engine.builds`` counts the ``nvcc`` builds
that ran while the engine was constructed and served its first decode
step, so a replica grown on a warm build directory or a warm store
reports 0, and one that had to build the kernel reports the builds it
paid for.

Lifecycle states::

    JOINING -> READY -> DRAINING -> LEFT        (graceful scale-down)
                  \\--> DEAD                     (replica_kill chaos)

- **READY** replicas admit traffic through the
  :class:`~horovod_tpu_torch.serving.router.FleetRouter` (occupancy and
  prefix-affinity placement).
- **DRAINING**: no new admissions; requests already aboard (queued on
  its scheduler, prefilling, decoding) run to completion, then the
  replica leaves the registry and its KV pages are freed: an admitted
  request is never dropped by scale-down.
- **DEAD** (chaos ``replica_kill`` at the router's dispatch path, or
  :meth:`ServingFleet.kill_replica`): the registry blacklists the replica
  (cooldown, no flap-back) and the fleet reconciles: every request the
  dead replica held that had not completed is reset to its pre-admission
  state and re-dispatched through the router in submission order.
  Completed (acked) requests are never replayed.

The autoscaler reads the queue depth the schedulers export as
``hvd_serve_queue_depth``: when queued requests per ready replica exceed
``HOROVOD_FLEET_SCALE_UP_DEPTH`` it grows (within
``HOROVOD_FLEET_MAX_REPLICAS``) in the SAME cycle the pressure is seen;
after ``HOROVOD_FLEET_SCALE_DOWN_IDLE`` consecutive idle cycles it drains
the newest replica (down to ``HOROVOD_FLEET_MIN_REPLICAS``). Scale events
are cooldown-limited (``HOROVOD_FLEET_COOLDOWN``) and recorded in
``scale_events``.

A fleet of one gives the bare engine's tokens bitwise: the router has one
candidate, dispatch order is submission order, and the scheduler's
per-request bitwise-solo contract does the rest.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.elastic.registry import MemberRegistry
from horovod_tpu_torch.serving.engine import ServeEngine
from horovod_tpu_torch.serving.router import FleetRouter
from horovod_tpu_torch.serving.scheduler import Request, ServeScheduler
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.serving")


class ReplicaState:
    JOINING = "joining"
    READY = "ready"
    DRAINING = "draining"
    DEAD = "dead"
    LEFT = "left"


def _metrics():
    from horovod_tpu_torch import metrics as M
    return {
        "replicas": M.gauge(
            "hvd_fleet_replicas",
            "Serving replicas currently registered (ready + draining)"),
        "queue": M.gauge(
            "hvd_fleet_queue_depth",
            "Requests aboard the fleet but not yet in a decode slot "
            "(sum of per-replica scheduler queues)"),
        "scale": M.counter(
            "hvd_fleet_scale_events_total",
            "Autoscaler / lifecycle events by direction",
            labelnames=("direction",)),
        "readmissions": M.counter(
            "hvd_fleet_readmissions_total",
            "Requests re-admitted on survivors after a replica death"),
    }


class EngineReplica:
    """One replica: engine + scheduler + lifecycle bookkeeping."""

    def __init__(self, rid: int, engine: ServeEngine,
                 queue_deadline: Optional[float] = None):
        self.rid = int(rid)
        self.engine = engine
        self.scheduler = ServeScheduler(engine, mode="continuous",
                                        queue_deadline=queue_deadline,
                                        device=engine.device)
        self.state = ReplicaState.JOINING
        self.dispatched_count = 0               # chaos hook counter
        self.aboard: Dict[int, Request] = {}    # fleet seq -> live request
        self.joined_t = time.perf_counter()
        self.first_token_t: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def member(self) -> str:
        return f"replica-{self.rid}"

    def load(self) -> int:
        s = self.scheduler
        return len(s.queue) + len(s.prefilling) + len(s.active)

    def drained(self) -> bool:
        return self.load() == 0

    def _on_device(self):
        """The engine's card as the current device (a no-op on the CPU)."""
        if self.engine.device.type == "cuda":
            return torch.cuda.device(self.engine.device)
        return contextlib.nullcontext()

    def step(self, now: Optional[float] = None) -> None:
        with self._on_device():
            self.scheduler.step(now)
        if self.first_token_t is None and any(
                r.tokens for r in list(self.aboard.values())):
            self.first_token_t = time.perf_counter()

    def harvest_done(self) -> List[Request]:
        """Drop completed requests from the aboard set (they are acked: a
        later death of this replica never replays them)."""
        done = [seq for seq, r in self.aboard.items() if r.done]
        return [self.aboard.pop(seq) for seq in done]

    # -- threaded drive (run(parallel=True)) ---------------------------------
    def start_thread(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.is_set():
                if self.load() == 0:
                    time.sleep(self.scheduler.queue_deadline or 1e-4)
                    continue
                self.step()     # harvest stays with the fleet's _reap

        self._stop.clear()
        self._thread = threading.Thread(
            target=loop, name=f"hvd-serve-{self.member}", daemon=True)
        self._thread.start()

    def stop_thread(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None


class ServingFleet:
    """Replica lifecycle and autoscaling over an engine factory:
    ``make_engine(rid)`` builds a fresh :class:`ServeEngine` for a new
    replica, on the device it chooses."""

    def __init__(self, make_engine: Callable[[int], ServeEngine],
                 replicas: Optional[int] = None, *,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 scale_up_depth: Optional[int] = None,
                 scale_down_idle: Optional[int] = None,
                 cooldown: Optional[int] = None,
                 affinity: Optional[bool] = None,
                 queue_deadline: Optional[float] = None):
        def knob(v, name):
            return knobs.get(name) if v is None else v
        self.make_engine = make_engine
        self.min_replicas = max(int(knob(
            min_replicas, "HOROVOD_FLEET_MIN_REPLICAS")), 1)
        self.max_replicas = max(int(knob(
            max_replicas, "HOROVOD_FLEET_MAX_REPLICAS")),
            self.min_replicas)
        self.scale_up_depth = int(knob(
            scale_up_depth, "HOROVOD_FLEET_SCALE_UP_DEPTH"))
        self.scale_down_idle = int(knob(
            scale_down_idle, "HOROVOD_FLEET_SCALE_DOWN_IDLE"))
        self.cooldown = int(knob(cooldown, "HOROVOD_FLEET_COOLDOWN"))
        self.queue_deadline = queue_deadline
        self.registry = MemberRegistry()
        self.router = FleetRouter(self, affinity=bool(knob(
            affinity, "HOROVOD_FLEET_AFFINITY")))
        self.replicas: Dict[int, EngineReplica] = {}
        self._next_rid = 0
        self._seq = 0                           # global submission order
        self.completed: List[Request] = []
        self.scale_events: List[Dict[str, Any]] = []
        self.readmission_log: List[int] = []    # request rids, in order
        self.readmissions = 0
        self._idle_cycles = 0
        self._last_scale_cycle = -10 ** 9
        self._cycle = 0
        self._m = _metrics()
        n0 = int(knob(replicas, "HOROVOD_FLEET_REPLICAS"))
        for _ in range(max(n0, self.min_replicas)):
            self.grow(reason="boot")
        _register_fleet(self)

    # -- membership ----------------------------------------------------------
    def admitting(self) -> List[EngineReplica]:
        """READY replicas in the registry's stable member order (the
        router's deterministic candidate order)."""
        by_member = {r.member: r for r in self.replicas.values()}
        return [rep for rep in (by_member.get(m)
                                for m in self.registry.members())
                if rep is not None and rep.state == ReplicaState.READY]

    def live(self) -> List[EngineReplica]:
        return [r for r in self.replicas.values()
                if r.state in (ReplicaState.READY, ReplicaState.DRAINING)]

    # -- lifecycle edges -----------------------------------------------------
    def grow(self, reason: str = "autoscale") -> EngineReplica:
        rid = self._next_rid
        self._next_rid += 1
        t0 = time.perf_counter()
        engine = self.make_engine(rid)
        rep = EngineReplica(rid, engine,
                            queue_deadline=self.queue_deadline)
        self.replicas[rid] = rep
        rep.state = ReplicaState.READY
        self.registry.join(rep.member, slots=engine.slots)
        self._m["replicas"].set(len(self.live()))
        self._m["scale"].labels(direction="up").inc()
        boot_s = time.perf_counter() - t0
        self._record_event("grow", rid, reason=reason,
                           boot_s=round(boot_s, 6), builds=engine.builds)
        logger.info("fleet: replica %d joined on %s (%s, builds=%d, "
                    "%.3fs)", rid, engine.device, reason, engine.builds,
                    boot_s)
        return rep

    def drain(self, rid: int, reason: str = "autoscale") -> None:
        """No new admissions; the replica leaves once everything aboard
        completes (reaped by :meth:`_reap` each cycle)."""
        rep = self.replicas[rid]
        if rep.state != ReplicaState.READY:
            return
        rep.state = ReplicaState.DRAINING
        self._m["scale"].labels(direction="down").inc()
        self._record_event("drain", rid, reason=reason, aboard=rep.load())

    def _finalize_leave(self, rep: EngineReplica) -> None:
        rep.stop_thread()
        eng = rep.engine
        if eng.prefix is not None:
            eng.prefix.evict(eng.pool.n_pages)  # drop the index's page refs
        pages_free = eng.allocator.free_pages
        rep.state = ReplicaState.LEFT
        self.registry.leave(rep.member)
        self._m["replicas"].set(len(self.live()))
        self._record_event("leave", rep.rid, pages_freed=pages_free,
                           pages_total=eng.pool.n_pages)
        logger.info("fleet: replica %d drained and left (%d/%d pages "
                    "free)", rep.rid, pages_free, eng.pool.n_pages)

    def kill_replica(self, rid: int, reason: str = "test") -> List[Request]:
        """Abrupt death (chaos ``replica_kill`` or an operator's action):
        blacklist in the registry, then re-admit the dead replica's queued
        and in-flight-but-unacked requests on survivors, in submission
        order. Returns the re-admitted requests."""
        rep = self.replicas[rid]
        if rep.state in (ReplicaState.DEAD, ReplicaState.LEFT):
            return []
        rep.stop_thread()
        rep.state = ReplicaState.DEAD
        self.registry.dead(rep.member)
        self._m["replicas"].set(len(self.live()))
        self._record_event("kill", rid, reason=reason,
                           orphaned=len(rep.aboard))
        # completed-but-unharvested requests are acked work, never
        # replayed; everything else aboard is reset and re-routed
        self.completed.extend(rep.harvest_done())
        orphans = [rep.aboard.pop(seq) for seq in sorted(rep.aboard)]
        if not self.admitting() and orphans:
            self.grow(reason="kill-recovery")
        for req in orphans:
            self._reset_request(req)
            self.readmissions += 1
            self.readmission_log.append(req.rid)
            self._m["readmissions"].inc()
            self.router.dispatch(req)
        if orphans:
            logger.warning(
                "fleet: replica %d died (%s); re-admitted %d requests on "
                "survivors in submission order", rid, reason, len(orphans))
        return orphans

    @staticmethod
    def _reset_request(req: Request) -> None:
        """Back to the pre-admission state (the arrival time is kept, so
        TTFT includes the wasted first attempt)."""
        req.tokens = []
        req.tpot = []
        req.ttft = None
        req.finished_at = None
        req.slot = None
        req.error = None
        req._prefill_pos = 0
        req._last_token_t = 0.0

    # -- dispatch bookkeeping (called by the router) -------------------------
    def submit_on(self, rep: EngineReplica, req: Request) -> None:
        if not hasattr(req, "_fleet_seq"):
            req._fleet_seq = self._seq          # type: ignore[attr-defined]
            self._seq += 1
        rep.dispatched_count += 1
        rep.aboard[req._fleet_seq] = req        # type: ignore[attr-defined]
        rep.scheduler.submit(req)

    def dispatch(self, req: Request) -> int:
        return self.router.dispatch(req)

    # -- the fleet cycle -----------------------------------------------------
    def _queue_depth(self) -> int:
        return sum(len(r.scheduler.queue) for r in self.live())

    def _reap(self) -> None:
        for rep in list(self.replicas.values()):
            if rep.state in (ReplicaState.READY, ReplicaState.DRAINING):
                self.completed.extend(rep.harvest_done())
            if rep.state == ReplicaState.DRAINING and rep.drained():
                self._finalize_leave(rep)

    def _autoscale(self) -> None:
        ready = self.admitting()
        depth = self._queue_depth()
        self._m["queue"].set(depth)
        if not ready:
            return
        cooled = (self._cycle - self._last_scale_cycle) >= self.cooldown
        if (depth > self.scale_up_depth * len(ready)
                and len(self.live()) < self.max_replicas and cooled):
            self._last_scale_cycle = self._cycle
            self.grow(reason=f"queue_depth={depth}")
            return
        busy = depth > 0 or any(r.load() for r in self.live())
        self._idle_cycles = 0 if busy else self._idle_cycles + 1
        if (self._idle_cycles >= self.scale_down_idle
                and len(ready) > self.min_replicas and cooled):
            self._last_scale_cycle = self._cycle
            self._idle_cycles = 0
            newest = max(r.rid for r in ready)
            self.drain(newest, reason=f"idle>={self.scale_down_idle}")

    def cycle(self, now: Optional[float] = None) -> None:
        """One fleet scheduling cycle: step every live replica that has no
        thread of its own, reap completions and drains, run the
        autoscaler (which reacts inside this same call)."""
        now = time.perf_counter() if now is None else now
        for rep in sorted(self.live(), key=lambda r: r.rid):
            if rep._thread is None:
                rep.step(now)
        self._reap()
        self._autoscale()
        self._cycle += 1

    def run(self, traffic: Optional[Sequence[Request]] = None,
            parallel: bool = False) -> List[Request]:
        """Drive the fleet until ``traffic`` (open-loop arrival offsets,
        as ``ServeScheduler.run`` takes them) is exhausted and every
        request completed. ``parallel=True`` steps each replica on its own
        thread (the replicas are disjoint engines); placement, autoscaling
        and reconcile stay on this thread either way."""
        t0 = time.perf_counter()
        pending = deque(sorted(traffic or [],
                               key=lambda r: r.arrival or 0.0))
        for r in pending:
            r.arrival = t0 + (r.arrival or 0.0)
        if parallel:
            for rep in self.live():
                rep.start_thread()
        try:
            while True:
                now = time.perf_counter()
                while pending and pending[0].arrival <= now:
                    self.dispatch(pending.popleft())
                busy = any(r.load() or r.aboard for r in self.live())
                if not pending and not busy:
                    break
                if pending and not busy:
                    wait = pending[0].arrival - now
                    if wait > 0:
                        time.sleep(min(wait, 0.01))
                self.cycle(now)
                if parallel:
                    # the threads step; keep the cycle's cadence bounded
                    # so the autoscaler still reacts
                    time.sleep(1e-4)
                    for rep in self.live():
                        rep.start_thread()     # replicas grown mid-run
        finally:
            for rep in self.replicas.values():
                rep.stop_thread()
        self._reap()
        self._m["queue"].set(self._queue_depth())
        return sorted(self.completed,
                      key=lambda r: getattr(r, "_fleet_seq", r.rid))

    # -- reporting -----------------------------------------------------------
    def _record_event(self, event: str, rid: int, **extra: Any) -> None:
        e = {"event": event, "replica": rid, "cycle": self._cycle,
             "t": round(time.perf_counter(), 6),
             "replicas": len(self.live()),
             "queue_depth": self._queue_depth()}
        e.update(extra)
        self.scale_events.append(e)

    def stats(self) -> Dict[str, Any]:
        members = {}
        for rep in self.replicas.values():
            members[rep.member] = {
                "state": rep.state,
                "load": (rep.load()
                         if rep.state in (ReplicaState.READY,
                                          ReplicaState.DRAINING) else 0),
                "dispatched": rep.dispatched_count,
                "builds": rep.engine.builds,
            }
        return {
            "replicas": len(self.live()),
            "ready": len(self.admitting()),
            "min": self.min_replicas,
            "max": self.max_replicas,
            "queue_depth": self._queue_depth(),
            "completed": len(self.completed),
            "readmissions": self.readmissions,
            "scale_events": len(self.scale_events),
            "listener_failures": self.registry.listener_failures,
            "members": members,
            "router": self.router.stats(),
        }


# ---------------------------------------------------------------------------
# module registry + the /healthz `fleet` block payload
# ---------------------------------------------------------------------------

_active_fleet: Optional[ServingFleet] = None


def _register_fleet(f: ServingFleet) -> None:
    global _active_fleet
    _active_fleet = f


def active_fleet() -> Optional[ServingFleet]:
    return _active_fleet


def fleet_stats() -> Optional[Dict[str, Any]]:
    """Live fleet summary, the ``fleet`` block of ``/healthz``; None when
    this process runs no fleet."""
    f = active_fleet()
    return None if f is None else f.stats()


def reset_for_tests() -> None:
    global _active_fleet
    if _active_fleet is not None:
        for rep in _active_fleet.replicas.values():
            rep.stop_thread()
    _active_fleet = None
