"""hvdmodel-torch: explicit-state model checking of the port's
coordination protocols.

The port's copy of ``horovod_tpu/analysis/model.py``. The drills sample a
handful of hand-picked fault interleavings; this module makes that
coverage exhaustive up to a budget. A deterministic cooperative scheduler
runs the port's REAL protocol code (the eager coordinator's enqueue,
cycle and shutdown, the checkpoint commit barrier and rotation, the
preemption stop-step agreement, the elastic reconcile, the live resize,
the fleet's member registry) against shimmed yield-point primitives
injected through the :mod:`~horovod_tpu_torch.utils.schedhooks` seam
(locks, Condition waits, events, queues, thread spawn, the c10d store
under ``utils.kvstore``, the atomic commit rename), and enumerates thread
interleavings, crash points and message-loss faults with a stateless DFS
plus sleep-set partial-order reduction.

Mechanics
---------
Every simulated thread is a real OS thread gated by a private semaphore:
exactly one runs at a time, and it runs uninterrupted between two shim
operations (coarse atomic blocks: the only visible interleaving points
are the synchronization operations themselves, which is what the
protocols' correctness can legitimately depend on). At each scheduling
point the explorer picks one *transition*: a thread's pending operation
(possibly its "timeout" or injected "lost" variant), or a crash of a
crashable process. A schedule is the ordered list of transitions, the
counterexample *trace*, and replaying the same list deterministically
reproduces the same run (``--replay``). A transition is
``(actor, op, resource, variant)``; the trace file's format is the JAX
package's, so a trace of a scenario that touches no store replays in
either package.

The store is :class:`ModelKV`, a simulated c10d ``Store`` with exactly
the calls the port's ``DistributedKV`` makes (``set``, ``compare_set``,
``wait``, ``get``, ``check``, ``delete_key``, ``clone``): its operations
are named after them in traces (``kv_set``, ``kv_compare_set``,
``kv_wait``, ``kv_get``, ``kv_check``, ``kv_delete_key``), where the JAX
checker's name the coordination service's.

Exploration is stateless DFS over schedules: each run re-executes the
scenario from a fresh initial state (fresh objects, fresh tmpdir, a fresh
simulated store, fresh per-process protocol counters), replays a decision
prefix, then extends with default choices, branching afterwards on the
alternatives not pruned by the sleep set (two adjacent transitions on
different resources of different processes commute; exploring both
orders is redundant).

Invariants are the HVD6xx rules (:mod:`rules_model`): scenarios check
them at a monitor point after every transition and at terminal states,
raising :class:`Violation`; deadlock (every live thread blocked on an
untimed wait) is detected by the scheduler itself (HVD603).

Like the JAX package's, this module needs the runtime importable
(scenarios construct real coordinators and checkpointers), while the rule
catalog lives stdlib-only in :mod:`rules_model`. Budgets:
``HOROVOD_MODEL_BUDGET_SECONDS`` wall-clock per invocation,
``HOROVOD_MODEL_MAX_CRASHES`` crash transitions per schedule,
``HOROVOD_MODEL_SEED`` exploration-order seed (replay ignores it: the
trace alone determines the run).
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import logging
import os
import random
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from horovod_tpu_torch.utils import schedhooks

# A transition key: (actor, op, resource, variant). Stable across
# re-executions of the same prefix because actor names and resource ids
# are assigned in deterministic construction order.
Key = Tuple[str, str, str, str]

_NORM_RE = re.compile(r"[0-9a-f]{8,}")


def _norm_resource(resource: str) -> str:
    return _NORM_RE.sub("#", resource)


class Violation(Exception):
    """An HVD6xx invariant failed under some schedule."""

    def __init__(self, code: str, message: str):
        self.code = code
        super().__init__(message)


class ReplayDivergence(RuntimeError):
    """A replayed trace named a transition that is not enabled — the
    scenario is not deterministic or the trace belongs to different
    code."""


class _CrashInterrupt(BaseException):
    """Unwinds a killed simulated thread at its next shim operation.
    BaseException so protocol-level ``except Exception`` recovery code
    cannot resurrect a crashed thread."""


class _DepthExceeded(Exception):
    """Schedule exceeded the per-run transition bound. UNSOUND to ignore:
    states past the bound were never checked, so exploration that hit
    this must not claim exhaustiveness."""


class _SleepPruned(Exception):
    """Every enabled transition is in the sleep set — the schedule is a
    redundant reordering of one already explored. Sound to drop."""


# ---------------------------------------------------------------------------
# simulated threads / processes
# ---------------------------------------------------------------------------

class _Pending:
    __slots__ = ("op", "resource", "variants_fn")

    def __init__(self, op: str, resource: str,
                 variants_fn: Callable[[], List[str]]):
        self.op = op
        self.resource = resource
        self.variants_fn = variants_fn


class SimProcess:
    """Crash unit: a named group of simulated threads sharing a
    (process_index, process_count) identity. Crashing it kills every
    thread without unwinding protocol state — in-memory effects stop,
    filesystem and KV effects persist, exactly like a host dying."""

    def __init__(self, name: str, crashable: bool, pidx: int, nproc: int):
        self.name = name
        self.crashable = crashable
        self.pidx = pidx
        self.nproc = nproc
        self.threads: List["SimThread"] = []
        self.crashed = False


class SimThread:
    """One simulated thread — doubles as the threading.Thread-like object
    the SchedulerHooks seam hands to the protocol code."""

    def __init__(self, h: "Harness", process: SimProcess, target: Callable,
                 name: str, daemon: bool = True, args: tuple = ()):
        self.h = h
        self.process = process
        self.name = name
        self.qname = f"{process.name}.{name}"
        self.daemon = daemon
        self._target = target
        self._args = args
        self.go = threading.Semaphore(0)
        self.pending: Optional[_Pending] = None
        self.chosen: str = "do"
        self.started = False
        self.done = False
        self.killed = False
        self.failure: Optional[BaseException] = None
        self._os_thread = threading.Thread(
            target=self._run, name=f"hvdmodel-{self.qname}", daemon=True)

    # -- threading.Thread interface (what protocol code uses) ---------------
    def start(self) -> None:
        if self.started:
            raise RuntimeError(f"thread {self.qname} started twice")
        self.started = True
        self.process.threads.append(self)
        self.h.threads.append(self)
        self.pending = _Pending("start", f"thread:{self.qname}",
                                lambda: ["do"])
        self._os_thread.start()
        self.h.op("spawn", f"thread:{self.qname}")

    def join(self, timeout: Optional[float] = None) -> None:
        t = self.h.cur()
        if t is None:
            if not (self.done or self.killed):
                raise RuntimeError(
                    f"join({self.qname}) outside the simulation would block")
            return
        self.h.op("join", f"thread:{self.qname}")
        while not (self.done or self.killed):
            v = self.h.block(f"thread:{self.qname}",
                             lambda: self.done or self.killed,
                             timeout_allowed=timeout is not None)
            if v == "timeout":
                return

    def is_alive(self) -> bool:
        return self.started and not self.done and not self.killed

    # -- scheduler side ------------------------------------------------------
    def _run(self) -> None:
        self.go.acquire()
        self.h._by_os[threading.get_ident()] = self
        try:
            if self.killed:
                return
            self._target(*self._args)
        except _CrashInterrupt:
            pass
        except BaseException as e:       # noqa: BLE001 - reported by scheduler
            self.failure = e
        finally:
            self.done = True
            self.h._by_os.pop(threading.get_ident(), None)
            self.h._sched.release()


# ---------------------------------------------------------------------------
# shimmed primitives (the cooperative stand-ins the hooks hand out)
# ---------------------------------------------------------------------------

class ModelLock:
    def __init__(self, h: "Harness", kind: str = "lock"):
        self.h = h
        self.rid = h.new_rid(kind)
        self.owner: Optional[object] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t = self.h.cur()
        if t is None:
            if self.owner is not None:
                raise RuntimeError(f"{self.rid} contended outside simulation")
            self.owner = "<main>"
            return True
        self.h.op("acquire", self.rid)
        while self.owner is not None:
            if not blocking:
                return False
            v = self.h.block(self.rid, lambda: self.owner is None,
                             timeout_allowed=timeout is not None
                             and timeout >= 0)
            if v == "timeout" and self.owner is not None:
                return False
        self.owner = t
        return True

    def release(self) -> None:
        self.owner = None
        if self.h.cur() is not None:
            self.h.op("release", self.rid)

    def locked(self) -> bool:
        return self.owner is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class ModelRLock(ModelLock):
    def __init__(self, h: "Harness"):
        super().__init__(h, kind="rlock")
        self.depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t = self.h.cur()
        if t is not None and self.owner is t:
            self.depth += 1
            self.h.op("reacquire", self.rid)
            return True
        ok = super().acquire(blocking, timeout)
        if ok:
            self.depth = 1
        return ok

    def release(self) -> None:
        self.depth -= 1
        if self.depth > 0:
            if self.h.cur() is not None:
                self.h.op("rerelease", self.rid)
            return
        super().release()


class ModelEvent:
    def __init__(self, h: "Harness"):
        self.h = h
        self.rid = h.new_rid("event")
        self._set = False

    def set(self) -> None:
        self._set = True
        if self.h.cur() is not None:
            self.h.op("set", self.rid)

    def clear(self) -> None:
        self._set = False
        if self.h.cur() is not None:
            self.h.op("clear", self.rid)

    def is_set(self) -> bool:
        return self._set

    def wait(self, timeout: Optional[float] = None) -> bool:
        t = self.h.cur()
        if t is None:
            return self._set
        self.h.op("wait", self.rid)
        if not self._set:
            self.h.block(self.rid, lambda: self._set,
                         timeout_allowed=timeout is not None)
        return self._set


class ModelCondition:
    """Condition over a ModelLock. ``notify`` wakes every current waiter
    (the conservative over-approximation: more schedules, never fewer);
    notifications are NOT queued — a wait that starts after the notify
    misses it, which is exactly the lost-wakeup shape HVD603 hunts."""

    def __init__(self, h: "Harness", lock=None):
        self.h = h
        self._lock = lock if lock is not None else ModelLock(h)
        self.rid = h.new_rid("cond")
        self._gen = 0

    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        return self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        t = self.h.cur()
        if t is None or self._lock.owner is not t:
            raise RuntimeError("Condition.wait without holding its lock")
        gen0 = self._gen
        self._lock.release()
        v = self.h.block(self.rid, lambda: self._gen > gen0,
                         timeout_allowed=timeout is not None)
        self._lock.acquire()
        return v == "wake"

    def notify(self, n: int = 1) -> None:
        self.notify_all()

    def notify_all(self) -> None:
        self._gen += 1
        if self.h.cur() is not None:
            self.h.op("notify", self.rid)


class ModelQueue:
    """queue.Queue interface subset used by the checkpoint writer."""

    def __init__(self, h: "Harness"):
        self.h = h
        self.rid = h.new_rid("queue")
        self._items: List[Any] = []
        self.unfinished_tasks = 0

    def put(self, item: Any) -> None:
        if self.h.cur() is not None:
            self.h.op("put", self.rid)
        self._items.append(item)
        self.unfinished_tasks += 1

    def get(self, block: bool = True, timeout: Optional[float] = None):
        self.h.op("get", self.rid)
        while not self._items:
            self.h.block(self.rid, lambda: bool(self._items),
                         timeout_allowed=False)
        return self._items.pop(0)

    def task_done(self) -> None:
        if self.h.cur() is not None:
            self.h.op("task_done", self.rid)
        self.unfinished_tasks -= 1

    def join(self) -> None:
        t = self.h.cur()
        if t is None:
            if self.unfinished_tasks:
                raise RuntimeError("Queue.join outside simulation would "
                                   "block")
            return
        self.h.op("join", self.rid)
        while self.unfinished_tasks > 0:
            self.h.block(self.rid, lambda: self.unfinished_tasks == 0,
                         timeout_allowed=False)

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items


def _store_bytes(value: Any) -> bytes:
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    return str(value).encode()


class ModelKV:
    """Simulated c10d ``Store``: the calls the port's ``DistributedKV``
    makes, on a dict every simulated process shares, with c10d's
    semantics. ``set`` overwrites. ``compare_set(key, expected,
    desired)`` writes ``desired`` when the key holds ``expected`` or,
    with an empty ``expected``, when the key is missing, and returns what
    the key holds afterwards (``expected`` itself for a missing key and a
    nonempty ``expected``, as c10d's server answers). ``wait`` and
    ``get`` block until the keys exist, with an explorable ``timeout``
    variant that raises ``DistStoreError``. ``check`` tells whether the
    keys exist; ``delete_key`` removes one. Values come back as bytes.
    ``clone`` is a new connection onto the same state.

    A ``lost`` variant (message-loss injection, when the scenario's loss
    budget allows) makes ``set``, ``compare_set``, ``wait`` or ``get``
    raise ``DistNetworkError`` without applying: the transport-failure
    case, which ``kvstore._transport`` turns into a retried
    ``UNAVAILABLE``. ``check`` and ``delete_key`` are not lossy, as the
    JAX checker's ``try_get`` and ``delete`` are not."""

    def __init__(self, h: "Harness", data: Optional[Dict[str, bytes]] = None):
        self.h = h
        self.data: Dict[str, bytes] = {} if data is None else data

    def _op(self, op: str, resource: str, lossy: bool = True) -> None:
        if self.h.op(op, resource, lossy=lossy) == "lost":
            import torch.distributed as dist
            raise dist.DistNetworkError(
                f"hvdmodel-torch injected message loss ({op} {resource})")

    def _block(self, resource: str, keys: List[str], what: str) -> None:
        while not all(k in self.data for k in keys):
            v = self.h.block(resource,
                             lambda: all(k in self.data for k in keys),
                             timeout_allowed=True)
            if v == "timeout" and not all(k in self.data for k in keys):
                import torch.distributed as dist
                raise dist.DistStoreError(
                    f"{what}: timeout waiting for {keys} (hvdmodel-torch "
                    f"simulated store timeout)")

    def set(self, key: str, value: Any) -> None:
        self._op("kv_set", f"kv:{key}")
        self.data[key] = _store_bytes(value)

    def compare_set(self, key: str, expected_value: Any,
                    desired_value: Any) -> bytes:
        self._op("kv_compare_set", f"kv:{key}")
        expected = _store_bytes(expected_value)
        desired = _store_bytes(desired_value)
        cur = self.data.get(key)
        if cur is None:
            if expected:
                return expected
            self.data[key] = desired
            return desired
        if cur == expected:
            self.data[key] = desired
        return self.data[key]

    def wait(self, keys: Sequence[str], timeout: Any = None) -> None:
        keys = list(keys)
        # a wait on several keys depends on every one of them: "*" is
        # dependent with every transition in the sleep sets
        resource = f"kv:{keys[0]}" if len(keys) == 1 else "*"
        self._op("kv_wait", resource)
        self._block(resource, keys, "wait")

    def get(self, key: str) -> bytes:
        self._op("kv_get", f"kv:{key}")
        self._block(f"kv:{key}", [key], "get")
        return self.data[key]

    def check(self, keys: Sequence[str]) -> bool:
        keys = list(keys)
        self._op("kv_check", f"kv:{keys[0]}" if len(keys) == 1 else "*",
                 lossy=False)
        return all(k in self.data for k in keys)

    def delete_key(self, key: str) -> bool:
        self._op("kv_delete_key", f"kv:{key}", lossy=False)
        return self.data.pop(key, None) is not None

    def clone(self) -> "ModelKV":
        return ModelKV(self.h, self.data)


class ModelHooks(schedhooks.SchedulerHooks):
    """The shim set the checker installs for the duration of one run."""

    def __init__(self, h: "Harness"):
        self._h = h

    def lock(self):
        return ModelLock(self._h)

    def rlock(self):
        return ModelRLock(self._h)

    def condition(self, lock=None):
        return ModelCondition(self._h, lock)

    def event(self):
        return ModelEvent(self._h)

    def queue(self):
        return ModelQueue(self._h)

    def thread(self, target, name=None, daemon=True, args=()):
        h = self._h
        proc = h.current_process() or h.build_process or h.env_process
        return SimThread(h, proc, target, name or h.new_rid("thread"),
                         daemon=daemon, args=args)

    def rename(self, src: str, dst: str) -> None:
        # THE commit point: a crash transition chosen instead of this
        # rename is the torn-write case every restore must survive.
        self._h.op("rename", "fs")
        os.rename(src, dst)

    def sleep(self, seconds: float) -> None:
        if self._h.cur() is not None:
            self._h.op("sleep", "clock")

    def kv_client(self):
        return self._h.kv

    def world(self):
        p = self._h.current_process() or self._h.build_process
        if p is None:
            return None
        return (p.pidx, p.nproc)


# ---------------------------------------------------------------------------
# the harness: scheduler + scenario-facing API
# ---------------------------------------------------------------------------

class Harness:
    """Per-run state: simulated processes/threads, the shared KV store,
    a fresh tmpdir, the controller that decides each transition, and the
    monitor hook evaluated after every transition."""

    def __init__(self, controller: "_Controller", max_crashes: int,
                 max_losses: int, tmpdir: str):
        self.controller = controller
        self.max_crashes = max_crashes
        self.max_losses = max_losses
        self.crashes_used = 0
        self.losses_used = 0
        self.tmpdir = tmpdir
        self.kv = ModelKV(self)
        self.threads: List[SimThread] = []
        self.processes: List[SimProcess] = []
        self.env_process = SimProcess("env", crashable=False, pidx=0,
                                      nproc=1)
        self.build_process: Optional[SimProcess] = None
        self.monitor: Optional[Callable[[], None]] = None
        self._sched = threading.Semaphore(0)
        self._by_os: Dict[int, SimThread] = {}
        self._rid_counts: Dict[str, int] = {}

    # -- scenario-facing API -------------------------------------------------
    def process(self, name: str, crashable: bool = False, pidx: int = 0,
                nproc: int = 1) -> SimProcess:
        p = SimProcess(name, crashable, pidx, nproc)
        self.processes.append(p)
        return p

    def spawn(self, process: SimProcess, fn: Callable,
              name: str = "t") -> SimThread:
        t = SimThread(self, process, fn, name)
        t.start()
        return t

    def on(self, process: SimProcess):
        """Context manager: objects/threads constructed on the main
        thread inside it belong to ``process``."""
        h = self

        class _On:
            def __enter__(self):
                h.build_process = process
                return process

            def __exit__(self, *exc):
                h.build_process = None

        return _On()

    def violation(self, code: str, message: str) -> None:
        raise Violation(code, message)

    # -- scheduler core ------------------------------------------------------
    def cur(self) -> Optional[SimThread]:
        return self._by_os.get(threading.get_ident())

    def current_process(self) -> Optional[SimProcess]:
        t = self.cur()
        return t.process if t is not None else None

    def new_rid(self, kind: str) -> str:
        n = self._rid_counts.get(kind, 0)
        self._rid_counts[kind] = n + 1
        return f"{kind}{n}"

    def op(self, kind: str, resource: str, lossy: bool = False) -> str:
        t = self.cur()
        if t is None:
            return "do"
        if t.killed:
            raise _CrashInterrupt()
        resource = _norm_resource(resource)

        def variants():
            v = ["do"]
            if lossy and self.losses_used < self.max_losses:
                v.append("lost")
            return v

        chosen = self._park(t, _Pending(kind, resource, variants))
        if chosen == "lost":
            self.losses_used += 1
        return chosen

    def block(self, resource: str, wake: Callable[[], bool],
              timeout_allowed: bool) -> str:
        t = self.cur()
        if t is None:
            if wake():
                return "wake"
            raise RuntimeError(
                f"blocking shim operation on {resource} outside the "
                f"simulation")
        if t.killed:
            raise _CrashInterrupt()
        resource = _norm_resource(resource)

        def variants():
            v = []
            if wake():
                v.append("wake")
            if timeout_allowed:
                v.append("timeout")
            return v

        return self._park(t, _Pending("wait", resource, variants))

    def _park(self, t: SimThread, pending: _Pending) -> str:
        t.pending = pending
        self._sched.release()
        t.go.acquire()
        if t.killed:
            raise _CrashInterrupt()
        return t.chosen

    def _switch_to(self, t: SimThread, variant: str) -> None:
        t.chosen = variant
        t.pending = None
        t.go.release()
        self._sched.acquire()

    def _crash(self, pname: str) -> None:
        for p in self.processes:
            if p.name == pname:
                p.crashed = True
                self.crashes_used += 1
                for t in p.threads:
                    t.killed = True
                return
        raise ReplayDivergence(f"crash of unknown process {pname!r}")

    def _enabled(self) -> List[Key]:
        keys: List[Key] = []
        for t in self.threads:
            if t.done or t.killed or not t.started or t.pending is None:
                continue
            for v in t.pending.variants_fn():
                keys.append((t.qname, t.pending.op, t.pending.resource, v))
        if self.crashes_used < self.max_crashes:
            for p in self.processes:
                if p.crashable and not p.crashed and any(
                        not t.done for t in p.threads):
                    keys.append((p.name, "crash", "*", "crash"))
        return keys

    def _blocked_live(self) -> List[SimThread]:
        return [t for t in self.threads
                if t.started and not t.done and not t.killed]

    def go(self) -> None:
        """Run the scheduler until every live thread is done (or the
        controller prunes / a Violation fires). Call again after
        spawning restart-phase processes."""
        while True:
            enabled = self._enabled()
            if not enabled:
                stuck = self._blocked_live()
                if stuck:
                    detail = "; ".join(
                        f"{t.qname} blocked on "
                        f"{t.pending.resource if t.pending else '?'}"
                        for t in stuck)
                    raise Violation(
                        "HVD603",
                        f"deadlock/lost-wakeup: no transition is enabled "
                        f"but {len(stuck)} thread(s) are blocked on "
                        f"untimed waits ({detail})")
                return
            chosen = self.controller.choose(enabled)
            if chosen is None:       # every enabled transition is asleep
                raise _SleepPruned("pruned")
            if chosen[1] == "crash":
                self._crash(chosen[0])
            else:
                t = next((x for x in self.threads
                          if x.qname == chosen[0] and x.pending is not None),
                         None)
                if t is None:
                    raise ReplayDivergence(
                        f"transition {chosen} names no schedulable thread")
                self._switch_to(t, chosen[3])
                if t.failure is not None:
                    f, t.failure = t.failure, None
                    if isinstance(f, Violation):
                        raise f
                    raise Violation(
                        "HVD603",
                        f"thread {t.qname} died with an unhandled "
                        f"{type(f).__name__}: {f} — its peers would block "
                        f"on it forever")
            if self.monitor is not None:
                self.monitor()

    def teardown(self) -> None:
        """Kill and unwind every remaining thread (shim ops raise
        _CrashInterrupt for killed threads, so the unwind cannot mutate
        protocol or filesystem state)."""
        for t in self.threads:
            t.killed = True
        for t in self.threads:
            if t.done or not t.started:
                continue
            t.go.release()
            self._sched.acquire(timeout=10)
        for t in self.threads:
            if t.started:
                t._os_thread.join(timeout=10)


# ---------------------------------------------------------------------------
# controller: prefix replay + sleep-set default policy + recording
# ---------------------------------------------------------------------------

def _independent(a: Key, b: Key) -> bool:
    """Conservative independence for the sleep sets. A transition is a
    yield operation PLUS the atomic block the thread runs up to its next
    yield, and that block can touch arbitrary memory of its own process
    — so two transitions commute only when they belong to DIFFERENT
    simulated processes and name different shared resources (the KV key
    / fs commit surface is all that crosses process boundaries in these
    protocols). Same process, same resource, or a crash: dependent."""
    if a[0] == b[0]:
        return False
    if a[0].split(".", 1)[0] == b[0].split(".", 1)[0]:
        return False
    if a[2] == "*" or b[2] == "*":
        return False
    return a[2] != b[2]


class _Controller:
    def __init__(self, prefix: Sequence[Key], sleep: frozenset,
                 max_steps: int):
        self.prefix = list(prefix)
        self.sleep: Set[Key] = set(sleep)
        self.max_steps = max_steps
        self.decisions: List[Tuple[Key, Tuple[Key, ...]]] = []

    def choose(self, enabled: List[Key]) -> Optional[Key]:
        if len(self.decisions) >= self.max_steps:
            raise _DepthExceeded(
                f"schedule exceeded {self.max_steps} transitions")
        enabled = sorted(enabled)
        i = len(self.decisions)
        if i < len(self.prefix):
            chosen = self.prefix[i]
            if chosen not in enabled:
                raise ReplayDivergence(
                    f"trace step {i}: {'|'.join(chosen)} not enabled "
                    f"(enabled: {[' | '.join(k) for k in enabled]})")
        else:
            candidates = [k for k in enabled if k not in self.sleep]
            if not candidates:
                return None
            chosen = candidates[0]
        self.decisions.append((chosen, tuple(enabled)))
        if i >= len(self.prefix):
            self.sleep = {s for s in self.sleep if _independent(s, chosen)}
        return chosen


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Scenario:
    """One model-checking target: ``fn(harness)`` builds the processes
    and threads (running REAL protocol code through the shims), drives
    ``harness.go()``, and checks invariants with ``harness.violation``.
    ``knobs`` are registry overrides installed for the run."""

    name: str
    fn: Callable[[Harness], None]
    max_crashes: int = 0
    max_losses: int = 0
    knobs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    codes: Tuple[str, ...] = ()
    """Rule codes this scenario is built to be caught by (corpus
    fixtures) or could plausibly emit (builtins). When declared,
    the corpus tests assert findings match it exactly."""


@dataclasses.dataclass
class ModelFinding:
    code: str
    message: str
    scenario: str
    trace: List[Key]


@dataclasses.dataclass
class ExploreResult:
    scenario: Scenario
    runs: int = 0
    transitions: int = 0
    pruned: int = 0          # sleep-set prunes — sound, redundant schedules
    depth_truncated: int = 0  # runs cut at max_steps — UNSOUND to ignore
    exhausted: bool = False
    budget_s: float = 0.0
    findings: List[ModelFinding] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _RunOutcome:
    chosen: List[Key]
    decisions: List[Tuple[Key, Tuple[Key, ...]]]
    violation: Optional[Violation]
    pruned: bool          # sleep-set prune (sound)
    depth_truncated: bool  # hit max_steps (unsound — forfeits exhaustion)


def _fresh_process_counters() -> Tuple[Any, ...]:
    """Each explored schedule plays processes that start afresh, but the
    simulated processes of all schedules share this one: empty the port's
    per-process protocol state for the run (the preemption handlers'
    stop-key sequences and the installed handler, the checkpoint commit
    attempts) and return what the host process held, for
    :func:`_restore_process_counters`."""
    from horovod_tpu_torch.resilience import async_checkpoint, preemption
    saved = (dict(preemption._handler_seqs), preemption._active_handler,
             dict(async_checkpoint._attempts))
    preemption._handler_seqs.clear()
    preemption._active_handler = None
    async_checkpoint._attempts.clear()
    return saved


def _restore_process_counters(saved: Tuple[Any, ...]) -> None:
    from horovod_tpu_torch.resilience import async_checkpoint, preemption
    seqs, active, attempts = saved
    preemption._handler_seqs.clear()
    preemption._handler_seqs.update(seqs)
    preemption._active_handler = active
    async_checkpoint._attempts.clear()
    async_checkpoint._attempts.update(attempts)


def _run_once(scenario: Scenario, prefix: Sequence[Key], sleep: frozenset,
              max_steps: int,
              max_crashes: Optional[int] = None,
              max_losses: Optional[int] = None) -> _RunOutcome:
    from horovod_tpu_torch.config import knobs
    controller = _Controller(prefix, sleep, max_steps)
    tmpdir = tempfile.mkdtemp(prefix="hvdmodel-")
    if max_crashes is None:
        max_crashes = min(scenario.max_crashes,
                          int(knobs.get("HOROVOD_MODEL_MAX_CRASHES")))
    h = Harness(controller, max_crashes,
                scenario.max_losses if max_losses is None else max_losses,
                tmpdir)
    overrides = dict(scenario.knobs)
    prev_hooks = schedhooks.install(ModelHooks(h))
    violation: Optional[Violation] = None
    pruned = False
    depth_truncated = False
    # Protocol warning paths (abandoned commits, quiesce notices) are
    # the EXPECTED outcomes of injected faults — thousands of explored
    # schedules must not spam the log. Scoped to the run.
    logging.disable(logging.WARNING)
    counters = _fresh_process_counters()
    try:
        for k, v in overrides.items():
            knobs.set_override(k, v)
        try:
            scenario.fn(h)
        except Violation as v:
            violation = v
        except _SleepPruned:
            pruned = True
        except _DepthExceeded:
            depth_truncated = True
    finally:
        try:
            h.teardown()
        finally:
            logging.disable(logging.NOTSET)
            schedhooks.install(prev_hooks)
            _restore_process_counters(counters)
            for k in overrides:
                knobs.clear_override(k)
            shutil.rmtree(tmpdir, ignore_errors=True)
    return _RunOutcome([c for c, _ in controller.decisions],
                       controller.decisions, violation, pruned,
                       depth_truncated)


def explore(scenario: Scenario, budget_s: float = 5.0,
            seed: int = 0, max_steps: int = 3000) -> ExploreResult:
    """Stateless DFS with sleep sets over ``scenario``'s schedules until
    the frontier empties or the wall-clock budget runs out. One
    counterexample is kept per rule code (the first — shortest-prefix —
    schedule that violates it)."""
    res = ExploreResult(scenario=scenario, budget_s=budget_s)
    deadline = time.monotonic() + budget_s
    rng = random.Random(seed)
    stack: List[Tuple[List[Key], frozenset]] = [([], frozenset())]
    seen_codes: Set[str] = set()
    while stack:
        if res.runs > 0 and time.monotonic() > deadline:
            break
        prefix, sleep0 = stack.pop()
        out = _run_once(scenario, prefix, sleep0, max_steps)
        res.runs += 1
        res.transitions += len(out.decisions)
        if out.violation is not None:
            if out.violation.code not in seen_codes:
                seen_codes.add(out.violation.code)
                res.findings.append(ModelFinding(
                    out.violation.code, str(out.violation), scenario.name,
                    out.chosen))
        if out.pruned:
            res.pruned += 1
        if out.depth_truncated:
            res.depth_truncated += 1
        # Branch from EVERY decision point of the run — including runs
        # that ended in a violation or hit the depth bound: their
        # decisions are valid schedule prefixes, and dropping their
        # alternatives would silently amputate the subtree (a second
        # rule's counterexample could live there).
        sleep: Set[Key] = set(sleep0)
        for i, (chosen, enabled) in enumerate(out.decisions):
            if i >= len(prefix):
                alts = [k for k in enabled
                        if k != chosen and k not in sleep]
                if len(alts) > 1 and seed:
                    rng.shuffle(alts)
                acc: Set[Key] = set()
                branches = []
                for a in alts:
                    # Godefroid sleep sets: the child that TAKES `a`
                    # starts with the node's sleep plus the previously
                    # explored choices — filtered by independence with
                    # `a` itself, since a dependent sleeper is woken by
                    # taking it. (The controller only evolves sleep
                    # beyond the prefix, so `a`'s own wake effect must
                    # be applied here.)
                    child_sleep = frozenset(
                        s for s in (sleep | {chosen} | acc)
                        if _independent(s, a))
                    branches.append((out.chosen[:i] + [a], child_sleep))
                    acc.add(a)
                stack.extend(reversed(branches))
                sleep = {s for s in sleep if _independent(s, chosen)}
    else:
        # The frontier emptied — but exhaustion also requires that no run
        # was cut at the depth bound: a truncated suffix was never checked.
        res.exhausted = res.depth_truncated == 0
    return res


def replay(scenario: Scenario, trace: Sequence[Key],
           max_steps: int = 3000) -> _RunOutcome:
    """Deterministically re-execute a recorded counterexample trace.
    Fault budgets are opened wide: the trace itself says exactly which
    crash/loss transitions fire, independent of the current knobs."""
    return _run_once(scenario, list(trace), frozenset(), max_steps,
                     max_crashes=max(scenario.max_crashes, 64),
                     max_losses=max(scenario.max_losses, 64))


# ---------------------------------------------------------------------------
# trace (de)serialization
# ---------------------------------------------------------------------------

def trace_to_json(scenario_spec: str, finding: ModelFinding) -> str:
    return json.dumps({
        "hvdmodel_trace": 1,
        "scenario": scenario_spec,
        "code": finding.code,
        "message": finding.message,
        "trace": ["|".join(k) for k in finding.trace],
    }, indent=1)


def trace_from_json(text: str) -> Tuple[str, List[Key]]:
    data = json.loads(text)
    if "hvdmodel_trace" not in data:
        raise ValueError("not an hvdmodel trace file")
    trace = [tuple(s.split("|")) for s in data["trace"]]
    for k in trace:
        if len(k) != 4:
            raise ValueError(f"malformed trace entry {k!r}")
    return data["scenario"], trace     # type: ignore[return-value]



# ---------------------------------------------------------------------------
# built-in scenarios: the port's real protocols
# ---------------------------------------------------------------------------

class _RecHandle:
    """Minimal pending-handle stand-in at the coordinator's data-plane
    boundary (the real eager.Handle drags in the stall inspector; the
    negotiation protocol under check never looks past this interface)."""

    def __init__(self, name: str):
        self.name = name
        self.value = None
        self.error: Optional[BaseException] = None
        self.resolved = False

    def _set_result(self, value, event=None, watch=None):
        self.value = value
        self.resolved = True

    def _set_error(self, exc):
        self.error = exc
        self.resolved = True

    def _untrack(self):
        pass

    def _retrack(self):
        pass


class _StubTopology:
    is_hierarchical = False
    flat_axes = ("hvd",)
    mesh = None
    size = 1


class _StubCtx:
    """What the port's ``Coordinator`` reads of its context: a world of
    one on the CPU, no join registry entries."""

    def __init__(self):
        import torch
        self.topology = _StubTopology()
        self.device = torch.device("cpu")
        self.coordinator = None
        self.joined_ranks = ()
        self.size = 1
        self.rank = 0


def _scenario_coordinator(h: Harness) -> None:
    """Enqueue/cycle/shutdown negotiation of the eager coordinator:
    concurrent producers (one atomic group + a loose tensor), a cycle
    driver, and a shutdown racing them. HVD604: every enqueued handle
    must be resolved (result or error) once the coordinator is down —
    a queued gradient that nobody ever dispatches is a hung training
    step."""
    import torch

    from horovod_tpu_torch.ops.coordinator import Coordinator, Entry

    proc = h.process("ctl0")
    handles: List[_RecHandle] = []
    box: Dict[str, Any] = {}

    class _ModelCoordinator(Coordinator):
        # Data plane stubbed at the dispatch boundary: negotiation
        # (queue, fusion planning, group deferral, handle resolution,
        # shutdown flush) is the real code above this method.
        def _dispatch_bin(self, entries, lane, watch=None):
            h.op("dispatch", "dispatch")
            for e in entries:
                e.handle._set_result(e.x)
            self.queue.mark_complete([e.name for e in entries])
            return None

    def entry(name, group_id=None, group_size=0):
        hd = _RecHandle(name)
        handles.append(hd)
        return Entry(name=name, op_type="allreduce",
                     x=torch.zeros(2, dtype=torch.float32), handle=hd,
                     group_id=group_id, group_size=group_size)

    def starter():
        box["coord"] = _ModelCoordinator(_StubCtx(), start_thread=False)

    with h.on(proc):
        st = h.spawn(proc, starter, "init")

    def producer_a():
        st.join()
        box["coord"].enqueue(entry("grad.a"))
        box["coord"].enqueue(entry("grad.g1", group_id=1, group_size=2))

    def producer_b():
        st.join()
        box["coord"].enqueue(entry("grad.g2", group_id=1, group_size=2))

    def cycler():
        st.join()
        box["coord"].run_cycle()
        box["coord"].run_cycle()

    def closer(ta, tb, tc):
        ta.join()
        tb.join()
        tc.join()
        box["coord"].shutdown()

    with h.on(proc):
        ta = h.spawn(proc, producer_a, "prod_a")
        tb = h.spawn(proc, producer_b, "prod_b")
        tc = h.spawn(proc, cycler, "cycler")
        h.spawn(proc, lambda: closer(ta, tb, tc), "closer")
    h.go()
    lost = [hd.name for hd in handles if not hd.resolved]
    if lost:
        h.violation(
            "HVD604",
            f"lost tensor(s): {lost} were enqueued but never resolved "
            f"after coordinator shutdown — the owning training step "
            f"would block forever on synchronize()")


def _ckpt_monitor(h: Harness, directory: str,
                  state: Dict[str, Any]) -> None:
    """HVD602 monitor: every committed manifest is complete (each listed
    pickle shard exists and hashes to its manifest digest), and once any
    checkpoint has committed, rotation/commit activity never leaves the
    directory without a committed snapshot."""
    import hashlib as _hl

    from horovod_tpu_torch.resilience.async_checkpoint import (
        list_committed_steps, read_manifest, step_dirname,
    )

    steps = list_committed_steps(directory)
    for s in steps:
        dpath = os.path.join(directory, step_dirname(s))
        manifest = read_manifest(dpath)
        if manifest is None:
            continue
        if manifest.get("format") != "pickle":
            continue
        digests = manifest.get("shard_digests") or []
        for i, want in enumerate(digests):
            spath = os.path.join(dpath, f"shard-{i:05d}.pkl")
            if not os.path.exists(spath):
                h.violation(
                    "HVD602",
                    f"step {s} is published as committed but shard "
                    f"{i} is missing — a restore would adopt a "
                    f"partially-published checkpoint")
            if want:
                with open(spath, "rb") as f:
                    got = _hl.sha256(f.read()).hexdigest()
                if got != want:
                    h.violation(
                        "HVD602",
                        f"step {s} is committed but shard {i}'s bytes "
                        f"do not match the manifest digest — torn write "
                        f"published as committed")
    if state.get("ever_committed") and not steps:
        h.violation(
            "HVD602",
            "rotation deleted the last committed snapshot: the "
            "directory held a committed checkpoint earlier in this "
            "schedule and now holds none — a crash here leaves nothing "
            "to restore")
    if steps:
        state["ever_committed"] = True


def _scenario_checkpoint(h: Harness) -> None:
    """Single-controller async checkpoint: saver vs writer-thread
    interleavings, rotation, and a crash budget of 1 at any yield point
    (incl. instead of the commit rename). HVD602 via the monitor."""
    directory = os.path.join(h.tmpdir, "ckpt")
    state: Dict[str, Any] = {}
    h.monitor = lambda: _ckpt_monitor(h, directory, state)
    proc = h.process("train0", crashable=True)

    def loop():
        from horovod_tpu_torch.resilience.async_checkpoint import (
            AsyncCheckpointer,
        )
        ckpt = AsyncCheckpointer(directory, interval=1, max_to_keep=1,
                                 fmt="pickle", commit_timeout=5)
        for step in (1, 2):
            ckpt.save(step, {"w": float(step)})
        ckpt.close()

    with h.on(proc):
        h.spawn(proc, loop, "train")
    h.go()
    _ckpt_monitor(h, directory, state)


def _scenario_checkpoint_multihost(h: Harness) -> None:
    """Two-controller commit barrier over the simulated store with a
    crash budget of 1: a dead host must time the barrier out and abandon
    the attempt UNCOMMITTED; whatever is published as committed must be
    complete (HVD602). Barrier timeouts are explorable transitions, so
    the slow-peer case is covered without a wall clock. The port's
    several-rank ``maybe_save`` first agrees on the save over the store
    (``_agree``), and a peer that does not reach it in time raises
    ``CheckpointCommitError`` there: the same abandoned-uncommitted
    outcome the JAX scenario takes from ``wait()``."""
    directory = os.path.join(h.tmpdir, "ckpt")
    state: Dict[str, Any] = {}
    h.monitor = lambda: _ckpt_monitor(h, directory, state)
    procs = [h.process(f"host{r}", crashable=True, pidx=r, nproc=2)
             for r in range(2)]

    def host(r):
        def loop():
            from horovod_tpu_torch.resilience.async_checkpoint import (
                AsyncCheckpointer, CheckpointCommitError,
            )
            ckpt = AsyncCheckpointer(directory, interval=1, max_to_keep=2,
                                     fmt="pickle", commit_timeout=5)
            try:
                for step in (1, 2):
                    ckpt.maybe_save(step, {"w": float(step + r)})
                ckpt.wait()
            except CheckpointCommitError:
                pass
            ckpt.close()
        return loop

    for r, p in enumerate(procs):
        with h.on(p):
            h.spawn(p, host(r), "train")
    h.go()
    _ckpt_monitor(h, directory, state)


class _StepBarrier:
    """Lockstep step barrier (the stand-in for the per-step collectives
    that synchronize real controllers). Built on the shimmed primitives
    so every wait is a scheduling point; ``leave`` lets a quiescing
    controller depart without stranding the rest."""

    def __init__(self, n: int):
        self._cond = schedhooks.Condition()
        self.n = n
        self.arrived = 0
        self.gen = 0

    def wait(self) -> None:
        with self._cond:
            gen = self.gen
            self.arrived += 1
            if self.arrived >= self.n:
                self.arrived = 0
                self.gen += 1
                self._cond.notify_all()
                return
            while self.gen == gen:
                self._cond.wait()

    def leave(self) -> None:
        with self._cond:
            self.n -= 1
            if self.n > 0 and self.arrived >= self.n:
                self.arrived = 0
                self.gen += 1
                self._cond.notify_all()


def _scenario_preemption(h: Harness) -> None:
    """Two-controller stop-step agreement: controller 0 observes the
    eviction notice mid-run; both poll the write-once store key from
    ``check()``. HVD601: every controller that quiesces must quiesce at
    the SAME step (the consistent-sharded-snapshot requirement)."""
    STEPS = 6
    stops: Dict[int, Optional[int]] = {}
    barrier = _StepBarrier(2)
    procs = [h.process(f"ctl{r}", pidx=r, nproc=2) for r in range(2)]

    def ctl(r):
        def loop():
            from horovod_tpu_torch.resilience.preemption import (
                PreemptionHandler,
            )
            handler = PreemptionHandler(checkpointer=None, sentinel="",
                                        margin=2, install_signals=False)
            try:
                for step in range(STEPS):
                    if r == 0 and step == 1:
                        handler.request("maintenance notice")
                    if handler.check(step):
                        stops[r] = step
                        barrier.leave()
                        return
                    barrier.wait()
                stops[r] = None
            finally:
                handler.close()
        return loop

    for r, p in enumerate(procs):
        with h.on(p):
            h.spawn(p, ctl(r), "train")
    h.go()
    agreed = {s for s in stops.values()}
    if len(agreed) > 1:
        h.violation(
            "HVD601",
            f"controllers quiesced at different steps ({stops}): the "
            f"final snapshots are inconsistent across hosts and the "
            f"resumed run mixes step-N and step-M shards")
    if stops and next(iter(agreed)) is None:
        h.violation(
            "HVD601",
            f"a preemption notice was delivered but no controller "
            f"quiesced within {STEPS} steps (stop step never landed "
            f"inside the run)")


def _scenario_elastic(h: Harness) -> None:
    """Elastic driver reconcile: a worker failure (blacklist), a
    resumable preemption exit (respawn without blacklist), and a
    discovery update racing each other through the driver lock.
    Invariants: dense unique ranks, the blacklisted host is gone, the
    preempted host is respawned, no deadlock."""
    proc = h.process("launcher")
    box: Dict[str, Any] = {}
    spawned: List[Tuple[str, int]] = []

    def starter():
        from horovod_tpu_torch.elastic.discovery import FixedHosts
        from horovod_tpu_torch.elastic.driver import ElasticDriver
        disc = FixedHosts({"hostA": 1, "hostB": 1})
        drv = ElasticDriver(disc, min_np=1, max_np=None, timeout=5,
                            clock=lambda: 0.0)
        drv._create_worker_fn = lambda slot: spawned.append(
            (slot.hostname, slot.local_rank))
        drv.host_manager.update_available_hosts()
        drv._update_assignments(initial=True)
        box["disc"], box["drv"] = disc, drv

    with h.on(proc):
        st = h.spawn(proc, starter, "init")

    def fail_b():
        st.join()
        box["drv"].record_worker_exit(rank=1, exit_code=1)

    def preempt_a():
        st.join()
        box["drv"].record_worker_exit(rank=0, exit_code=75)

    def grow():
        st.join()
        from horovod_tpu_torch.elastic.discovery import HostUpdateResult
        box["disc"].set({"hostA": 1, "hostB": 1, "hostC": 1})
        box["drv"].host_manager.update_available_hosts()
        box["drv"]._on_hosts_updated(HostUpdateResult.ADDED)

    with h.on(proc):
        h.spawn(proc, fail_b, "exit_fail")
        h.spawn(proc, preempt_a, "exit_resume")
        h.spawn(proc, grow, "discovery")
    h.go()
    drv = box["drv"]
    slots = drv.current_assignments
    ranks = sorted(s.rank for s in slots)
    if ranks != list(range(len(slots))):
        h.violation(
            "HVD601",
            f"elastic reconcile produced non-dense ranks {ranks}: "
            f"collective programs would disagree on world layout")
    hosts = {s.hostname for s in slots}
    if "hostB" in hosts:
        h.violation(
            "HVD601",
            "failed host hostB survived the blacklist reconcile")
    if "hostA" not in hosts:
        h.violation(
            "HVD601",
            "preempted (resumable) host hostA was dropped — a "
            "resumable exit must respawn the slot, not blacklist it")
    live = {(ww.slot.hostname, ww.slot.local_rank)
            for ww in drv._workers.values() if ww.exit_code is None}
    if ("hostA", 0) not in live:
        h.violation(
            "HVD601",
            "no live worker on hostA after its resumable exit — the "
            "respawn path lost the slot")


def _scenario_resume(h: Harness) -> None:
    """Crash + auto-resume idempotence: a deterministic 3-step train
    loop checkpointing through the real AsyncCheckpointer, a crash
    budget of 1 at any yield point, and a restart phase that restores
    latest-committed and finishes. HVD605: the resumed trajectory must
    land on exactly the crash-free final state."""
    STEPS = 3
    directory = os.path.join(h.tmpdir, "ckpt")

    def step_fn(w: float) -> float:
        return w * 3.0 + 1.0

    expected = 0.0
    for _ in range(STEPS):
        expected = step_fn(expected)

    def loop(out: List[float]):
        from horovod_tpu_torch.resilience.async_checkpoint import (
            AsyncCheckpointer, restore_latest,
        )
        ckpt = AsyncCheckpointer(directory, interval=1, max_to_keep=2,
                                 fmt="pickle", commit_timeout=5)
        start, w = 0, 0.0
        got = restore_latest(directory)
        if got is not None:
            start, w = got[0], float(got[1]["w"])
        for s in range(start, STEPS):
            w = step_fn(w)
            ckpt.save(s + 1, {"w": w})
        ckpt.close()
        out.append(w)

    proc = h.process("train0", crashable=True)
    out1: List[float] = []
    with h.on(proc):
        h.spawn(proc, lambda: loop(out1), "train")
    h.go()
    if proc.crashed:
        proc2 = h.process("train1")
        out2: List[float] = []
        with h.on(proc2):
            h.spawn(proc2, lambda: loop(out2), "train")
        h.go()
        final = out2[0] if out2 else None
    else:
        final = out1[0] if out1 else None
    if final is None or final != expected:
        h.violation(
            "HVD605",
            f"crash+restore replay diverged: resumed run finished with "
            f"{final!r}, the uninterrupted run computes {expected!r} — "
            f"resume is not idempotent (snapshot step mislabeled, or "
            f"state saved at the wrong point)")


def _scenario_kv_brownout(h: Harness) -> None:
    """A store brownout (message-loss bursts) under the hvdfault retry
    layer: two controllers each commit a several-rank checkpoint (the
    2-host store barrier) and then run the preemption stop-step
    agreement, with ``distributed_kv()`` interposing the production
    ``RetryingKV`` over the simulated store and the loss budget free to
    drop any operation, the retries themselves included. Invariants: the
    retry layer must not break write-once stop-step agreement (HVD601) or
    commit atomicity (HVD602), no interleaving may deadlock (HVD603), and
    the fault domain must end every schedule CONSISTENT: a shed site only
    ever follows an exhausted optional budget, never a protocol-critical
    one."""
    from horovod_tpu_torch.resilience import faults

    # The fault domain and policy registry are PROCESS globals, and an
    # explored schedule can be interrupted anywhere (violation, sleep-
    # set prune, depth bound): the finally is what keeps a degraded
    # domain from one schedule leaking into the next run or into the
    # host process.
    try:
        _kv_brownout_body(h, faults)
    finally:
        faults.reset_for_tests()


def _kv_brownout_body(h: Harness, faults) -> None:
    # Fixed zero-backoff policies: deterministic across environments
    # (knob-derived defaults could differ per machine and change the
    # explored schedule space), and sleep(0) keeps each retry a single
    # yield point.
    faults.reset_for_tests()
    for site in ("preemption", "checkpoint_commit"):
        faults.register_policy(faults.RetryPolicy(
            site=site, deadline_s=60.0, base_backoff_s=0.0,
            max_backoff_s=0.0, max_attempts=2, jitter=0.0, critical=True))
    faults.register_policy(faults.RetryPolicy(
        site="straggler", deadline_s=60.0, base_backoff_s=0.0,
        max_backoff_s=0.0, max_attempts=1, jitter=0.0, critical=False))

    directory = os.path.join(h.tmpdir, "ckpt")
    ckpt_state: Dict[str, Any] = {}
    STEPS = 3
    stops: Dict[int, Optional[int]] = {}
    barrier = _StepBarrier(2)
    procs = [h.process(f"ctl{r}", pidx=r, nproc=2) for r in range(2)]

    def ctl(r):
        def loop():
            from horovod_tpu_torch.resilience.async_checkpoint import (
                AsyncCheckpointer, CheckpointCommitError,
            )
            from horovod_tpu_torch.resilience.preemption import (
                PreemptionHandler,
            )
            from horovod_tpu_torch.utils.kvstore import distributed_kv
            ckpt = AsyncCheckpointer(directory, interval=1, max_to_keep=2,
                                     fmt="pickle", commit_timeout=5)
            try:
                ckpt.maybe_save(1, {"w": float(1 + r)})
                ckpt.wait()
            except CheckpointCommitError:
                pass                       # abandoned uncommitted is legal
            ckpt.close()
            handler = PreemptionHandler(checkpointer=None, sentinel="",
                                        margin=1, install_signals=False)
            try:
                for step in range(STEPS):
                    if r == 0 and step == 0:
                        handler.request("maintenance notice")
                    if handler.check(step):
                        stops[r] = step
                        barrier.leave()
                        break
                    barrier.wait()
                else:
                    stops[r] = None
            finally:
                handler.close()
            # optional traffic during the brownout: a straggler-style
            # publish that may exhaust its 1-attempt budget and shed —
            # the DEGRADED transition under message loss
            kv = distributed_kv(site="straggler")
            try:
                kv.set(f"brownout/straggler/{r}", "x", overwrite=True)
            except Exception:
                pass                       # shed, not fatal
        return loop

    for r, p in enumerate(procs):
        with h.on(p):
            h.spawn(p, ctl(r), "train")
    h.go()
    _ckpt_monitor(h, directory, ckpt_state)
    agreed = {s for s in stops.values()}
    if len(stops) == 2 and len(agreed) > 1:
        h.violation(
            "HVD601",
            f"controllers quiesced at different steps ({stops}) with "
            f"retries interposed: the retry layer broke write-once "
            f"stop-step agreement")
    if stops and agreed == {None}:
        h.violation(
            "HVD601",
            f"a preemption notice was delivered but no controller "
            f"quiesced within {STEPS} steps under the brownout")
    dom = faults.fault_domain()
    shed = set(dom.shed_sites())
    if not shed <= {"straggler"}:
        h.violation(
            "HVD601",
            f"fault domain shed protocol-critical site(s) "
            f"{sorted(shed - {'straggler'})}: only optional traffic may "
            f"be shed in degraded mode")
    if shed and dom.state() != "degraded":
        h.violation(
            "HVD601",
            f"fault domain inconsistent: shed={sorted(shed)} but "
            f"state={dom.state()!r}")
def _scenario_resize(h: Harness) -> None:
    """Live-resize protocol (elastic/resize.py) under crash/loss
    interleavings, two phases over the REAL code:

    Phase A — quiesce agreement: two lockstep controllers run
    ``ResizeAgreement`` (the write-once store plan) through the production
    ``RetryingKV``; HVD601 — every controller that quiesces must adopt
    the SAME plan and stop at the SAME step.

    Phase B — plan-commit atomicity: a crashable leader + follower run
    ``commit_plan_after_snapshot`` (follower snapshots then acks;
    leader waits every ack, snapshots, THEN commits the plan via the
    atomic rename). HVD602 — at every scheduling point, a committed
    plan implies BOTH stop-step snapshots are durable: a crash anywhere
    in the window may leave unused snapshots, never a dangling plan.

    HVD603 — no interleaving (including lost retries and explorable
    timeouts) may deadlock."""
    from horovod_tpu_torch.resilience import faults
    try:
        _resize_scenario_body(h, faults)
    finally:
        faults.reset_for_tests()


def _resize_scenario_body(h: Harness, faults) -> None:
    # Fixed zero-backoff deterministic policy (kv_brownout rationale):
    # each retry is one yield point, identical on every machine.
    faults.reset_for_tests()
    faults.register_policy(faults.RetryPolicy(
        site="resize", deadline_s=60.0, base_backoff_s=0.0,
        max_backoff_s=0.0, max_attempts=3, jitter=0.0, critical=True))

    from horovod_tpu_torch.elastic.resize import (
        ResizeAgreement, ResizePlan, commit_plan_after_snapshot,
        load_plan,
    )

    # -- phase A: write-once quiesce agreement (lockstep controllers) --
    STEPS = 5
    stops: Dict[int, Optional[int]] = {}
    adopted: Dict[int, Any] = {}
    barrier = _StepBarrier(2)
    procs = [h.process(f"ctl{r}", pidx=r, nproc=2) for r in range(2)]

    def ctl(r):
        def loop():
            agree = ResizeAgreement(generation=0, margin=2, timeout=5)
            if r == 0:
                agree.propose({"kind": "host_loss", "host": 1})
            for step in range(STEPS):
                plan = agree.check(step)
                if plan is not None:
                    stops[r] = step
                    adopted[r] = plan
                    barrier.leave()
                    break
                barrier.wait()
            else:
                stops[r] = None
        return loop

    for r, p in enumerate(procs):
        with h.on(p):
            h.spawn(p, ctl(r), "train")
    h.go()

    quiesced = {r: s for r, s in stops.items() if s is not None}
    if len({(s, json.dumps(adopted[r], sort_keys=True))
            for r, s in quiesced.items()}) > 1:
        h.violation(
            "HVD601",
            f"controllers quiesced on different resize plans/steps "
            f"(stops={stops}, adopted={adopted}): the pre-resize "
            f"snapshots span different steps and the rebuilt worlds "
            f"disagree")
    if stops and not quiesced:
        h.violation(
            "HVD601",
            f"a resize notice was delivered but no controller quiesced "
            f"within {STEPS} steps (the published plan never landed)")

    # -- phase B: plan-commit atomicity under crashes ------------------
    d = os.path.join(h.tmpdir, "resize-ckpt")
    os.makedirs(d, exist_ok=True)
    stop_step = next(iter(quiesced.values()), 3)
    plan = ResizePlan(step=int(stop_step), old_world=4, new_world=2,
                      dead_ranks=(2, 3), old_dcn=2, new_dcn=1,
                      generation=1,
                      notice={"kind": "slice_loss", "slice": 1})

    def snap_path(pidx: int) -> str:
        return os.path.join(d, f"snap-{pidx}-step{plan.step}.json")

    def write_snapshot(pidx: int) -> None:
        part = snap_path(pidx) + ".part"
        with open(part, "w") as f:
            json.dump({"step": plan.step, "pidx": pidx}, f)
        schedhooks.rename(part, snap_path(pidx))

    def monitor() -> None:
        committed = load_plan(d, plan.step)
        if committed is None:
            return
        missing = [p for p in (0, 1)
                   if not os.path.exists(snap_path(p))]
        if missing:
            h.violation(
                "HVD602",
                f"resize plan for step {plan.step} is committed but "
                f"snapshot shard(s) {missing} are missing — a restore "
                f"into the new world would adopt a plan whose snapshot "
                f"does not exist")

    h.monitor = monitor
    pb = [h.process(f"host{r}", pidx=r, nproc=2, crashable=True)
          for r in range(2)]

    def leader():
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        write_snapshot(0)
        commit_plan_after_snapshot(
            d, plan, kv=distributed_kv(site="resize"), pidx=0, nproc=2,
            timeout=5)

    def follower():
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        write_snapshot(1)
        commit_plan_after_snapshot(
            d, plan, kv=distributed_kv(site="resize"), pidx=1, nproc=2,
            timeout=5)

    with h.on(pb[0]):
        h.spawn(pb[0], leader, "quiesce")
    with h.on(pb[1]):
        h.spawn(pb[1], follower, "quiesce")
    h.go()
    monitor()


def _scenario_fleet(h: Harness) -> None:
    """Replica-registry protocol of the serving fleet
    (serving/fleet.py over the REAL elastic/registry.MemberRegistry):
    join / drain / dead-replica reconcile / autoscale decision under
    full interleaving.

    Invariants: HVD602 — every membership edge reaches the registry's
    listeners and a dead/left replica is never published as a member;
    HVD604 — every submitted request completes exactly once (a drain
    or death never drops or duplicates admitted work); HVD605 — the
    dead replica's work re-admits in original submission order;
    HVD601 — two concurrent autoscale observers adopt ONE grow
    decision (the write-once store pattern); HVD603 — no interleaving
    deadlocks."""
    from horovod_tpu_torch.elastic.registry import MemberRegistry
    from horovod_tpu_torch.utils.kvstore import distributed_kv

    reg = MemberRegistry(clock=lambda: 0.0)
    notices: List[int] = []
    reg.register_listener(lambda ts, res: notices.append(res))

    cond = schedhooks.Condition()
    SUBMIT = ["q0", "q1", "q2", "q3"]
    states: Dict[int, str] = {}
    placed: Dict[int, List[str]] = {0: [], 1: []}
    completed: List[str] = []
    readmitted: List[str] = []
    flags = {"routed": False, "reconciled": False}

    proc = h.process("fleet0")

    def join(rid):
        def run():
            reg.join(f"replica-{rid}", 1)
            with cond:
                states[rid] = "ready"
                cond.notify_all()
        return run

    def router():
        # least-loaded placement over READY members, submission order
        for name in SUBMIT:
            with cond:
                while not any(s == "ready" for s in states.values()):
                    cond.wait()
                rid = min((r for r in sorted(states)
                           if states[r] == "ready"),
                          key=lambda r: (len(placed[r]), r))
                placed[rid].append(name)
                cond.notify_all()
        with cond:
            flags["routed"] = True
            cond.notify_all()

    def worker0_one(tr):
        # replica 0 completes exactly one item, then dies out from
        # under the rest of its queue
        def run():
            tr.join()
            with cond:
                if placed[0]:
                    completed.append(placed[0].pop(0))
                cond.notify_all()
        return run

    def reconciler(tw0):
        # the fleet's kill path: blacklist in the registry, then
        # re-admit the dead replica's remaining work on the survivor
        # IN ORDER (the drain-drop seeded twin breaks exactly this)
        def run():
            tw0.join()
            with cond:
                states[0] = "dead"
                orphans = list(placed[0])
                placed[0].clear()
            reg.dead("replica-0")
            with cond:
                for name in orphans:
                    readmitted.append(name)
                    placed[1].append(name)
                flags["reconciled"] = True
                cond.notify_all()
        return run

    def worker1():
        # survivor: completes its queue; exits once routing and the
        # reconcile are both done and nothing is left aboard
        while True:
            with cond:
                if placed[1]:
                    completed.append(placed[1].pop(0))
                    cond.notify_all()
                    continue
                if flags["routed"] and flags["reconciled"]:
                    states[1] = "draining"
                    break
                cond.wait()
        reg.leave("replica-1")
        with cond:
            states[1] = "left"
            cond.notify_all()

    with h.on(proc):
        tj0 = h.spawn(proc, join(0), "join0")
        tj1 = h.spawn(proc, join(1), "join1")
        tr = h.spawn(proc, router, "router")
        tw0 = h.spawn(proc, worker0_one(tr), "worker0")
        h.spawn(proc, reconciler(tw0), "reconcile")
        h.spawn(proc, worker1, "worker1")
    h.go()

    if sorted(completed) != SUBMIT or len(completed) != len(SUBMIT):
        h.violation(
            "HVD604",
            f"admitted request(s) lost or duplicated across the "
            f"drain/death: submitted {SUBMIT}, completed {completed} — "
            f"a client is waiting on a response that never comes")
    order = {n: i for i, n in enumerate(SUBMIT)}
    if readmitted != sorted(readmitted, key=lambda n: order[n]):
        h.violation(
            "HVD605",
            f"re-admission order {readmitted} diverged from submission "
            f"order: two recoveries of the same death would serve "
            f"different trajectories")
    members = reg.members()
    if "replica-0" in members or not reg.is_blacklisted("replica-0"):
        h.violation(
            "HVD602",
            f"dead replica still published by the registry "
            f"(members={members}): the router would keep dispatching "
            f"to a corpse")
    if len(notices) < 4:
        h.violation(
            "HVD602",
            f"membership edge(s) lost: {len(notices)} listener "
            f"notifications for 4 membership changes — a subscriber's "
            f"view of the fleet has silently diverged")

    # -- autoscale decision: write-once agreement ----------------------
    decisions: Dict[int, Any] = {}
    obs = [h.process(f"scaler{r}", pidx=r, nproc=2) for r in range(2)]

    def observer(r):
        def run():
            # the fleet's scale decision is a (serving-)world resize:
            # same write-once agreement machinery, same critical site
            kv = distributed_kv(site="resize")
            try:
                kv.set("fleet/scale/cycle0", f"grow:{2 + r}",
                       overwrite=False)
            except Exception:
                pass               # a peer won the write-once race
            decisions[r] = kv.get("fleet/scale/cycle0", timeout_s=5)
        return run

    for r, p in enumerate(obs):
        with h.on(p):
            h.spawn(p, observer(r), "scale")
    h.go()
    if len(set(decisions.values())) > 1:
        h.violation(
            "HVD601",
            f"autoscale observers adopted different decisions "
            f"{decisions}: the fleet would grow twice for one "
            f"pressure signal")




def builtin_scenarios() -> Dict[str, Scenario]:
    """The shipped scenarios over the port's real protocol code. All of
    them must explore with ZERO findings; the tests assert it."""
    return {
        "coordinator": Scenario(
            "coordinator", _scenario_coordinator, codes=("HVD603", "HVD604")),
        "checkpoint": Scenario(
            "checkpoint", _scenario_checkpoint, max_crashes=1,
            codes=("HVD602", "HVD603")),
        "checkpoint_multihost": Scenario(
            "checkpoint_multihost", _scenario_checkpoint_multihost,
            max_crashes=1, codes=("HVD602", "HVD603")),
        "preemption": Scenario(
            "preemption", _scenario_preemption,
            knobs={"HOROVOD_PREEMPTION_POLL_SECONDS": 0.0},
            codes=("HVD601", "HVD603")),
        "elastic": Scenario(
            "elastic", _scenario_elastic, codes=("HVD601", "HVD603")),
        "resume": Scenario(
            "resume", _scenario_resume, max_crashes=1,
            codes=("HVD602", "HVD603", "HVD605")),
        "kv_brownout": Scenario(
            "kv_brownout", _scenario_kv_brownout, max_losses=2,
            knobs={"HOROVOD_PREEMPTION_POLL_SECONDS": 0.0},
            codes=("HVD601", "HVD602", "HVD603")),
        "resize": Scenario(
            "resize", _scenario_resize, max_crashes=1, max_losses=1,
            knobs={"HOROVOD_PREEMPTION_POLL_SECONDS": 0.0},
            codes=("HVD601", "HVD602", "HVD603")),
        "fleet": Scenario(
            "fleet", _scenario_fleet,
            codes=("HVD601", "HVD602", "HVD603", "HVD604", "HVD605")),
    }


# ---------------------------------------------------------------------------
# spec resolution + top-level driver (the hvdmodel-torch / --model surface)
# ---------------------------------------------------------------------------

def resolve_scenarios(spec: str) -> List[Tuple[str, Scenario]]:
    """'all', a builtin name, or 'path.py:callable' / 'module:callable'
    where the callable returns a Scenario or a list of Scenarios.
    Returns [(spec_string, scenario)] — the spec string is what a trace
    file records so ``--replay`` can re-resolve it."""
    builtins = builtin_scenarios()
    if spec == "all":
        return [(name, sc) for name, sc in builtins.items()]
    if spec in builtins:
        return [(spec, builtins[spec])]
    modpart, sep, attr = spec.partition(":")
    if not sep or not attr:
        raise ValueError(
            f"--model target {spec!r} is neither a builtin scenario "
            f"({', '.join(sorted(builtins))}, all) nor a "
            f"'path.py:callable' spec")
    if modpart.endswith(".py"):
        modname = "_hvd_model_target_" + hashlib.sha1(
            modpart.encode()).hexdigest()[:8]
        loader_spec = importlib.util.spec_from_file_location(modname, modpart)
        if loader_spec is None or loader_spec.loader is None:
            raise ValueError(f"--model target file {modpart!r} not "
                             f"importable")
        mod = importlib.util.module_from_spec(loader_spec)
        loader_spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(modpart)
    obj = getattr(mod, attr)
    value = obj() if callable(obj) and not isinstance(obj, Scenario) else obj
    out = []
    for v in (value if isinstance(value, (list, tuple)) else [value]):
        if not isinstance(v, Scenario):
            raise ValueError(
                f"--model target {spec} resolved to {type(v).__name__}; "
                f"expected Scenario (or a list of them)")
        out.append((f"{spec}" if not isinstance(value, (list, tuple))
                    else f"{spec}[{v.name}]", v))
    return out


def trace_filename(scenario_name: str, code: str) -> str:
    """Deterministic counterexample trace filename — the single source
    for both the file run_model() writes and the replay command the
    HVD6xx finding message advertises (fingerprints stay stable and
    machine-independent)."""
    return f"{scenario_name}-{code}.json"


def run_model(specs: Sequence[str], budget_s: Optional[float] = None,
              seed: Optional[int] = None,
              trace_dir: Optional[str] = None
              ) -> Tuple[List[ExploreResult], Dict[str, str]]:
    """Explore every scenario named by ``specs``, splitting the budget
    evenly. Returns the per-scenario results and, when ``trace_dir`` is
    given, a {finding-id: trace-path} map of written counterexamples
    (deterministic names — fingerprints stay baseline-stable)."""
    from horovod_tpu_torch.config import knobs
    if budget_s is None:
        budget_s = float(knobs.get("HOROVOD_MODEL_BUDGET_SECONDS"))
    if seed is None:
        seed = int(knobs.get("HOROVOD_MODEL_SEED"))
    targets: List[Tuple[str, Scenario]] = []
    for spec in specs:
        targets.extend(resolve_scenarios(spec))
    per = budget_s / max(len(targets), 1)
    results: List[ExploreResult] = []
    traces: Dict[str, str] = {}
    for spec, sc in targets:
        res = explore(sc, budget_s=per, seed=seed)
        results.append(res)
        if trace_dir and res.findings:
            os.makedirs(trace_dir, exist_ok=True)
            for f in res.findings:
                path = os.path.join(trace_dir,
                                    trace_filename(sc.name, f.code))
                with open(path, "w") as fh:
                    fh.write(trace_to_json(spec, f))
                traces[f"{sc.name}:{f.code}"] = path
    return results, traces


def replay_file(path: str, max_steps: int = 3000) -> _RunOutcome:
    """Re-run a counterexample trace file; the outcome carries the
    reproduced Violation (or None when the trace no longer violates —
    i.e. the bug is fixed)."""
    with open(path, encoding="utf-8") as f:
        spec, trace = trace_from_json(f.read())
    resolved = resolve_scenarios(spec.split("[", 1)[0])
    scenario = resolved[0][1] if len(resolved) == 1 else next(
        sc for s, sc in resolved if spec.endswith(f"[{sc.name}]"))
    return replay(scenario, trace, max_steps=max_steps)
