"""HVD3xx — concurrency.

The runtime is a small thread zoo (coordinator cycle loop, stall
inspector, metrics dumper/publisher/HTTP, timeline writer, checkpoint
worker, preemption watcher, elastic discovery, the autograd engine's
threads running gradient hooks) synchronized by ``threading.Lock``
sites. These rules build a static model per module — lock attributes,
acquisition nesting, thread entry points, signal handlers — and flag
the shapes that produced real bugs in the JAX package:

- HVD301: lock-order inversion (A taken under B in one path, B under A
  in another — including one level of same-class method calls).
- HVD302: unbounded blocking call (join/wait/result without timeout,
  time.sleep, subprocess, blocking KV get) while holding a lock.
- HVD303: attribute written both from a thread target and from
  non-thread methods with at least one write outside any lock.
- HVD304: signal handler doing more than flag-sets — the
  async-signal-safety invariant (a handler that takes the metrics lock
  deadlocks when the signal lands while the main thread holds it).
- HVD305: unbounded blocking KV get — a ``kv.get(...)`` (or the JAX
  client's ``blocking_key_value_get``) whose timeout is absent or a
  literal ≥ 300 s, a c10d store ``wait(keys)`` without a timeout or with
  one ≥ 300 s, or a c10d store ``get(key)`` (which blocks for the
  store's whole timeout until the key exists) that no bounded ``wait``
  or ``check`` of the same store precedes in its function; all outside
  the registered retry layer (``resilience.faults.RetryingKV`` /
  ``retry_call`` / ``retry_fs``). A store call that can wait five
  minutes pins whatever thread issued it through an entire brownout;
  the fault-policy registry exists so every such wait is bounded and
  budgeted per call site.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from horovod_tpu_torch.analysis.engine import (
    Rule, SourceFile, dotted_name, enclosing_symbol, is_store_receiver,
    last_segment,
)

LOCK_CTORS = {"Lock", "RLock"}
CONDITION_CTORS = {"Condition"}
EVENT_CTORS = {"Event"}
THREADY_CTORS = (LOCK_CTORS | CONDITION_CTORS | EVENT_CTORS
                 | {"Semaphore", "BoundedSemaphore", "Barrier", "Queue",
                    "LifoQueue", "PriorityQueue", "SimpleQueue", "deque",
                    "Thread", "Timer"})

# Calls that block unboundedly when called without a timeout.
BLOCKING_NO_TIMEOUT = {"join", "wait", "result", "acquire", "get"}
BLOCKING_ALWAYS = {
    "time.sleep", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
    "socket.create_connection", "blocking_key_value_get",
}
# Allowed calls inside a signal handler (flag-set discipline): restoring
# the previous disposition, dict lookups for it, and async-signal-safe
# os.write.
SIGNAL_SAFE_CALLS = {"signal", "getsignal", "Signals", "write", "get"}


def _lock_ref(node: ast.AST) -> Optional[str]:
    """'self.X' / bare module-global name for a lock-looking expr."""
    d = dotted_name(node)
    if d is None:
        return None
    return d


class _ClassModel:
    """Locks, methods, thread targets, and per-method acquisition info
    for one class (or the module's top level, name='<module>')."""

    def __init__(self, name: str):
        self.name = name
        self.locks: Dict[str, str] = {}        # ref -> kind (lock/condition)
        self.events: Set[str] = set()
        self.methods: Dict[str, ast.AST] = {}
        self.thread_targets: Set[str] = set()


def _receiver_of(ref: str) -> str:
    return ref.rsplit(".", 1)[0] if "." in ref else ""


def build_models(sf: SourceFile) -> List[_ClassModel]:
    """Memoized per SourceFile: all four HVD3xx rules share one model
    build instead of re-walking the module."""
    cached = getattr(sf, "_hvd_class_models", None)
    if cached is not None:
        return cached
    models = _build_models_uncached(sf)
    sf._hvd_class_models = models
    return models


def _build_models_uncached(sf: SourceFile) -> List[_ClassModel]:
    models: List[_ClassModel] = []
    mod = _ClassModel("<module>")
    for stmt in sf.tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            ctor = last_segment(dotted_name(stmt.value.func))
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    if ctor in LOCK_CTORS:
                        mod.locks[tgt.id] = "lock"
                    elif ctor in CONDITION_CTORS:
                        mod.locks[tgt.id] = "condition"
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.methods[stmt.name] = stmt
    models.append(mod)

    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        cm = _ClassModel(node.name)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and \
                    isinstance(sub.value, ast.Call):
                ctor = last_segment(dotted_name(sub.value.func))
                for tgt in sub.targets:
                    ref = dotted_name(tgt)
                    if ref and ref.startswith("self."):
                        if ctor in LOCK_CTORS:
                            cm.locks[ref] = "lock"
                        elif ctor in CONDITION_CTORS:
                            cm.locks[ref] = "condition"
                        elif ctor in EVENT_CTORS:
                            cm.events.add(ref)
            if isinstance(sub, ast.Call):
                ctor = last_segment(dotted_name(sub.func))
                if ctor in ("Thread", "Timer"):
                    for kw in sub.keywords:
                        if kw.arg == "target":
                            t = dotted_name(kw.value)
                            if t and t.startswith("self."):
                                cm.thread_targets.add(t[len("self."):])
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cm.methods[stmt.name] = stmt
        models.append(cm)
    return models


def _held_walk(func: ast.AST, lock_refs: Set[str]):
    """Yield (node, held_stack) for every node in `func`, where
    held_stack is the list of lock refs whose `with` blocks enclose it.
    Nested function defs are NOT descended into (different thread
    context is possible, but lock state does carry — keep it simple and
    lexical: they are included, since closures run with whatever the
    caller holds only if called there; lexical inclusion matches the
    common `def worker(): ... with lock` pattern well enough)."""

    def visit(node: ast.AST, held: Tuple[str, ...]):
        yield node, held
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in node.items:
                ref = _lock_ref(item.context_expr)
                if ref in lock_refs:
                    acquired.append(ref)
            new_held = held + tuple(acquired)
            for item in node.items:
                yield from visit(item.context_expr, held)
            for child in node.body:
                yield from visit(child, new_held)
            return
        for child in ast.iter_child_nodes(node):
            yield from visit(child, held)

    for child in ast.iter_child_nodes(func):
        yield from visit(child, ())


class LockOrderInversion(Rule):
    code = "HVD301"
    severity = "error"
    summary = "lock-order inversion (static acquisition-graph cycle)"

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        for cm in build_models(sf):
            if len(cm.locks) < 2 and not cm.methods:
                continue
            lock_refs = set(cm.locks)
            # per-method: direct edges (A held when B acquired) and
            # the sets (locks acquired anywhere, self-methods called
            # while holding each lock)
            edges: Dict[Tuple[str, str], ast.AST] = {}
            acquires: Dict[str, Set[str]] = {}
            calls_under: List[Tuple[str, str, ast.AST]] = []
            for mname, func in cm.methods.items():
                acq: Set[str] = set()
                for node, held in _held_walk(func, lock_refs):
                    if isinstance(node, (ast.With, ast.AsyncWith)):
                        for item in node.items:
                            ref = _lock_ref(item.context_expr)
                            if ref in lock_refs:
                                acq.add(ref)
                                for h in held:
                                    if h != ref:
                                        edges.setdefault((h, ref), node)
                    if isinstance(node, ast.Call) and held:
                        callee = dotted_name(node.func)
                        if callee and callee.startswith("self."):
                            m = callee[len("self."):]
                            if m in cm.methods:
                                for h in held:
                                    calls_under.append((h, m, node))
                acquires[mname] = acq
            # close over one level of self-method calls: holding A and
            # calling m() that acquires B => edge A->B
            changed = True
            while changed:
                changed = False
                for h, m, site in calls_under:
                    for b in acquires.get(m, ()):
                        if b != h and (h, b) not in edges:
                            edges[(h, b)] = site
                            changed = True
                # propagate transitive acquisition through calls so
                # chains of helpers are covered
                for mname, func in cm.methods.items():
                    for node in ast.walk(func):
                        if isinstance(node, ast.Call):
                            callee = dotted_name(node.func)
                            if callee and callee.startswith("self."):
                                m = callee[len("self."):]
                                extra = acquires.get(m, set()) - \
                                    acquires.get(mname, set())
                                if extra:
                                    acquires[mname] |= extra
                                    changed = True
            reported: Set[frozenset] = set()
            for (a, b) in edges:
                if (b, a) in edges:
                    pair = frozenset((a, b))
                    if pair in reported:
                        continue
                    reported.add(pair)
                    site = edges[(a, b)]
                    where = f"{cm.name}." if cm.name != "<module>" else ""
                    yield self.finding(
                        sf, site,
                        f"lock-order inversion in "
                        f"{where.rstrip('.') or 'module'}: "
                        f"{b!r} is acquired while holding {a!r} here, but "
                        f"another path acquires {a!r} while holding {b!r} "
                        f"— two threads taking the two paths deadlock; "
                        f"pick one order",
                        enclosing_symbol(site))


class BlockingUnderLock(Rule):
    code = "HVD302"
    severity = "warning"
    summary = "unbounded blocking call while holding a lock"

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        for cm in build_models(sf):
            lock_refs = set(cm.locks)
            if not lock_refs:
                continue
            for mname, func in cm.methods.items():
                for node, held in _held_walk(func, lock_refs):
                    if not held or not isinstance(node, ast.Call):
                        continue
                    msg = self._blocking(node, held, cm)
                    if msg:
                        yield self.finding(
                            sf, node,
                            f"{msg} while holding {held[-1]!r}: every "
                            f"other thread contending for the lock stalls "
                            f"behind this wait (and a cyclic wait "
                            f"deadlocks) — release the lock first or "
                            f"bound the wait with a timeout",
                            enclosing_symbol(node))

    def _blocking(self, call: ast.Call, held, cm) -> Optional[str]:
        dotted = dotted_name(call.func)
        seg = last_segment(dotted)
        if dotted in BLOCKING_ALWAYS or seg in ("blocking_key_value_get",
                                                "communicate"):
            return f"blocking call {dotted!r}"
        if seg not in BLOCKING_NO_TIMEOUT:
            return None
        has_timeout = bool(call.args) or any(
            kw.arg in ("timeout", "timeout_s", "timeout_ms", "block")
            for kw in call.keywords)
        if has_timeout:
            return None
        if seg == "get":
            # only queue-ish/kv-ish receivers: '.get()' is ubiquitous
            recv = _receiver_of(dotted or "")
            if not any(tok in recv.lower()
                       for tok in ("queue", "_q", "kv", "future")):
                return None
        if seg == "wait":
            recv = _receiver_of(dotted or "")
            # Condition.wait inside `with cond:` is the intended
            # pattern; Event.wait without timeout still blocks forever.
            if cm.locks.get(recv) == "condition" and recv in held:
                return None
        return f"unbounded '.{seg}()'"


class UnlockedSharedWrite(Rule):
    code = "HVD303"
    severity = "warning"
    summary = ("attribute written from both a thread target and public "
               "methods without consistent locking")

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        for cm in build_models(sf):
            if not cm.thread_targets:
                continue
            lock_refs = set(cm.locks)
            thread_methods = self._reachable(cm, cm.thread_targets)
            # attr -> [(method, under_lock, node)]
            writes: Dict[str, List[Tuple[str, bool, ast.AST]]] = {}
            for mname, func in cm.methods.items():
                if mname == "__init__":
                    continue     # happens-before thread start
                if mname.endswith("_locked"):
                    continue     # convention: caller holds the lock
                for node, held in _held_walk(func, lock_refs):
                    if isinstance(node, (ast.Assign, ast.AugAssign)):
                        tgts = node.targets if isinstance(node, ast.Assign) \
                            else [node.target]
                        for tgt in tgts:
                            ref = dotted_name(tgt)
                            if not ref or not ref.startswith("self."):
                                continue
                            if ref in lock_refs or ref in cm.events:
                                continue
                            writes.setdefault(ref, []).append(
                                (mname, bool(held), node))
            for ref, sites in writes.items():
                t_sites = [s for s in sites if s[0] in thread_methods]
                m_sites = [s for s in sites if s[0] not in thread_methods]
                if not t_sites or not m_sites:
                    continue
                unlocked = [s for s in t_sites + m_sites if not s[1]]
                if not unlocked:
                    continue
                mname, _, node = unlocked[0]
                yield self.finding(
                    sf, node,
                    f"{ref!r} is written from thread context "
                    f"({sorted({s[0] for s in t_sites})}) and from "
                    f"{sorted({s[0] for s in m_sites})}, but this write "
                    f"in {mname!r} holds no lock — concurrent writes "
                    f"race; guard every write with the owning lock (or "
                    f"make the field an Event/Queue)",
                    f"{cm.name}.{mname}")

    def _reachable(self, cm: _ClassModel, roots: Set[str]) -> Set[str]:
        out = set(roots)
        frontier = list(roots)
        while frontier:
            m = frontier.pop()
            func = cm.methods.get(m)
            if func is None:
                continue
            for node in ast.walk(func):
                if isinstance(node, ast.Call):
                    callee = dotted_name(node.func)
                    if callee and callee.startswith("self."):
                        name = callee[len("self."):]
                        if name in cm.methods and name not in out:
                            out.add(name)
                            frontier.append(name)
        return out


class FatSignalHandler(Rule):
    code = "HVD304"
    severity = "error"
    summary = ("signal handler does more than set flags "
               "(async-signal-safety)")

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        handlers = self._handlers(sf)
        for func in handlers:
            for node in ast.walk(func):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    yield self.finding(
                        sf, node,
                        "signal handler acquires a lock/context: if the "
                        "signal lands while the interrupted thread holds "
                        "it, the handler deadlocks the process — set a "
                        "flag here and promote it from normal context "
                        "(resilience/preemption.py pattern)",
                        enclosing_symbol(node) or getattr(
                            func, "name", "<handler>"))
                elif isinstance(node, ast.Call):
                    dotted = dotted_name(node.func) or ""
                    seg = last_segment(dotted)
                    if seg in SIGNAL_SAFE_CALLS:
                        continue
                    yield self.finding(
                        sf, node,
                        f"signal handler calls {dotted or seg!r}: "
                        f"handlers must only set flags (plain attribute "
                        f"stores) — logging/locking/metrics from a "
                        f"handler frame deadlocks when the signal "
                        f"interrupts a holder of the same lock; promote "
                        f"the flag from normal context instead",
                        enclosing_symbol(node) or getattr(
                            func, "name", "<handler>"))

    def _handlers(self, sf: SourceFile) -> List[ast.AST]:
        """Functions registered via signal.signal(sig, handler)."""
        by_name: Dict[str, List[ast.AST]] = {}
        by_attr: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, []).append(node)
                by_attr.setdefault(node.name, []).append(node)
        out: List[ast.AST] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if last_segment(dotted_name(node.func)) != "signal":
                continue
            d = dotted_name(node.func)
            if d is not None and not (d == "signal"
                                      or d.endswith(".signal")):
                continue
            if len(node.args) < 2:
                continue
            target = node.args[1]
            if isinstance(target, ast.Lambda):
                out.append(target)
            elif isinstance(target, ast.Name):
                out.extend(by_name.get(target.id, []))
            elif isinstance(target, ast.Attribute):
                out.extend(by_attr.get(target.attr, []))
        # de-dup, preserve order
        seen: Set[int] = set()
        uniq = []
        for f in out:
            if id(f) not in seen:
                seen.add(id(f))
                uniq.append(f)
        return uniq


class UnboundedKVGet(Rule):
    code = "HVD305"
    severity = "warning"
    summary = ("unbounded blocking KV get (timeout absent or literal "
               ">= 300s) outside the registered retry layer")

    # Seconds a single blocking KV wait may pin its thread before the
    # rule calls it unbounded (the hvdfault policy registry is where
    # longer budgets belong — deadline + backoff, not one giant wait).
    MAX_LITERAL_S = 300

    # The retry layer itself is exempt: RetryingKV's per-attempt calls
    # and the retry_call/retry_fs drivers are where bounded waits are
    # composed into budgeted ones.
    EXEMPT_CLASSES = {"RetryingKV"}
    EXEMPT_FUNCS = {"retry_call", "retry_fs"}

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        exempt_spans = self._exempt_spans(sf)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if any(a <= node.lineno <= b for a, b in exempt_spans):
                continue
            msg = self._unbounded(node) or self._unbounded_store(node)
            if msg:
                yield self.finding(sf, node, msg, enclosing_symbol(node))

    def _exempt_spans(self, sf: SourceFile):
        spans = []
        for node in ast.walk(sf.tree):
            if (isinstance(node, ast.ClassDef)
                    and node.name in self.EXEMPT_CLASSES) or \
               (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in self.EXEMPT_FUNCS):
                spans.append((node.lineno,
                              getattr(node, "end_lineno", node.lineno)))
        return spans

    @staticmethod
    def _timeout_expr(call: ast.Call, kw_names) -> Tuple[bool,
                                                         Optional[ast.AST]]:
        """(present, expr) for the call's timeout argument: the second
        positional, or any of ``kw_names``."""
        for kw in call.keywords:
            if kw.arg in kw_names:
                return True, kw.value
        if len(call.args) >= 2:
            return True, call.args[1]
        return False, None

    def _unbounded(self, call: ast.Call) -> Optional[str]:
        dotted = dotted_name(call.func)
        seg = last_segment(dotted)
        if seg == "blocking_key_value_get":
            present, expr = self._timeout_expr(
                call, ("timeout_ms", "timeout"))
            limit_ms = self.MAX_LITERAL_S * 1000
            if not present:
                return ("'blocking_key_value_get' without a timeout "
                        "waits forever on a browned-out coordination "
                        "service — bound it and route the call through "
                        "a registered RetryPolicy "
                        "(resilience.faults, docs/analysis.md HVD305)")
            if isinstance(expr, ast.Constant) and \
                    isinstance(expr.value, (int, float)) and \
                    expr.value >= limit_ms:
                return (f"'blocking_key_value_get' with a "
                        f"{expr.value / 1000:.0f}s literal timeout pins "
                        f"its thread through an entire brownout — use a "
                        f"registered RetryPolicy (deadline + backoff) "
                        f"instead of one giant wait")
            return None
        if seg != "get" or not isinstance(call.func, ast.Attribute):
            return None
        recv = _receiver_of(dotted or "")
        last = recv.rsplit(".", 1)[-1] if recv else ""
        if not (last == "kv" or last == "_kv" or last.endswith("_kv")):
            return None
        present, expr = self._timeout_expr(call, ("timeout_s", "timeout"))
        if not present:
            return (f"KV get on {recv!r} without a timeout blocks "
                    f"forever on a browned-out coordination service — "
                    f"pass timeout_s and route the call through a "
                    f"registered RetryPolicy (resilience.faults, "
                    f"docs/analysis.md HVD305)")
        if isinstance(expr, ast.Constant) and \
                isinstance(expr.value, (int, float)) and \
                expr.value >= self.MAX_LITERAL_S:
            return (f"KV get on {recv!r} with a {expr.value:.0f}s "
                    f"literal timeout pins its thread through an entire "
                    f"brownout — use a registered RetryPolicy (deadline "
                    f"+ backoff) instead of one giant wait")
        return None


    @staticmethod
    def _seconds(expr: ast.AST) -> Optional[float]:
        """A literal timeout in seconds: a number, or
        ``timedelta(seconds=N)`` / ``timedelta(minutes=N)`` literals."""
        if isinstance(expr, ast.Constant) and \
                isinstance(expr.value, (int, float)):
            return float(expr.value)
        if isinstance(expr, ast.Call) and \
                last_segment(dotted_name(expr.func)) == "timedelta":
            scale = {"seconds": 1.0, "minutes": 60.0, "hours": 3600.0}
            total = 0.0
            for kw in expr.keywords:
                if kw.arg not in scale or not (
                        isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, (int, float))):
                    return None
                total += scale[kw.arg] * kw.value.value
            if expr.args:
                return None
            return total
        return None

    def _unbounded_store(self, call: ast.Call) -> Optional[str]:
        """A c10d store's ``wait(keys[, timeout])`` or ``get(key)``."""
        dotted = dotted_name(call.func)
        seg = last_segment(dotted)
        recv = _receiver_of(dotted or "")
        if seg not in ("wait", "get") or not is_store_receiver(recv):
            return None
        if seg == "wait":
            present, expr = self._timeout_expr(call, ("timeout",))
            if not present:
                return (f"c10d store wait on {recv!r} without a timeout "
                        f"blocks for the store's whole timeout on a "
                        f"browned-out store — pass a bounded timedelta "
                        f"and route the call through a registered "
                        f"RetryPolicy (resilience.faults, HVD305)")
            seconds = self._seconds(expr)
            if seconds is not None and seconds >= self.MAX_LITERAL_S:
                return (f"c10d store wait on {recv!r} with a "
                        f"{seconds:.0f}s literal timeout pins its thread "
                        f"through an entire brownout — use a registered "
                        f"RetryPolicy (deadline + backoff) instead of "
                        f"one giant wait")
            return None
        if self._guarded_get(call, recv):
            return None
        return (f"c10d store get on {recv!r} blocks until the key exists, "
                f"for the store's whole timeout — wait for the key with a "
                f"bounded timeout (or check it) first, or go through "
                f"utils.kvstore's DistributedKV.get")

    @staticmethod
    def _guarded_get(call: ast.Call, recv: str) -> bool:
        """A bounded ``wait`` or a ``check`` of the same store earlier in
        the enclosing function (lambdas included)."""
        func = getattr(call, "_hvd_parent", None)
        while func is not None and not isinstance(
                func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = getattr(func, "_hvd_parent", None)
        if func is None:
            return False
        for node in ast.walk(func):
            if not isinstance(node, ast.Call) or node.lineno > call.lineno:
                continue
            d = dotted_name(node.func)
            if _receiver_of(d or "") != recv:
                continue
            seg = last_segment(d)
            if seg == "check" or (seg == "wait" and (
                    len(node.args) >= 2 or any(
                        kw.arg == "timeout" for kw in node.keywords))):
                return True
        return False


RULES = [LockOrderInversion(), BlockingUnderLock(), UnlockedSharedWrite(),
         FatSignalHandler(), UnboundedKVGet()]
