"""HVD1xx — SPMD consistency.

Every rank of a torch.distributed world must issue the *same* collective
sequence, on every process group, in the same order: a collective (or a
c10d store wait) reached by some ranks and not others is renegotiated by
nobody, and the ranks that did enter it block until NCCL's or the store's
timeout. These rules flag the static shapes that produce divergent
programs:

- HVD101: collective issued under rank-dependent control flow.
- HVD102: rank-dependent early exit (return/raise/break/continue)
  upstream of a collective in the same function.
- HVD103: collective issued while iterating an unordered container
  (set/frozenset, unsorted os.listdir/glob) — per-process iteration
  order feeds per-process collective order.
- HVD105: collective inside an ``except`` handler, or downstream of a
  rank-dependent ``try``/``except`` that swallows — exceptions are the
  rank-divergent control flow HVD101-103 cannot see (only the raising
  rank runs the handler / skips the tail of the try body).
- HVD106: an ``except`` handler that swallows CheckpointMismatchError
  (or bare-excepts a restore/handoff call) and continues — the
  handoff-compatibility failure the HVD8xx tier certifies against,
  made invisible at runtime (the run silently restarts from scratch or
  serves the wrong weights).

A collective is a Horovod API call (``htt.allreduce`` ...), one of the
port's ``ops/collectives.py`` entry points, a ``torch.distributed``
collective or point-to-point call (through any name the file binds
``torch.distributed`` to), a ``lax`` primitive (so the JAX package's
shapes still fire), or ``wait`` on a c10d store. ``torch.<op>`` tensor
functions are not collectives, ``torch.distributed.<op>`` ones are.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from horovod_tpu_torch.analysis.engine import (
    Finding, Rule, SourceFile, call_name, dotted_name, enclosing_symbol,
    is_store_receiver, iter_functions, last_segment,
)

# Framework-level collective entry points (last dotted segment): the
# Horovod API and the port's ops/collectives.py.
COLLECTIVE_CALLS: Set[str] = {
    "allreduce", "grouped_allreduce", "adasum_allreduce", "allgather",
    "broadcast", "alltoall", "barrier", "reducescatter",
    "broadcast_parameters", "broadcast_object", "broadcast_optimizer_state",
    "broadcast_variables", "allgather_object",
    "allreduce_", "allreduce_start", "allreduce_async",
    "grouped_allreduce_start", "grouped_allreduce_async",
    "allgather_start", "allgather_async", "broadcast_", "broadcast_start",
    "broadcast_async", "alltoall_start", "alltoall_async",
    "reducescatter_start", "reducescatter_async", "ppermute_start",
    "wire_sum_async", "hierarchical_allreduce", "two_level_allreduce",
    "sparse_allreduce",
}
# torch.distributed's collectives, point-to-point calls and group
# creation (each rank must create the same groups in the same order);
# matched only behind a name bound to torch.distributed.
TORCH_DIST_CALLS: Set[str] = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "broadcast", "broadcast_object_list", "barrier",
    "monitored_barrier", "reduce", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "gather", "gather_object", "scatter",
    "scatter_object_list", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "new_group",
}
# A c10d store's blocking wait for keys other ranks set.
STORE_WAITS: Set[str] = {"wait"}
# jax.lax SPMD primitives (matched with or without the lax. prefix), and
# the port's per-axis differentiable collectives of the same names.
LAX_COLLECTIVES: Set[str] = {
    "psum", "pmean", "pmax", "pmin", "ppermute", "pshuffle",
    "all_gather", "all_to_all", "psum_scatter",
}
# Receiver prefixes that make an ambiguous name (broadcast, ...) NOT a
# collective: numpy/torch broadcasting, queue APIs. torch.distributed is
# told apart first (is_collective_call).
_NON_COLLECTIVE_PREFIXES = {"np", "numpy", "jnp", "torch", "math", "queue"}

# Calls whose int result differs per process — the taint sources.
RANK_SOURCES: Set[str] = {
    "rank", "local_rank", "cross_rank", "node_rank", "process_index",
    "process_id", "gethostname", "getpid", "get_rank", "axis_rank",
}


def _dist_names(sf: Optional[SourceFile]) -> Tuple[Set[str], Set[str]]:
    """(prefixes, bare names) through which ``sf`` reaches
    torch.distributed: ``torch.distributed`` itself, every alias of the
    module (``import torch.distributed as dist``, ``from torch import
    distributed``), and the collectives imported by name (``from
    torch.distributed import all_reduce``). Memoized on the file."""
    if sf is None or sf.tree is None:
        return {"torch.distributed"}, set()
    cached = getattr(sf, "_hvd_dist_names", None)
    if cached is not None:
        return cached
    prefixes, bare = {"torch.distributed"}, set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    prefixes.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                prefixes.update(a.asname or a.name for a in node.names
                                if a.name == "distributed")
            elif node.module == "torch.distributed":
                bare.update(a.asname or a.name for a in node.names
                            if a.name in TORCH_DIST_CALLS)
    sf._hvd_dist_names = (prefixes, bare)
    return prefixes, bare


def is_collective_call(call: ast.Call,
                       sf: Optional[SourceFile] = None) -> Optional[str]:
    name = call_name(call)
    if name is None:
        return None
    seg = last_segment(name)
    receiver = name.rsplit(".", 1)[0] if "." in name else ""
    prefixes, bare = _dist_names(sf)
    if seg in TORCH_DIST_CALLS and (receiver in prefixes or (
            not receiver and name in bare)):
        return name
    if seg in STORE_WAITS and is_store_receiver(receiver):
        return name
    prefix = name.split(".", 1)[0] if "." in name else ""
    if prefix in _NON_COLLECTIVE_PREFIXES:
        return None
    if seg in COLLECTIVE_CALLS:
        return name
    if seg in LAX_COLLECTIVES:
        return name
    return None


def _contains_rank_source(node: ast.AST, tainted: Set[str]) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            if last_segment(call_name(sub)) in RANK_SOURCES:
                return True
        elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
            if sub.id in tainted:
                return True
    return False


def _tainted_names(func: ast.AST) -> Set[str]:
    """Names assigned (anywhere in this scope) from a rank-source call.
    One forward pass + one fixpoint round over simple aliases."""
    tainted: Set[str] = set()
    own_defs = {n for n in ast.walk(func)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)) and n is not func}

    def in_nested(node: ast.AST) -> bool:
        cur = getattr(node, "_hvd_parent", None)
        while cur is not None and cur is not func:
            if cur in own_defs:
                return True
            cur = getattr(cur, "_hvd_parent", None)
        return False

    for _ in range(2):
        for node in ast.walk(func):
            if not isinstance(node, ast.Assign) or in_nested(node):
                continue
            if _contains_rank_source(node.value, tainted):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        tainted.add(tgt.id)
    return tainted


def _direct_children(func: ast.AST):
    body = getattr(func, "body", None)
    if body is None:
        return []
    return body if isinstance(body, list) else [body]


def _expr_parts(stmt: ast.AST) -> List[ast.AST]:
    """Expression subtrees evaluated AT this statement (compound bodies
    are walked separately so nothing is visited twice)."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, ast.Try):
        return []
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    return [stmt]


def _scan_for(func: ast.AST, sf: SourceFile) -> "_FuncScan":
    """Memoized _FuncScan: the three HVD1xx rules share one scan per
    function instead of re-walking (and re-tainting) it three times."""
    cache = getattr(sf, "_hvd_funcscans", None)
    if cache is None:
        cache = sf._hvd_funcscans = {}
    scan = cache.get(id(func))
    if scan is None:
        scan = cache[id(func)] = _FuncScan(func, sf)
    return scan


class _FuncScan:
    """One function scope: rank-gated regions, collectives, early exits."""

    def __init__(self, func: ast.AST, sf: SourceFile):
        self.sf = sf
        self.func = func
        self.tainted = _tainted_names(func)
        self.gated_collectives: List[tuple] = []   # (call node, gate node)
        self.gated_exits: List[tuple] = []         # (exit stmt, gate node)
        self.collectives: List[ast.Call] = []      # all, gated or not
        self.unordered_loops: List[tuple] = []     # (for node, call node)
        self._nested = {
            n for n in ast.walk(func)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)) and n is not func}
        self._walk(_direct_children(func), gates=[], loops=[])

    def _is_rank_dep(self, test: ast.AST) -> bool:
        return _contains_rank_source(test, self.tainted)

    def _scan_exprs(self, stmt: ast.AST, gates: List[ast.AST],
                    loops: List[ast.AST]) -> None:
        for part in _expr_parts(stmt):
            for sub in ast.walk(part):
                if self._in_nested(sub) or not isinstance(sub, ast.Call):
                    continue
                if not is_collective_call(sub, self.sf):
                    continue
                self.collectives.append(sub)
                gate = gates[-1] if gates else \
                    self._rank_ifexp_above(sub, part)
                if gate is not None:
                    self.gated_collectives.append((sub, gate))
                for loop in loops:
                    self.unordered_loops.append((loop, sub))

    def _walk(self, stmts, gates: List[ast.AST],
              loops: List[ast.AST]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                     # separate scope
            if isinstance(stmt, (ast.Return, ast.Raise, ast.Break,
                                 ast.Continue)) and gates:
                self.gated_exits.append((stmt, gates[-1]))
            self._scan_exprs(stmt, gates, loops)
            if isinstance(stmt, (ast.If, ast.While)):
                dep = self._is_rank_dep(stmt.test)
                sub_gates = gates + [stmt] if dep else gates
                self._walk(stmt.body, sub_gates, loops)
                self._walk(stmt.orelse, sub_gates, loops)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                dep = self._is_rank_dep(stmt.iter)
                sub_gates = gates + [stmt] if dep else gates
                sub_loops = loops + [stmt] if _unordered_iterable(
                    stmt.iter) else loops
                self._walk(stmt.body, sub_gates, sub_loops)
                self._walk(stmt.orelse, sub_gates, loops)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._walk(stmt.body, gates, loops)
            elif isinstance(stmt, ast.Try):
                self._walk(stmt.body, gates, loops)
                for h in stmt.handlers:
                    self._walk(h.body, gates, loops)
                self._walk(stmt.orelse, gates, loops)
                self._walk(stmt.finalbody, gates, loops)

    def _in_nested(self, node: ast.AST) -> bool:
        cur = node
        while cur is not None and cur is not self.func:
            if cur in self._nested:
                return True
            cur = getattr(cur, "_hvd_parent", None)
        return False

    def _rank_ifexp_above(self, node: ast.AST,
                          stop: ast.AST) -> Optional[ast.AST]:
        """Nearest enclosing rank-dependent conditional expression
        between a call and its statement (``psum(g) if rank()==0 else
        g`` gates the collective without an ``if`` statement)."""
        cur = getattr(node, "_hvd_parent", None)
        while cur is not None and cur is not stop:
            if isinstance(cur, ast.IfExp) and self._is_rank_dep(cur.test):
                return cur
            cur = getattr(cur, "_hvd_parent", None)
        return None


def _unordered_iterable(it: ast.AST) -> Optional[str]:
    """Describe why the iterable has per-process order, or None."""
    if isinstance(it, (ast.Set, ast.SetComp)):
        return "a set literal"
    if isinstance(it, ast.Call):
        name = call_name(it)
        seg = last_segment(name)
        if seg in ("set", "frozenset"):
            return f"{seg}(...)"
        if seg in ("union", "intersection", "difference",
                   "symmetric_difference"):
            return f"a set .{seg}(...) result"
        if name in ("os.listdir", "os.scandir", "glob.glob",
                    "glob.iglob", "iglob"):
            return f"unsorted {name}(...)"
    return None


class RankGatedCollective(Rule):
    code = "HVD101"
    severity = "error"
    summary = ("collective issued under rank-dependent control flow — "
               "unmatched across ranks, the world hangs")

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        for func in iter_functions(sf.tree):
            if isinstance(func, ast.Lambda):
                continue
            scan = _scan_for(func, sf)
            for call, gate in scan.gated_collectives:
                # No line numbers in the message: it is part of the
                # baseline fingerprint, which must survive line moves.
                gate_kind = type(gate).__name__.lower()
                yield self.finding(
                    sf, call,
                    f"collective {call_name(call)!r} is gated on a "
                    f"rank-dependent condition (an enclosing {gate_kind} "
                    f"branches on rank()/get_rank()): ranks that "
                    f"skip it leave the others blocked in the collective "
                    f"— hoist the collective out of the branch or gate "
                    f"only the host-side consumption of its result",
                    enclosing_symbol(call))


class RankGatedEarlyExit(Rule):
    code = "HVD102"
    severity = "error"
    summary = ("rank-dependent early exit upstream of a collective — "
               "exiting ranks never reach it")

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        for func in iter_functions(sf.tree):
            if isinstance(func, ast.Lambda):
                continue
            scan = _scan_for(func, sf)
            if not scan.collectives:
                continue
            gated = {id(c) for c, _ in scan.gated_collectives}
            for stmt, gate in scan.gated_exits:
                later = [c for c in scan.collectives
                         if c.lineno > stmt.lineno and id(c) not in gated]
                if not later:
                    continue
                kind = type(stmt).__name__.lower()
                yield self.finding(
                    sf, stmt,
                    f"rank-gated {kind} exits before a later "
                    f"{call_name(later[0])!r} collective in this "
                    f"function: processes taking this exit never issue "
                    f"it and the rest hang — make the exit uniform or "
                    f"move the collective ahead of it",
                    enclosing_symbol(stmt))


class UnorderedCollectiveIteration(Rule):
    code = "HVD103"
    severity = "error"
    summary = ("collective issued while iterating an unordered container "
               "— per-process order desyncs the collective sequence")

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        seen = set()
        for func in iter_functions(sf.tree):
            if isinstance(func, ast.Lambda):
                continue
            scan = _scan_for(func, sf)
            for loop, call in scan.unordered_loops:
                if id(call) in seen:
                    continue
                seen.add(id(call))
                why = _unordered_iterable(loop.iter)
                yield self.finding(
                    sf, call,
                    f"collective {call_name(call)!r} issued inside a loop "
                    f"over {why}: set iteration order is per-process "
                    f"(PYTHONHASHSEED), so processes issue collectives in "
                    f"different orders and reduce mismatched tensors — "
                    f"iterate sorted(...) instead",
                    enclosing_symbol(call))


class CollectiveInExceptPath(Rule):
    code = "HVD105"
    severity = "error"
    summary = ("collective inside an except handler or after a "
               "rank-dependent try/except swallow — exception handling "
               "is rank-divergent control flow")

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        for func in iter_functions(sf.tree):
            if isinstance(func, ast.Lambda):
                continue
            scan = _scan_for(func, sf)
            tries = [n for n in ast.walk(func)
                     if isinstance(n, ast.Try) and not scan._in_nested(n)]
            if not tries:
                continue
            # Collectives inside ANY handler, collected up front: they
            # are (a) findings and must not double-report as (b)'s
            # "later collective" of an earlier swallowing try.
            handler_calls: Set[int] = set()
            for node in tries:
                for handler in node.handlers:
                    for sub in ast.walk(handler):
                        if isinstance(sub, ast.Call) and \
                                not scan._in_nested(sub) and \
                                is_collective_call(sub, sf):
                            handler_calls.add(id(sub))
            reported: Set[int] = set()
            for node in tries:
                swallows = False
                for handler in node.handlers:
                    raises = any(isinstance(s, ast.Raise)
                                 for s in ast.walk(handler)
                                 if not scan._in_nested(s))
                    if not raises:
                        swallows = True
                    # (a) a collective issued FROM a handler: only the
                    # rank whose try body raised ever reaches it
                    for sub in ast.walk(handler):
                        if not isinstance(sub, ast.Call) or \
                                scan._in_nested(sub):
                            continue
                        name = is_collective_call(sub, sf)
                        if name is None or id(sub) in reported:
                            continue
                        reported.add(id(sub))
                        yield self.finding(
                            sf, sub,
                            f"collective {name!r} issued inside an "
                            f"'except' handler: exceptions are raised "
                            f"per-rank, so only the failing rank issues "
                            f"it while the rest never enter the handler "
                            f"— the world hangs in the collective; "
                            f"recover locally and issue the collective "
                            f"on the uniform path",
                            enclosing_symbol(sub))
                if not swallows:
                    continue
                # (b) rank-dependent try body + swallowing handler +
                # a later collective: the swallow turns a rank-local
                # failure into rank-divergent downstream state
                rank_dep = any(
                    _contains_rank_source(s, scan.tainted)
                    for s in node.body)
                if not rank_dep:
                    continue
                end = getattr(node, "end_lineno", node.lineno)
                later = [c for c in scan.collectives
                         if c.lineno > end and id(c) not in handler_calls
                         and id(c) not in reported]
                if later:
                    c = later[0]
                    reported.add(id(c))
                    yield self.finding(
                        sf, c,
                        f"collective {call_name(c)!r} follows a "
                        f"rank-dependent try/except whose handler "
                        f"swallows the error: the ranks that raised "
                        f"skipped part of the try body, so state (and "
                        f"possibly the collective sequence) diverges "
                        f"before this call — re-raise, or make the "
                        f"recovery uniform across ranks",
                        enclosing_symbol(c))


# Restore/handoff entry points whose failure modes the compat tier
# certifies statically (HVD8xx): swallowing their exceptions at runtime
# is the same defect made invisible.
RESTORE_CALLS: Set[str] = {
    "restore_latest", "restore_step", "restore_checkpoint",
    "load_for_serving", "adopt_plan_on_restore",
}
_BROAD_HANDLERS = {"Exception", "BaseException"}


def _handler_type_names(handler: ast.ExceptHandler) -> Set[str]:
    """Last segments of every exception type the handler catches
    (empty set for a bare ``except:``)."""
    if handler.type is None:
        return set()
    out: Set[str] = set()
    for sub in ast.walk(handler.type):
        name = dotted_name(sub)
        if name:
            out.add(last_segment(name))
    return out


class SwallowedCheckpointMismatch(Rule):
    code = "HVD106"
    severity = "error"
    summary = ("except handler swallows CheckpointMismatchError (or "
               "bare-excepts a restore/handoff call) and continues — "
               "the handoff-compatibility failure mode made invisible "
               "at runtime")

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        for func in iter_functions(sf.tree):
            if isinstance(func, ast.Lambda):
                continue
            scan = _scan_for(func, sf)
            for node in ast.walk(func):
                if not isinstance(node, ast.Try) or scan._in_nested(node):
                    continue
                restore_in_body = None
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) and \
                                not scan._in_nested(sub) and \
                                last_segment(call_name(sub)) \
                                in RESTORE_CALLS:
                            restore_in_body = call_name(sub)
                            break
                    if restore_in_body:
                        break
                for handler in node.handlers:
                    raises = any(isinstance(s, ast.Raise)
                                 for s in ast.walk(handler)
                                 if not scan._in_nested(s))
                    if raises:
                        continue
                    caught = _handler_type_names(handler)
                    if "CheckpointMismatchError" in caught:
                        # (a) the compat failure named and discarded:
                        # training/serving continues on the stale tree
                        yield self.finding(
                            sf, handler,
                            "except handler swallows "
                            "CheckpointMismatchError and continues: a "
                            "topology-mismatched snapshot is the exact "
                            "defect the HVD8xx compat tier certifies "
                            "against, and this handler erases it at "
                            "runtime — the process keeps serving/"
                            "training the WRONG weights; re-raise, gate "
                            "the restore on a compat_report verdict "
                            "(ROADMAP A.15.4), or go through the documented "
                            "reshard path "
                            "(restore_checkpoint(template=...))",
                            enclosing_symbol(handler))
                    elif restore_in_body is not None and (
                            not caught or caught & _BROAD_HANDLERS):
                        # (b) a broad swallow around a restore/handoff
                        # call catches CheckpointMismatchError with
                        # everything else
                        yield self.finding(
                            sf, handler,
                            f"broad "
                            f"'except{' ' + '/'.join(sorted(caught)) if caught else ''}"
                            f"' swallows every failure of "
                            f"{restore_in_body!r} (including "
                            f"CheckpointMismatchError) and continues — "
                            f"a topology- or geometry-mismatched "
                            f"snapshot restores as 'no checkpoint' and "
                            f"the run silently starts over or serves "
                            f"stale weights; catch the specific "
                            f"recoverable errors and re-raise the "
                            f"mismatch, or certify the handoff first "
                            f"(compat_report, ROADMAP A.15.4)",
                            enclosing_symbol(handler))


RULES = [RankGatedCollective(), RankGatedEarlyExit(),
         UnorderedCollectiveIteration(), CollectiveInExceptPath(),
         SwallowedCheckpointMismatch()]
