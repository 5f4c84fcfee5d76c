"""HVD2xx — trace safety.

A traced or captured step runs its Python body ONCE: under
``torch.compile`` (Dynamo traces it into a graph), ``torch.jit.script`` /
``torch.jit.trace``, a CUDA graph capture (``with torch.cuda.graph(g):``,
``torch.cuda.make_graphed_callables``), or the JAX package's
jit/pjit/shard_map/pmap. Host side effects inside it do not re-execute
per step (a replayed CUDA graph runs only its kernels), and they execute
at different wall times on different ranks: a ``time.time()`` or
``os.environ`` read baked into the captured program is a silent per-rank
constant. These rules flag host effects lexically inside such bodies:

- HVD201: wall-clock reads (time.time/perf_counter/datetime.now).
- HVD202: host RNG (np.random.*, random.*) — per-process streams bake
  per-process constants into the compiled program; draw on the device
  from a seeded ``torch.Generator`` (or jax.random with an explicit key).
- HVD203: os.environ reads — trace-time constants that can differ
  across hosts (host-uniform knobs must resolve BEFORE tracing).
- HVD204: print() — executes once at trace time.
- HVD205: .item()/.tolist()/.numpy() on traced values — a graph break
  and device sync under torch.compile, a capture error in a CUDA graph,
  ConcretizationTypeError under jit.
- HVD206: tracing/timing span context managers (``with trace.span(...)``
  / ``timeline.span(...)``) opened inside a traced body — they measure
  TRACE time (once, at compile), not run time, and record a
  zero-information span per compile instead of per step; label device
  ops with ``torch.autograd.profiler.record_function`` (or
  ``jax.named_scope``) instead, which the profile attribution maps back.
  Raw ``time.perf_counter()`` reads in traced bodies are HVD201's.
- HVD207: metric created outside the registry namespace — every
  counter/gauge/histogram must be created through the ``metrics.py``
  registry with an ``hvd_``-prefixed snake_case name (the namespace
  dashboards, the cluster aggregator, and docs/observability.md index
  by), and never through an ad-hoc client library
  (``prometheus_client``) that would bypass the registry's idempotent
  creation, cluster merge, and snapshot surfaces.

Functions passed to jax.pure_callback / io_callback are exempt: they
are the sanctioned host-effect escape hatch. The port itself compiles,
scripts and captures nothing today, so HVD201–HVD206 find nothing in its
tree and are held on fixtures; HVD207 checks its ``metrics.py``
registry's callers.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional, Set

from horovod_tpu_torch.analysis.engine import (
    Finding, Rule, SourceFile, enclosing_symbol, last_segment,
)

TRACERS = {"jit", "pjit", "pmap", "shard_map", "xmap"}
# torch's tracers and graph captures, by their dotted tails: the generic
# last segments (compile, script, trace) name other things elsewhere
# (re.compile), so these match only behind torch's module path.
TORCH_TRACERS = ("torch.compile", "torch.jit.script", "jit.script",
                 "torch.jit.trace", "jit.trace", "make_graphed_callables")
# ``with torch.cuda.graph(g):`` captures its body.
CAPTURE_CONTEXTS = ("torch.cuda.graph", "cuda.graph")
CALLBACK_WRAPPERS = {"pure_callback", "io_callback", "host_callback",
                     "call", "debug_callback"}

WALLCLOCK = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.time_ns", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.today",
}
CONCRETIZERS = {"item", "tolist", "numpy"}


def _is_tracer_name(dotted: Optional[str]) -> bool:
    if not dotted:
        return False
    return last_segment(dotted) in TRACERS or any(
        dotted == t or dotted.endswith("." + t) for t in TORCH_TRACERS)


def _is_tracer_expr(node: ast.AST) -> bool:
    """jax.jit / jit / partial(jax.jit, ...) / torch.compile /
    torch.compile(mode=...) / torch.jit.script ..."""
    if isinstance(node, (ast.Name, ast.Attribute)):
        return _is_tracer_name(_dotted(node))
    if isinstance(node, ast.Call):
        fn = _dotted(node.func)
        if _is_tracer_name(fn):
            return True
        if last_segment(fn) == "partial" and node.args:
            return _is_tracer_expr(node.args[0])
    return False


def _is_capture(node: ast.AST) -> bool:
    """``with torch.cuda.graph(g):`` (any alias path ending so)."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        ce = item.context_expr
        if isinstance(ce, ast.Call):
            fn = _dotted(ce.func) or ""
            if any(fn == c or fn.endswith("." + c)
                   for c in CAPTURE_CONTEXTS):
                return True
    return False


def traced_name(traced: ast.AST) -> str:
    if isinstance(traced, (ast.With, ast.AsyncWith)):
        return "<cuda graph capture>"
    return getattr(traced, "name", "<lambda>")


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def find_traced_functions(tree: ast.AST) -> List[ast.AST]:
    """Function defs (and lambdas) that are traced: decorated with a
    tracer, or passed directly to one (``jax.jit(step)``,
    ``torch.compile(step)``); and the ``with`` blocks that capture a
    CUDA graph."""
    traced: List[ast.AST] = []
    defs_by_name: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)
            for dec in node.decorator_list:
                if _is_tracer_expr(dec):
                    traced.append(node)
                    break
    for node in ast.walk(tree):
        if _is_capture(node):
            traced.append(node)
        if not isinstance(node, ast.Call):
            continue
        fn = _dotted(node.func)
        if not _is_tracer_name(fn):
            continue
        for arg in list(node.args[:1]) + [
                kw.value for kw in node.keywords
                if kw.arg in ("fun", "f", "func")]:
            if isinstance(arg, ast.Lambda):
                traced.append(arg)
            elif isinstance(arg, ast.Name):
                for d in defs_by_name.get(arg.id, []):
                    if d not in traced:
                        traced.append(d)
    return traced


def _traced_in(sf: SourceFile) -> List[ast.AST]:
    """:func:`find_traced_functions` of ``sf``, memoized: the six trace
    rules share one search."""
    cached = getattr(sf, "_hvd_traced", None)
    if cached is None:
        cached = sf._hvd_traced = find_traced_functions(sf.tree)
    return cached


def _callback_protected(node: ast.AST, boundary: ast.AST) -> bool:
    """True when `node` sits inside a function/lambda that is passed to
    a callback wrapper (pure_callback etc.) within the traced region."""
    cur = getattr(node, "_hvd_parent", None)
    inner_def: Optional[ast.AST] = None
    while cur is not None and cur is not boundary:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            inner_def = cur
        cur = getattr(cur, "_hvd_parent", None)
    if inner_def is None:
        return False
    # lambda passed inline to a callback wrapper
    parent = getattr(inner_def, "_hvd_parent", None)
    if isinstance(parent, ast.Call) and \
            last_segment(_dotted(parent.func)) in CALLBACK_WRAPPERS:
        return True
    # named def referenced as a callback-wrapper argument anywhere in
    # the traced region
    if isinstance(inner_def, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for sub in ast.walk(boundary):
            if isinstance(sub, ast.Call) and \
                    last_segment(_dotted(sub.func)) in CALLBACK_WRAPPERS:
                for a in list(sub.args) + [k.value for k in sub.keywords]:
                    if isinstance(a, ast.Name) and a.id == inner_def.name:
                        return True
    return False


class _TraceRule(Rule):
    """Shared scaffolding: yield findings for matching calls inside
    traced functions."""

    def matches(self, call: ast.Call, dotted: Optional[str],
                seg: str) -> Optional[str]:
        raise NotImplementedError

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        seen: Set[int] = set()
        for traced in _traced_in(sf):
            for node in ast.walk(traced):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                dotted = _dotted(node.func)
                msg = self.matches(node, dotted, last_segment(dotted))
                if msg is None:
                    continue
                if _callback_protected(node, traced):
                    continue
                seen.add(id(node))
                name = traced_name(traced)
                yield self.finding(
                    sf, node, f"{msg} inside traced function {name!r} "
                    f"(runs once at trace or capture time, not per step; "
                    f"and per-rank results bake rank-divergent constants "
                    f"into the compiled program)",
                    enclosing_symbol(node) or name)


class WallClockInTrace(_TraceRule):
    code = "HVD201"
    severity = "error"
    summary = ("wall-clock read inside a torch.compile / jit / CUDA graph "
               "captured function")

    def matches(self, call, dotted, seg):
        if dotted in WALLCLOCK:
            return f"host wall-clock read {dotted!r}"
        return None


class HostRngInTrace(_TraceRule):
    code = "HVD202"
    severity = "error"
    summary = "host RNG inside a traced function (draw on the device)"

    def matches(self, call, dotted, seg):
        if dotted is None:
            return None
        if dotted.startswith(("np.random.", "numpy.random.", "random.")):
            return (f"host RNG {dotted!r} — traced once, and each "
                    f"process draws a different stream; draw on the "
                    f"device from a seeded torch.Generator")
        return None


class EnvReadInTrace(_TraceRule):
    code = "HVD203"
    severity = "warning"
    summary = "os.environ read inside a traced function"

    def matches(self, call, dotted, seg):
        if dotted == "os.getenv":
            return "environment read 'os.getenv'"
        if dotted and dotted.startswith("os.environ."):
            return f"environment read {dotted!r}"
        return None

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        yield from super().check_file(sf)
        # subscript reads: os.environ["X"]. `seen` dedups nodes visited
        # through both an outer traced function and a nested traced one.
        seen: Set[int] = set()
        for traced in _traced_in(sf):
            for node in ast.walk(traced):
                if id(node) in seen:
                    continue
                if isinstance(node, ast.Subscript) and \
                        _dotted(node.value) == "os.environ" and \
                        isinstance(node.ctx, ast.Load) and \
                        not _callback_protected(node, traced):
                    seen.add(id(node))
                    name = traced_name(traced)
                    yield self.finding(
                        sf, node,
                        f"environment read 'os.environ[...]' inside "
                        f"traced function {name!r} (trace-time constant; "
                        f"can differ per host)",
                        enclosing_symbol(node) or name)


class PrintInTrace(_TraceRule):
    code = "HVD204"
    severity = "warning"
    summary = "print() inside a traced function"

    def matches(self, call, dotted, seg):
        if dotted == "print":
            return "'print' executes at trace time only — print the " \
                   "step's outputs outside the traced body"
        return None


class ConcretizeInTrace(_TraceRule):
    code = "HVD205"
    severity = "error"
    summary = ".item()/.tolist()/.numpy() on a traced value"

    def matches(self, call, dotted, seg):
        if seg in CONCRETIZERS and isinstance(call.func, ast.Attribute) \
                and not call.args and not call.keywords:
            return (f"'.{seg}()' concretizes a traced value — a graph "
                    f"break and host sync under torch.compile, a capture "
                    f"error in a CUDA graph; keep values on the device "
                    f"or move this out of the traced function")
        return None


class SpanInTrace(Rule):
    code = "HVD206"
    severity = "error"
    summary = "tracing span context manager inside a traced function"

    # with-item context expressions whose call target's last attribute
    # is one of these open a host-side measurement interval.
    SPAN_NAMES = {"span"}

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        seen: Set[int] = set()
        for traced in _traced_in(sf):
            for node in ast.walk(traced):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                for item in node.items:
                    ce = item.context_expr
                    if not isinstance(ce, ast.Call) or id(ce) in seen:
                        continue
                    fn = ce.func
                    # trace.span(...), tl.span(...),
                    # get_timeline().span(...) (call-chained attribute),
                    # or a bare span(...).
                    is_span = (
                        (isinstance(fn, ast.Attribute)
                         and fn.attr in self.SPAN_NAMES)
                        or (isinstance(fn, ast.Name)
                            and fn.id in self.SPAN_NAMES))
                    if not is_span:
                        continue
                    if _callback_protected(node, traced):
                        continue
                    seen.add(id(ce))
                    name = traced_name(traced)
                    label = _dotted(fn) or (
                        f"...{fn.attr}" if isinstance(fn, ast.Attribute)
                        else fn.id)
                    yield self.finding(
                        sf, node,
                        f"tracing span {label!r} opened inside traced "
                        f"function {name!r} — the body runs ONCE at "
                        f"trace time, so this measures compile-time "
                        f"Python, not per-step run time; label device "
                        f"ops with record_function or jax.named_scope "
                        f"(mapped back by the profile attribution) "
                        f"instead",
                        enclosing_symbol(node) or name)


class AdHocMetric(Rule):
    """HVD207 — metrics/gauges must be created through the metrics.py
    registry under the ``hvd_`` namespace. Two shapes:

    - a ``counter(...)/gauge(...)/histogram(...)`` call whose literal
      metric name does not match ``^hvd_[a-z0-9_]+$`` (ad-hoc names
      fragment the namespace the aggregator and dashboards key on);
    - any ``prometheus_client`` import — a second metrics registry
      bypasses the unified one (idempotent creation, leader merge,
      snapshot dump) and its metrics never reach ``/metrics``.

    The registry module itself (defines ``MetricsRegistry``) is exempt:
    its factory helpers receive names as parameters, not literals."""

    code = "HVD207"
    severity = "error"
    summary = "metric created outside the hvd_ registry namespace"

    FACTORIES = {"counter", "gauge", "histogram"}
    NAME_RE = re.compile(r"^hvd_[a-z0-9_]+$")

    def _is_registry_module(self, sf: SourceFile) -> bool:
        if sf.rel.endswith("horovod_tpu_torch/metrics.py"):
            return True
        return any(isinstance(n, ast.ClassDef)
                   and n.name == "MetricsRegistry"
                   for n in ast.walk(sf.tree))

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        if self._is_registry_module(sf):
            return
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mod = getattr(node, "module", None) or ""
                names = [a.name for a in node.names]
                if mod.split(".")[0] == "prometheus_client" or any(
                        n.split(".")[0] == "prometheus_client"
                        for n in names):
                    yield self.finding(
                        sf, node,
                        "prometheus_client import — a second metrics "
                        "registry bypasses horovod_tpu_torch.metrics "
                        "(idempotent creation, cluster aggregation, "
                        "snapshot dump); create metrics through the "
                        "unified registry instead",
                        enclosing_symbol(node))
                continue
            if not isinstance(node, ast.Call):
                continue
            seg = last_segment(_dotted(node.func))
            if seg not in self.FACTORIES or not node.args:
                continue
            name = node.args[0]
            if not (isinstance(name, ast.Constant)
                    and isinstance(name.value, str)):
                continue
            if not self.NAME_RE.match(name.value):
                yield self.finding(
                    sf, node,
                    f"metric name {name.value!r} is outside the "
                    f"registry namespace — every metric is created "
                    f"through the metrics.py registry with an "
                    f"hvd_-prefixed snake_case name (the namespace "
                    f"/metrics, the cluster merge, and "
                    f"docs/observability.md index by)",
                    enclosing_symbol(node))


RULES = [WallClockInTrace(), HostRngInTrace(), EnvReadInTrace(),
         PrintInTrace(), ConcretizeInTrace(), SpanInTrace(),
         AdHocMetric()]
