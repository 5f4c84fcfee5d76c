"""Where a finding of a dynamic tier points, and whether it is suppressed.

The AST tiers anchor a finding at the node that raised it. The tiers that
run code (the protocol model checker, HVD6xx; the step verifier, HVD5xx,
ROADMAP A.15.3) anchor it at the definition of the function they ran: a
scenario's function, a step's function. The port's copy of the JAX
package's ``_anchor``/``_suppressed`` (``horovod_tpu/analysis/ir.py``).
Stdlib only.
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, Optional, Tuple

from horovod_tpu_torch.analysis.engine import SourceFile


def _unwrap(fn: Any) -> Any:
    """The function under ``functools.wraps``/``partial`` layers."""
    seen = set()
    while id(fn) not in seen:
        seen.add(id(fn))
        for attr in ("__wrapped__", "func", "_fun"):
            inner = getattr(fn, attr, None)
            if inner is not None and callable(inner):
                fn = inner
                break
        else:
            break
    return fn


def anchor(fn: Any, name: str = "") -> Tuple[str, int, str]:
    """(relpath, line, symbol) of ``fn``'s definition: where findings
    anchor and suppressions attach."""
    raw = _unwrap(fn)
    code = getattr(raw, "__code__", None)
    if code is None:
        return "<unknown>", 1, name or str(fn)
    path = code.co_filename
    try:
        rel = os.path.relpath(path).replace(os.sep, "/")
        if rel.startswith(".."):
            rel = path.replace(os.sep, "/")
    except ValueError:
        rel = path.replace(os.sep, "/")
    symbol = getattr(raw, "__qualname__", getattr(raw, "__name__", ""))
    return rel, code.co_firstlineno, symbol


_SF_CACHE: Dict[str, Optional[SourceFile]] = {}


def _source_file(path: str) -> Optional[SourceFile]:
    if path in _SF_CACHE:
        return _SF_CACHE[path]
    sf = None
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            sf = SourceFile(path, path, f.read())
    except OSError:
        pass
    _SF_CACHE[path] = sf
    return sf


def suppressed(fn: Any, code: str) -> bool:
    """True when a ``# hvdlint: disable=``/``disable-file=`` directive on
    ``fn``'s def line or any of its decorator lines covers ``code``."""
    raw = _unwrap(fn)
    co = getattr(raw, "__code__", None)
    if co is None:
        return False
    sf = _source_file(co.co_filename)
    if sf is None or sf.tree is None:
        return False
    first = co.co_firstlineno
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        dec_lines = [d.lineno for d in node.decorator_list]
        span = sorted(dec_lines + [node.lineno])
        if first not in range(span[0], span[-1] + 1):
            continue
        for line in range(span[0], span[-1] + 1):
            if sf.suppressed(code, line):
                return True
    return sf.suppressed(code, first)
