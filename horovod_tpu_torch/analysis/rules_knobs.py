"""HVD4xx — knob-registry consistency.

``config.knobs`` is the single source of truth for every ``HOROVOD_*``
runtime setting (typed parse, override precedence, autotuner access,
CLI mirrors, host-uniformity documentation). A raw ``os.environ``
read bypasses all of that — it ignores autotuner overrides, parses
ad hoc, and silently forks the host-uniform contract. These rules keep
the registry, the code, and ``docs/knobs.md`` mutually consistent:

- HVD401: raw HOROVOD_* environment read outside the registry module.
- HVD402: registered knob with no ``docs/knobs.md`` row.
- HVD403: ``docs/knobs.md`` row for a knob that is not registered,
  unless the registry module lists it in ``UNREGISTERED_DOC_KNOBS`` with
  its reason (the doc is shared with the JAX package: its TPU-only
  knobs, and those of the analyzer tiers not ported yet).
- HVD404: dead knob — registered but referenced nowhere else in the
  scanned sources (no reader, no CLI mirror).

The registry module is ``horovod_tpu_torch/config.py`` (or any module
defining ``KnobRegistry``); the doc is ``docs/knobs.md``, read only.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from horovod_tpu_torch.analysis.engine import (
    Finding, Options, ProjectRule, SourceFile, call_name, const_str,
    dotted_name, enclosing_symbol, last_segment,
)

_KNOB_RE = re.compile(r"^HOROVOD_[A-Z0-9_]+$")
_DOC_ROW_RE = re.compile(r"^\|\s*`(HOROVOD_[A-Z0-9_]+)`")


def _is_registry_module(sf: SourceFile) -> bool:
    """The module that DEFINES the registry (contains knobs.register
    calls AND the KnobRegistry class, or is named config.py under the
    package) reads os.environ legitimately."""
    if sf.rel.endswith("horovod_tpu_torch/config.py"):
        return True
    return any(isinstance(n, ast.ClassDef) and n.name == "KnobRegistry"
               for n in ast.walk(sf.tree)) if sf.tree else False


def _registered_knobs(files: Sequence[SourceFile]
                      ) -> Dict[str, Tuple[SourceFile, ast.Call]]:
    out: Dict[str, Tuple[SourceFile, ast.Call]] = {}
    for sf in files:
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and \
                    last_segment(call_name(node)) == "register" and \
                    node.args:
                name = const_str(node.args[0])
                if name and _KNOB_RE.match(name):
                    out.setdefault(name, (sf, node))
    return out


def _doc_only_knobs(files: Sequence[SourceFile]) -> Set[str]:
    """The keys of ``UNREGISTERED_DOC_KNOBS``, a dict literal in a
    registry module: docs rows the registry does not register on
    purpose."""
    out: Set[str] = set()
    for sf in files:
        if sf.tree is None or not _is_registry_module(sf):
            continue
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Dict) and any(
                        isinstance(t, ast.Name)
                        and t.id == "UNREGISTERED_DOC_KNOBS"
                        for t in node.targets):
                out.update(k for k in map(const_str, node.value.keys)
                           if k)
    return out


def _raw_env_reads(sf: SourceFile) -> Iterator[Tuple[str, ast.AST]]:
    """(knob_name, node) for os.environ.get / os.getenv /
    os.environ[...] reads of HOROVOD_* literals. Writes (env mirrors
    set by the launcher for child processes) are legitimate and not
    yielded."""
    if sf.tree is None:
        return
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            d = dotted_name(node.func)
            if d in ("os.environ.get", "os.getenv", "environ.get",
                     "getenv") and node.args:
                name = const_str(node.args[0])
                if name and _KNOB_RE.match(name):
                    yield name, node
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load):
            if dotted_name(node.value) in ("os.environ", "environ"):
                name = const_str(node.slice)
                if name and _KNOB_RE.match(name):
                    yield name, node


def _doc_rows(doc_path: str) -> Dict[str, int]:
    rows: Dict[str, int] = {}
    with open(doc_path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            m = _DOC_ROW_RE.match(line)
            if m:
                rows.setdefault(m.group(1), i)
    return rows


def _find_knobs_doc(files: Sequence[SourceFile],
                    options: Options) -> Optional[str]:
    if options.knobs_doc:
        return options.knobs_doc if os.path.exists(options.knobs_doc) \
            else None
    candidates = ["docs/knobs.md"]
    for sf in files:
        if sf.rel.endswith("horovod_tpu_torch/config.py"):
            root = os.path.dirname(os.path.dirname(sf.path))
            candidates.append(os.path.join(root, "docs", "knobs.md"))
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


class KnobConsistency(ProjectRule):
    """All four HVD4xx checks in one project pass (they share the
    registry/docs/usage scan)."""

    code = "HVD401"
    severity = "error"
    summary = "HOROVOD_* knob registry consistency (401-404)"

    def check_project(self, files: Sequence[SourceFile],
                      options: Options) -> Iterator[Finding]:
        registered = _registered_knobs(files)
        reg_files = {id(sf) for sf in files if sf.tree is not None
                     and _is_registry_module(sf)}

        # HVD401 — raw env reads outside the registry module
        for sf in files:
            if sf.tree is None or id(sf) in reg_files:
                continue
            for name, node in _raw_env_reads(sf):
                extra = "" if name in registered else \
                    " (and it is not even registered — register it in " \
                    "config.py first)"
                yield Finding(
                    "HVD401", "error", sf.rel, node.lineno,
                    node.col_offset + 1,
                    f"raw environment read of {name!r}: route through "
                    f"config.knobs.get so overrides, typed parsing, and "
                    f"the autotuner see one source of truth{extra}",
                    enclosing_symbol(node))

        # knob usage anywhere outside the registry module itself (a knob
        # referenced only by its own registration/help text has no
        # reader and no CLI mirror — it is dead)
        used: Set[str] = set()
        for sf in files:
            if sf.tree is None or id(sf) in reg_files:
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Constant) and \
                        isinstance(node.value, str):
                    for m in re.finditer(r"HOROVOD_[A-Z0-9_]+",
                                         node.value):
                        used.add(m.group(0))

        doc = _find_knobs_doc(files, options)
        doc_rows: Dict[str, int] = _doc_rows(doc) if doc else {}
        doc_rel = doc.replace(os.sep, "/") if doc else "docs/knobs.md"

        for name, (sf, node) in sorted(registered.items()):
            # HVD402 — registered but undocumented
            if doc and name not in doc_rows:
                yield Finding(
                    "HVD402", "error", sf.rel, node.lineno,
                    node.col_offset + 1,
                    f"knob {name!r} is registered but has no row in "
                    f"{doc_rel} — every knob ships documented "
                    f"(regenerate the table from the registry)",
                    "")
            # HVD404 — registered but never referenced
            if name not in used:
                yield Finding(
                    "HVD404", "warning", sf.rel, node.lineno,
                    node.col_offset + 1,
                    f"knob {name!r} is registered but referenced nowhere "
                    f"in the scanned sources — dead knob; delete it (and "
                    f"its docs row) or wire the read",
                    "")

        # HVD403 — documented but not registered. Only judged when the
        # registry module is part of the scan: linting a file subset
        # must not misread every docs row as stale.
        doc_only = _doc_only_knobs(files)
        for name, line in (sorted(doc_rows.items()) if registered else ()):
            if name not in registered and name not in doc_only:
                yield Finding(
                    "HVD403", "error", doc_rel, line, 1,
                    f"{doc_rel} documents {name!r} but the registry does "
                    f"not register it — stale row; delete it or restore "
                    f"the knob",
                    "")


RULES = [KnobConsistency()]
