"""hvdlint-torch rule engine: AST walk, suppressions, baseline, reporting.

The port's copy of ``horovod_tpu/analysis/engine.py``. Static analysis
is the coordinator protocol moved to build time: the reference's
controller exists because collective *programs* silently diverge across
ranks (horovod's NEGOTIATE phase validates that every rank submitted the
same tensor, controller.cc:496), but a rank-gated ``torch.distributed``
collective or c10d store wait is not renegotiated: it hangs every other
rank until a timeout or the stall inspector notices. The rules catch
that class (and the trace-safety, concurrency and knob-drift classes)
before the program reaches a card.

Engine contract:
- Per-file rules subclass :class:`Rule` (``check_file``); cross-file
  rules subclass :class:`ProjectRule` (``check_project``).
- Findings carry a stable fingerprint (path + code + enclosing symbol +
  message; line numbers excluded so routine edits don't churn the
  baseline).
- ``# hvdlint: disable=HVD101[,HVD102]`` on the finding's line, or on
  ANY line of the simple statement spanning it (a trailing comment on
  the closing paren of a multi-line call covers the whole call),
  suppresses it; ``# hvdlint: disable-file=HVD101`` anywhere in the
  file suppresses for the whole file. Words after the directive are
  ignored, so a suppression carries its reason on the same line.
- A checked-in baseline (JSON fingerprint->count) grandfathers existing
  findings: the CLI exits non-zero only on findings NOT covered by the
  baseline.

The analysis package imports only the stdlib: the rules parse source,
they never import or run it.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import sys
import tokenize
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning")

# Paths (relative, slash-normalized) never scanned unless explicitly
# listed: lint fixtures are deliberate rule violations (the analyzer's
# own test corpus), and caches are not source.
DEFAULT_EXCLUDES = ("__pycache__", ".git", "tests/data/lint",
                    "tests/lint_torch")


@dataclasses.dataclass
class Finding:
    code: str                  # e.g. "HVD101"
    severity: str              # "error" | "warning"
    path: str                  # slash-normalized, relative to cwd
    line: int
    col: int
    message: str
    symbol: str = ""           # enclosing function/class qualname

    def fingerprint(self) -> str:
        raw = "::".join((self.path, self.code, self.symbol, self.message))
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d

    def render(self) -> str:
        where = f" [in {self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"{self.severity}: {self.message}{where}")


class SourceFile:
    """One parsed module: AST with parent links, raw lines, and the
    suppression map extracted from ``# hvdlint:`` comments."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        self.line_suppressions: Dict[int, set] = {}
        self.file_suppressions: set = set()
        # Usage tracking for --report-unused-suppressions: every
        # ``disable=``/``disable-file=`` token maps (comment line, code
        # token) -> consumed?, and _covering maps each covered line back
        # to the comment tokens that cover it (span expansion included).
        self.suppression_comments: Dict[Tuple[int, str], bool] = {}
        self.file_suppression_comments: Dict[Tuple[int, str], bool] = {}
        self._covering: Dict[int, set] = {}
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            self.parse_error = f"{e.msg} (line {e.lineno})"
            return
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                child._hvd_parent = parent  # type: ignore[attr-defined]
        self._scan_suppressions()
        self._expand_statement_spans()

    def _scan_suppressions(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                comment = tok.string.lstrip("#").strip()
                if not comment.startswith("hvdlint:"):
                    continue
                directive = comment[len("hvdlint:"):].strip()
                for part in directive.split():
                    key, _, codes = part.partition("=")
                    codeset = {c.strip().upper() for c in codes.split(",")
                               if c.strip()} or {"ALL"}
                    line = tok.start[0]
                    if key == "disable":
                        self.line_suppressions.setdefault(
                            line, set()).update(codeset)
                        for c in codeset:
                            self.suppression_comments.setdefault(
                                (line, c), False)
                            self._covering.setdefault(line, set()).add(
                                (line, c))
                    elif key == "disable-file":
                        self.file_suppressions.update(codeset)
                        for c in codeset:
                            self.file_suppression_comments.setdefault(
                                (line, c), False)
        except tokenize.TokenError:
            pass

    def _expand_statement_spans(self) -> None:
        """A ``disable=`` comment on any line of a multi-line SIMPLE
        statement covers the statement's whole span: findings anchor to
        the first line of a call/assign while black-style formatting puts
        the trailing comment on the closing paren. Compound statements
        (def/if/with/...) are NOT expanded — a directive inside a body
        must not blanket the enclosing block — but their header (up to
        the colon, i.e. before the first body statement) is."""
        if self.tree is None or not self.line_suppressions:
            return
        spans: List[Tuple[int, int]] = []
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.stmt):
                continue
            start = getattr(node, "lineno", None)
            end = getattr(node, "end_lineno", None)
            # A statement containing nested statements (def/if/with/try/
            # match/...) only expands over its HEADER — the lines before
            # its first nested statement — whatever the construct.
            first_child = min(
                (c.lineno for c in ast.walk(node)
                 if isinstance(c, ast.stmt) and c is not node
                 and getattr(c, "lineno", 0) > (start or 0)),
                default=None)
            if first_child is not None:
                end = first_child - 1
            if start is None or end is None or end <= start:
                continue
            spans.append((start, end))
        for start, end in spans:
            span_codes: set = set()
            span_tokens: set = set()
            for line in range(start, end + 1):
                span_codes |= self.line_suppressions.get(line, set())
                span_tokens |= self._covering.get(line, set())
            if not span_codes:
                continue
            for line in range(start, end + 1):
                self.line_suppressions.setdefault(line, set()).update(
                    span_codes)
                self._covering.setdefault(line, set()).update(span_tokens)

    def suppressed(self, code: str, line: int) -> bool:
        hit = False
        for key in ((k for k in self.file_suppression_comments
                     if k[1] in ("ALL", code))):
            self.file_suppression_comments[key] = True
            hit = True
        fs = self.file_suppressions
        if hit or "ALL" in fs or code in fs:
            return True
        ls = self.line_suppressions.get(line, ())
        if "ALL" in ls or code in ls:
            for key in self._covering.get(line, ()):
                if key[1] in ("ALL", code):
                    self.suppression_comments[key] = True
            return True
        return False


# ---------------------------------------------------------------------------
# rule base classes + registry
# ---------------------------------------------------------------------------

class Rule:
    """Per-file rule. Subclasses set ``code``/``severity``/``summary``
    and implement ``check_file``."""

    code = "HVD000"
    severity = "error"
    summary = ""

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, sf: SourceFile, node: ast.AST, message: str,
                symbol: str = "") -> Finding:
        return Finding(self.code, self.severity, sf.rel,
                       getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) + 1,
                       message, symbol)


class ProjectRule(Rule):
    """Cross-file rule, run once after the walk with every SourceFile."""

    def check_project(self, files: Sequence[SourceFile],
                      options: "Options") -> Iterator[Finding]:
        raise NotImplementedError

    def check_file(self, sf: SourceFile) -> Iterator[Finding]:
        return iter(())


@dataclasses.dataclass
class Options:
    knobs_doc: Optional[str] = None     # docs/knobs.md path for HVD4xx


# ---------------------------------------------------------------------------
# AST helpers shared by the rule families
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.distributed.all_reduce' for a Name/Attribute chain, else
    None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def last_segment(dotted: Optional[str]) -> str:
    return dotted.rsplit(".", 1)[-1] if dotted else ""


def enclosing_symbol(node: ast.AST) -> str:
    """Qualname-ish path of enclosing defs/classes ('Cls.meth')."""
    parts: List[str] = []
    cur = getattr(node, "_hvd_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            parts.append(cur.name)
        cur = getattr(cur, "_hvd_parent", None)
    return ".".join(reversed(parts))


def iter_functions(tree: ast.AST) -> Iterator[ast.AST]:
    """Every function/lambda plus the module itself (top-level code)."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            yield node


def is_store_receiver(receiver: str) -> bool:
    """A receiver named like a c10d store (``store``, ``self._store``,
    ``kv.store``, ``commit_store``)."""
    last = receiver.rsplit(".", 1)[-1] if receiver else ""
    return last in ("store", "_store") or last.endswith("_store")


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ---------------------------------------------------------------------------
# file walking
# ---------------------------------------------------------------------------

def _norm(rel: str) -> str:
    return rel.replace(os.sep, "/")


def _excluded(rel: str, excludes: Sequence[str]) -> bool:
    rel = _norm(rel)
    for pat in excludes:
        if rel == pat or rel.startswith(pat + "/") or ("/" + pat + "/") in \
                ("/" + rel + "/"):
            return True
    return False


def collect_files(paths: Sequence[str],
                  excludes: Sequence[str] = DEFAULT_EXCLUDES
                  ) -> List[SourceFile]:
    seen: Dict[str, SourceFile] = {}
    for root in paths:
        # A root the caller names explicitly is always scanned, even
        # when a default exclude (e.g. tests/data/lint) covers it —
        # excludes exist to keep fixtures out of BROAD scans, not to
        # make them unscannable.
        root_rel = _norm(os.path.relpath(root))
        eff_excludes = [p for p in excludes
                        if not _excluded(root_rel, (p,))]
        if os.path.isfile(root):
            candidates = [root]
        else:
            candidates = []
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if not _excluded(
                        os.path.relpath(os.path.join(dirpath, d)),
                        eff_excludes))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        candidates.append(os.path.join(dirpath, fn))
        for path in candidates:
            rel = _norm(os.path.relpath(path))
            if rel in seen or _excluded(rel, eff_excludes):
                continue
            with open(path, encoding="utf-8", errors="replace") as f:
                seen[rel] = SourceFile(path, rel, f.read())
    return [seen[k] for k in sorted(seen)]


# ---------------------------------------------------------------------------
# analysis driver
# ---------------------------------------------------------------------------

def run_rules(files: Sequence[SourceFile], rules: Sequence[Rule],
              options: Optional[Options] = None) -> List[Finding]:
    options = options or Options()
    findings: List[Finding] = []
    for sf in files:
        if sf.parse_error is not None:
            findings.append(Finding(
                "HVD001", "error", sf.rel, 1, 1,
                f"file does not parse: {sf.parse_error}"))
            continue
        for rule in rules:
            if isinstance(rule, ProjectRule):
                continue
            for f in rule.check_file(sf):
                if not sf.suppressed(f.code, f.line):
                    findings.append(f)
    by_rel = {sf.rel: sf for sf in files}
    for rule in rules:
        if isinstance(rule, ProjectRule):
            for f in rule.check_project(files, options):
                sf = by_rel.get(f.path)
                if sf is None or not sf.suppressed(f.code, f.line):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


def unused_suppressions(files: Sequence[SourceFile],
                        active_codes: Sequence[str]) -> List[Finding]:
    """HVD002: ``# hvdlint: disable=``/``disable-file=`` tokens that
    suppressed nothing in this scan — rotted suppressions that would
    silently swallow a future real finding. Run AFTER run_rules (usage
    is recorded as findings are filtered).

    Only tokens naming a code in ``active_codes`` are judged: a
    ``disable=HVD502`` comment serves the IR tier (consumed by
    ``hvd.verify_step``'s own SourceFile instances), and an ``ALL``
    token may cover any tier, so neither can be called stale by an
    AST-only walk."""
    active = set(active_codes)
    out: List[Finding] = []
    for sf in files:
        items = [(line, tok, used, "disable")
                 for (line, tok), used in sf.suppression_comments.items()]
        items += [(line, tok, used, "disable-file")
                  for (line, tok), used in
                  sf.file_suppression_comments.items()]
        for line, tok, used, kind in sorted(items):
            if used or tok not in active:
                continue
            out.append(Finding(
                "HVD002", "warning", sf.rel, line, 1,
                f"'# hvdlint: {kind}={tok}' no longer suppresses any "
                f"finding — remove the stale suppression (or fix the "
                f"code it was hiding)"))
    return out


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path: str) -> Dict[str, int]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {fp: int(entry["count"]) if isinstance(entry, dict) else int(entry)
            for fp, entry in data.get("findings", {}).items()}


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries: Dict[str, Dict[str, Any]] = {}
    for f in findings:
        fp = f.fingerprint()
        e = entries.setdefault(fp, {
            "count": 0, "code": f.code, "path": f.path,
            "symbol": f.symbol, "message": f.message})
        e["count"] += 1
    payload = {
        "version": BASELINE_VERSION,
        "comment": "hvdlint grandfathered findings; regenerate with "
                   "--write-baseline after deliberate review, never to "
                   "paper over a new finding.",
        "findings": {k: entries[k] for k in sorted(entries)},
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def split_new(findings: Sequence[Finding],
              baseline: Dict[str, int]) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined): per fingerprint, the first `baseline[fp]`
    occurrences are grandfathered, the rest are new."""
    budget = dict(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

def render_text(findings: Sequence[Finding], new: Sequence[Finding],
                baselined: Sequence[Finding], out=None) -> None:
    out = out or sys.stdout
    new_set = {id(f) for f in new}
    for f in findings:
        tag = "" if id(f) in new_set else "  (baselined)"
        print(f.render() + tag, file=out)
    errors = sum(1 for f in findings if f.severity == "error")
    warnings = len(findings) - errors
    print(f"hvdlint: {len(findings)} finding(s) "
          f"({errors} error(s), {warnings} warning(s)); "
          f"{len(baselined)} baselined, {len(new)} new", file=out)


def render_github(findings: Sequence[Finding], new: Sequence[Finding],
                  baselined: Sequence[Finding], out=None) -> None:
    """GitHub Actions workflow commands: one ``::error``/``::warning``
    annotation per NEW finding (rendered inline on the PR diff), then the
    human summary line. Baselined findings stay off the annotations —
    they would spam every PR with the grandfathered backlog."""
    out = out or sys.stdout
    for f in new:
        kind = "error" if f.severity == "error" else "warning"
        # '%' / '\r' / '\n' are the workflow-command escapes.
        msg = (f.message.replace("%", "%25").replace("\r", "%0D")
               .replace("\n", "%0A"))
        print(f"::{kind} file={f.path},line={f.line},col={f.col},"
              f"title={f.code}::{msg}", file=out)
    print(f"hvdlint: {len(findings)} finding(s); "
          f"{len(baselined)} baselined, {len(new)} new", file=out)


def render_json(findings: Sequence[Finding], new: Sequence[Finding],
                baselined: Sequence[Finding], out=None) -> None:
    out = out or sys.stdout
    new_set = {id(f) for f in new}
    payload = {
        "findings": [dict(f.to_dict(), new=id(f) in new_set)
                     for f in findings],
        "summary": {
            "total": len(findings),
            "errors": sum(1 for f in findings if f.severity == "error"),
            "warnings": sum(1 for f in findings if f.severity == "warning"),
            "baselined": len(baselined),
            "new": len(new),
        },
    }
    json.dump(payload, out, indent=1)
    out.write("\n")
