"""HVD6xx — protocol model checking (``hvdmodel-torch``, ``hvdlint-torch
--model``).

The port's copy of ``horovod_tpu/analysis/rules_model.py``. Where
HVD1xx-4xx read source, the HVD6xx family judges *schedules*:
:mod:`model` exhaustively (up to a budget) interleaves the port's real
coordinator / checkpoint-commit / preemption / elastic protocol code over
shimmed yield-point primitives and checks these invariants on every
explored schedule, crash point and message loss. Each finding carries a
replayable counterexample trace.

This module is stdlib-only (the catalog + the Finding bridge); the
machinery that actually runs protocols lives in :mod:`model`, which needs
the runtime importable.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence

from horovod_tpu_torch.analysis.engine import Finding


class ModelRule:
    def __init__(self, code: str, severity: str, summary: str):
        self.code = code
        self.severity = severity
        self.summary = summary


RULES: List[ModelRule] = [
    ModelRule(
        "HVD601", "error",
        "stop-step agreement violated: controllers quiesce/snapshot at "
        "different steps (or elastic reconcile yields an inconsistent "
        "world) under some schedule"),
    ModelRule(
        "HVD602", "error",
        "checkpoint commit atomicity violated: a schedule observes a "
        "partially-published checkpoint as committed, or rotation "
        "deletes the last committed snapshot"),
    ModelRule(
        "HVD603", "error",
        "deadlock / lost wakeup: some schedule blocks forever (every "
        "live thread on an untimed wait), or a protocol thread dies to "
        "an unhandled exception its peers wait on"),
    ModelRule(
        "HVD604", "error",
        "lost tensor: an enqueued collective is never dispatched nor "
        "resolved with an error — its training step hangs in "
        "synchronize()"),
    ModelRule(
        "HVD605", "error",
        "non-idempotent resume: a crash + restore-latest replay ends in "
        "a different state than the uninterrupted run"),
]

RULES_BY_CODE: Dict[str, ModelRule] = {r.code: r for r in RULES}


def _anchor_and_suppressed(fn: Any, code: str):
    """Anchor a model finding at the scenario function's definition and
    honor ``# hvdlint: disable=HVD6xx`` on its def/decorator lines."""
    from horovod_tpu_torch.analysis.anchors import anchor, suppressed
    path, line, symbol = anchor(fn)
    return path, line, symbol, suppressed(fn, code)


def to_findings(results: Iterable[Any]) -> List[Finding]:
    """Convert :class:`model.ExploreResult`s into engine Findings.

    Messages reference the counterexample trace ONLY by its
    deterministic file name (``<scenario>-<code>.json``), never the
    ``--trace-dir`` value, so fingerprints (path+code+symbol+message)
    are stable across machines, runs and CLI flags; the directory is
    printed separately by the CLI summary."""
    from horovod_tpu_torch.analysis.model import trace_filename
    findings: List[Finding] = []
    for res in results:
        sc = res.scenario
        for mf in res.findings:
            rule = RULES_BY_CODE.get(mf.code)
            severity = rule.severity if rule else "error"
            path, line, symbol, suppressed = _anchor_and_suppressed(
                sc.fn, mf.code)
            if suppressed:
                continue
            # no transition COUNT in the message: which counterexample
            # explore() reaches first depends on the seed and budget, and
            # the count would make the fingerprint knob-dependent
            trace_name = trace_filename(sc.name, mf.code)
            findings.append(Finding(
                mf.code, severity, path, line, 1,
                f"scenario '{sc.name}': {mf.message} "
                f"[counterexample trace; replay: "
                f"hvdmodel-torch --replay <trace-dir>/{trace_name}]",
                symbol))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


def status(res: Any) -> str:
    """How far a scenario's exploration got: exhausted, depth-bounded or
    budget-bounded."""
    if res.exhausted:
        return "exhausted"
    if res.depth_truncated:
        return f"depth-bounded, {res.depth_truncated} truncated run(s)"
    return "budget-bounded"


def render_summary(results: Sequence[Any], out=None) -> None:
    import sys
    out = out or sys.stdout
    for res in results:
        print(f"hvdmodel-torch: scenario {res.scenario.name}: {res.runs} "
              f"schedule(s), {res.transitions} transition(s), "
              f"{len(res.findings)} finding(s) [{status(res)}, "
              f"budget {res.budget_s:.1f}s]", file=out)
