"""CLI for hvdlint-torch: ``python -m horovod_tpu_torch.analysis <paths...>``.

Exit codes, as the JAX package's ``hvdlint``: 0 = no findings beyond the
baseline; 1 = new findings (or, for ``--replay``, a reproduced
violation); 2 = usage/internal error, a checker crash included.
``--write-baseline`` regenerates the grandfather file after deliberate
review.

Two tiers share this CLI and its fingerprint/suppression/baseline
pipeline: the AST walk over ``paths`` (HVD1xx-4xx) and ``--model``
protocol model checking (HVD6xx; also the ``hvdmodel-torch`` console
alias, which model-checks every built-in scenario by default), with
``--replay`` to re-run a counterexample trace. The JAX CLI's other tiers
are not ported yet and their flags are usage errors: ``--ir`` (HVD5xx,
ROADMAP A.15.3), ``--cost`` and ``--compat`` (HVD7xx and HVD8xx, A.15.4).
"""

from __future__ import annotations

import argparse
import os
import sys

from horovod_tpu_torch.analysis import (
    Options, all_rules, collect_files, load_baseline, run_rules, split_new,
    write_baseline,
)
from horovod_tpu_torch.analysis.engine import (
    DEFAULT_EXCLUDES, render_github, render_json, render_text,
    unused_suppressions,
)

DEFAULT_BASELINE = ".hvdlint-torch-baseline.json"
DEFAULT_TRACE_DIR = ".hvdmodel-torch"

# flag -> (tier, ROADMAP item) of the tiers not ported yet
UNPORTED_TIERS = {
    "ir": ("HVD5xx step verification", "A.15.3"),
    "cost": ("HVD7xx resource analysis", "A.15.4"),
    "compat": ("HVD8xx handoff certification", "A.15.4"),
}


def _locate_baseline(arg: str | None) -> str | None:
    if arg:
        return arg
    if os.path.exists(DEFAULT_BASELINE):
        return DEFAULT_BASELINE
    # repo root relative to this package (running from elsewhere)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cand = os.path.join(root, DEFAULT_BASELINE)
    return cand if os.path.exists(cand) else None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdlint-torch",
        description="Static SPMD-consistency / trace-safety / concurrency "
                    "/ knob-registry analyzer for horovod_tpu_torch.")
    p.add_argument("paths", nargs="*", default=[],
                   help="files or directories to scan")
    for flag, (tier, item) in UNPORTED_TIERS.items():
        p.add_argument(f"--{flag}", action="append", default=[],
                       metavar="TARGET",
                       help=f"the JAX hvdlint's {tier}: not ported yet "
                            f"(ROADMAP {item}); a usage error")
    p.add_argument("--model", action="append", default=[],
                   metavar="SCENARIO",
                   help="protocol model-checking target (HVD6xx, "
                        "hvdmodel-torch): 'all', a built-in scenario "
                        "name (coordinator, checkpoint, "
                        "checkpoint_multihost, preemption, elastic, "
                        "resume, kv_brownout, resize, fleet), or "
                        "'path.py:callable' returning a Scenario (or a "
                        "list). Explores schedules of the port's REAL "
                        "protocol code up to HOROVOD_MODEL_BUDGET_SECONDS "
                        "(--model-budget), writing a replayable "
                        "counterexample trace per finding into "
                        "--trace-dir. Repeatable.")
    p.add_argument("--model-budget", type=float, default=None,
                   metavar="SECONDS",
                   help="wall-clock exploration budget across all "
                        "--model scenarios (default: "
                        "HOROVOD_MODEL_BUDGET_SECONDS)")
    p.add_argument("--trace-dir", default=DEFAULT_TRACE_DIR, metavar="DIR",
                   help=f"where --model writes counterexample traces "
                        f"(default: {DEFAULT_TRACE_DIR})")
    p.add_argument("--replay", default=None, metavar="TRACE_JSON",
                   help="re-execute one recorded counterexample trace "
                        "deterministically and print its schedule; "
                        "exits 1 when the violation reproduces, 0 when "
                        "the trace no longer violates (bug fixed)")
    p.add_argument("--report-unused-suppressions", action="store_true",
                   help="also fail on '# hvdlint: disable=' comments "
                        "that no longer suppress any finding (HVD002). "
                        "Judged only for the rule families actually run "
                        "— use with the full rule set, not --select.")
    p.add_argument("--format", choices=("text", "json", "github"),
                   default="text",
                   help="'github' emits ::error/::warning workflow "
                        "annotations for new findings (inline PR "
                        "rendering)")
    p.add_argument("--baseline", default=None,
                   help=f"baseline JSON (default: {DEFAULT_BASELINE} in "
                        f"cwd or the repo root, when present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline: every finding is 'new'")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings as the new baseline "
                        "and exit 0")
    p.add_argument("--exclude", action="append", default=[],
                   metavar="PATH", help="additional path prefixes to skip")
    p.add_argument("--knobs-doc", default=None,
                   help="docs/knobs.md path for HVD402/403 (default: "
                        "auto-located from the scanned config module)")
    p.add_argument("--select", default=None, metavar="CODES",
                   help="comma-separated rule codes/prefixes to run "
                        "(e.g. HVD1,HVD304)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def _select_findings(findings, select):
    """Apply the --select code-prefix filter to an already-produced
    findings list (the AST tier instead filters its rules up front, so
    unselected rules never run)."""
    if not select:
        return findings
    sels = [s.strip().upper() for s in select.split(",") if s]
    return [f for f in findings
            if any(f.code.startswith(s) for s in sels)]


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, (tier, item) in UNPORTED_TIERS.items():
        if getattr(args, flag):
            parser.error(f"--{flag}: the {tier} tier is not ported to "
                         f"horovod_tpu_torch yet (ROADMAP {item}); "
                         f"hvdlint-torch runs HVD1xx-HVD4xx and HVD6xx")
    rules = all_rules()
    if args.list_rules:
        from horovod_tpu_torch.analysis import rules_model
        for r in list(rules) + list(rules_model.RULES):
            print(f"{r.code}  {r.severity:<7}  {r.summary}")
        return 0
    if args.replay:
        return _replay(args.replay)
    if not args.paths and not args.model:
        print("hvdlint-torch: no paths given (try: python -m "
              "horovod_tpu_torch.analysis horovod_tpu_torch)",
              file=sys.stderr)
        return 2
    if args.select:
        sels = [s.strip().upper() for s in args.select.split(",") if s]
        rules = [r for r in rules
                 if any(r.code.startswith(s) for s in sels)]
        if not rules and not args.model:
            print(f"hvdlint-torch: --select {args.select!r} matches no "
                  f"rules", file=sys.stderr)
            return 2

    findings = []
    if args.paths:
        excludes = tuple(DEFAULT_EXCLUDES) + tuple(args.exclude)
        files = collect_files(args.paths, excludes)
        if not files:
            print("hvdlint-torch: no Python files found under "
                  + " ".join(args.paths), file=sys.stderr)
            return 2
        findings = run_rules(files, rules, Options(knobs_doc=args.knobs_doc))
        if args.report_unused_suppressions:
            findings = sorted(
                findings + unused_suppressions(files,
                                               [r.code for r in rules]),
                key=lambda f: (f.path, f.line, f.col, f.code))
    if args.model:
        # Model checking runs real protocols under the shimmed scheduler,
        # so it needs the runtime (torch) importable: opt-in per scenario
        # rather than part of the path walk.
        from horovod_tpu_torch.analysis import rules_model
        from horovod_tpu_torch.analysis.model import run_model
        try:
            results, traces = run_model(args.model,
                                        budget_s=args.model_budget,
                                        trace_dir=args.trace_dir)
        except (ImportError, ValueError, AttributeError) as e:
            print(f"hvdlint-torch: --model failed: {e}", file=sys.stderr)
            return 2
        except Exception as e:   # noqa: BLE001 - a checker CRASH must
            # exit 2, never 1: a gate that wants "the corpus fails with
            # exit exactly 1" would otherwise read a broken checker as a
            # caught bug
            import traceback
            traceback.print_exc()
            print(f"hvdlint-torch: --model crashed: {type(e).__name__}: "
                  f"{e}", file=sys.stderr)
            return 2
        rules_model.render_summary(results, out=sys.stderr)
        if traces:
            print(f"hvdmodel-torch: {len(traces)} counterexample trace(s) "
                  f"written under {args.trace_dir}", file=sys.stderr)
        model_findings = _select_findings(rules_model.to_findings(results),
                                          args.select)
        findings = sorted(findings + model_findings,
                          key=lambda f: (f.path, f.line, f.col, f.code))

    baseline_path = _locate_baseline(args.baseline)
    if args.write_baseline:
        path = args.baseline or DEFAULT_BASELINE
        write_baseline(path, findings)
        print(f"hvdlint-torch: wrote {len(findings)} finding(s) to {path}")
        return 0

    baseline = {}
    if baseline_path and not args.no_baseline:
        try:
            baseline = load_baseline(baseline_path)
        except (OSError, ValueError) as e:
            print(f"hvdlint-torch: cannot read baseline {baseline_path}: "
                  f"{e}", file=sys.stderr)
            return 2
    new, baselined = split_new(findings, baseline)

    if args.format == "json":
        render_json(findings, new, baselined)
    elif args.format == "github":
        render_github(findings, new, baselined)
    else:
        render_text(findings, new, baselined)
    return 1 if new else 0


def _replay(path: str) -> int:
    """Deterministically re-execute a counterexample trace file and
    print its schedule. Exit 1 = violation reproduced (the trace still
    demonstrates the bug), 0 = clean (fixed), 2 = trace unusable."""
    from horovod_tpu_torch.analysis.model import (
        ReplayDivergence, replay_file,
    )
    try:
        out = replay_file(path)
    except (OSError, ValueError, ReplayDivergence) as e:
        print(f"hvdmodel-torch: cannot replay {path}: {e}",
              file=sys.stderr)
        return 2
    except Exception as e:   # noqa: BLE001 - same contract as --model: a
        # replay CRASH (unresolvable spec, renamed fixture callable, an
        # import error) must exit 2, never 1, or it reads as a reproduced
        # violation
        import traceback
        traceback.print_exc()
        print(f"hvdmodel-torch: --replay crashed on {path}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    for i, key in enumerate(out.chosen):
        print(f"  {i:4d}  {' | '.join(key)}")
    if out.violation is not None:
        print(f"hvdmodel-torch: replay reproduced {out.violation.code}: "
              f"{out.violation}")
        return 1
    print("hvdmodel-torch: replay completed without a violation (the "
          "counterexample no longer applies)")
    return 0


def model_main(argv=None) -> int:
    """``hvdmodel-torch`` console entry: positional scenario specs
    (default: every built-in scenario over the port's real protocols)
    plus the shared hvdlint-torch pipeline flags. ``hvdmodel-torch
    --replay trace.json`` re-runs a counterexample."""
    argv = list(sys.argv[1:] if argv is None else argv)
    translated: list = []
    # every value-taking option of the shared parser (derived, so a new
    # flag cannot drift out of sync): their values must not be mistaken
    # for positional scenario specs
    passthrough_with_value = {
        opt
        for action in build_parser()._actions
        if action.option_strings and action.nargs != 0
        for opt in action.option_strings}
    i = 0
    saw_scenario = False
    while i < len(argv):
        a = argv[i]
        if a.startswith("-"):
            translated.append(a)
            if a in passthrough_with_value and "=" not in a \
                    and i + 1 < len(argv):
                translated.append(argv[i + 1])
                i += 1
        else:
            saw_scenario = True
            translated.extend(["--model", a])
        i += 1
    replaying = any(t == "--replay" or t.startswith("--replay=")
                    for t in translated)
    if not saw_scenario and not replaying:
        translated.extend(["--model", "all"])
    return main(translated)


if __name__ == "__main__":
    sys.exit(main())
