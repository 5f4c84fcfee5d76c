"""CLI for hvdlint-torch: ``python -m horovod_tpu_torch.analysis <paths...>``.

Exit codes, as the JAX package's ``hvdlint``: 0 = no findings beyond the
baseline; 1 = new findings; 2 = usage/internal error.
``--write-baseline`` regenerates the grandfather file after deliberate
review. The AST walk over ``paths`` runs HVD1xx-4xx. The JAX CLI's other
tiers are not ported yet and their flags are usage errors: ``--model``
and ``--replay`` (HVD6xx, ROADMAP A.15.2), ``--ir`` (HVD5xx, A.15.3),
``--cost`` and ``--compat`` (HVD7xx and HVD8xx, A.15.4).
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

# flag -> (tier, ROADMAP item) of the tiers not ported yet
UNPORTED_TIERS = {
    "ir": ("HVD5xx step verification", "A.15.3"),
    "model": ("HVD6xx protocol model checking", "A.15.2"),
    "replay": ("HVD6xx counterexample replay", "A.15.2"),
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


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, (tier, item) in UNPORTED_TIERS.items():
        if getattr(args, flag):
            parser.error(f"--{flag}: the {tier} tier is not ported to "
                         f"horovod_tpu_torch yet (ROADMAP {item}); "
                         f"hvdlint-torch runs HVD1xx-HVD4xx")
    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.code}  {r.severity:<7}  {r.summary}")
        return 0
    if not args.paths:
        print("hvdlint-torch: no paths given (try: python -m "
              "horovod_tpu_torch.analysis horovod_tpu_torch)",
              file=sys.stderr)
        return 2
    if args.select:
        sels = [s.strip().upper() for s in args.select.split(",") if s]
        rules = [r for r in rules
                 if any(r.code.startswith(s) for s in sels)]
        if not rules:
            print(f"hvdlint-torch: --select {args.select!r} matches no "
                  f"rules", file=sys.stderr)
            return 2

    excludes = tuple(DEFAULT_EXCLUDES) + tuple(args.exclude)
    files = collect_files(args.paths, excludes)
    if not files:
        print("hvdlint-torch: no Python files found under "
              + " ".join(args.paths), file=sys.stderr)
        return 2
    findings = run_rules(files, rules, Options(knobs_doc=args.knobs_doc))
    if args.report_unused_suppressions:
        findings = sorted(
            findings + unused_suppressions(files, [r.code for r in rules]),
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


if __name__ == "__main__":
    sys.exit(main())
