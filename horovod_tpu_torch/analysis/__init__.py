"""hvdlint-torch: static SPMD-consistency, trace-safety, concurrency and
knob-registry analysis of the port (``python -m horovod_tpu_torch.analysis``,
console alias ``hvdlint-torch``).

The port's copy of the JAX package's AST tiers
(``horovod_tpu/analysis/``), retargeted to torch idiom:
- HVD1xx  SPMD consistency: a ``torch.distributed`` or Horovod
          collective, or a c10d store wait, under rank-dependent control
          flow, after a rank-dependent exit, in unordered iteration or in
          an ``except`` path; swallowed checkpoint mismatches.
- HVD2xx  trace safety: host effects inside ``torch.compile``,
          ``torch.jit`` or CUDA-graph-captured bodies (and JAX traced
          ones); metrics created outside the ``hvd_`` registry.
- HVD3xx  concurrency: lock-order inversions, blocking under locks,
          unlocked cross-thread writes, fat signal handlers, unbounded
          KV and c10d store waits.
- HVD4xx  knob registry: raw HOROVOD_* env reads, docs drift against
          ``docs/knobs.md``, dead knobs.

Not ported yet: the IR tier HVD5xx (ROADMAP A.15.3), the protocol model
checker HVD6xx (A.15.2), the cost and handoff tiers HVD7xx/HVD8xx
(A.15.4); the CLI refuses their flags. The analyzer is self-applied to
``horovod_tpu_torch/`` against ``.hvdlint-torch-baseline.json``, which
is empty. The package imports only the stdlib.
"""

from horovod_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    Options,
    ProjectRule,
    Rule,
    SourceFile,
    collect_files,
    load_baseline,
    run_rules,
    split_new,
    write_baseline,
)


def all_rules():
    """Every registered AST rule instance, HVD1xx..HVD4xx."""
    from horovod_tpu_torch.analysis import (
        rules_concurrency, rules_knobs, rules_spmd, rules_trace,
    )
    return (list(rules_spmd.RULES) + list(rules_trace.RULES)
            + list(rules_concurrency.RULES) + list(rules_knobs.RULES))


def analyze(paths, options: "Options" = None, rules=None):
    """Library entry: findings for the given paths (no baseline
    filtering — callers compare via load_baseline/split_new)."""
    files = collect_files(list(paths))
    return run_rules(files, rules if rules is not None else all_rules(),
                     options)
