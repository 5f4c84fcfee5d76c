"""Goodput accounting of the port: the time-attribution accountant.

:mod:`accountant` attributes every second of run wall time to exactly one
phase (init, compile, step_compute, exposed_collective, input_wait,
checkpoint, restart, degraded, idle), folded from the signal sources the
port has (the train loop's phases, StepStats, retry backoffs, the
checkpoint's device->host copy and restore). It is published as the
``hvd_goodput_fraction`` / ``hvd_goodput_phase_seconds{phase=}`` gauges,
the ``goodput`` block of ``metrics_snapshot()``, and
:func:`goodput_report`.

Not ported yet (ROADMAP A.13b): ``numerics`` (the anomaly detectors) and
``ledger`` (the per-run JSONL record and the regression sentinel).
"""

from horovod_tpu_torch.goodput.accountant import (  # noqa: F401
    GOODPUT_PHASES,
    PHASES,
    carve,
    current_phase,
    enabled,
    get_accountant,
    goodput_report,
    health_block,
    init_begin,
    init_end,
    phase_scope,
    reset_for_tests,
    set_phase,
)
