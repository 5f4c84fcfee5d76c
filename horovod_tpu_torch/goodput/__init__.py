"""Goodput accounting of the port: the time-attribution accountant.

:mod:`accountant` attributes every second of run wall time to exactly one
phase (init, compile, step_compute, exposed_collective, input_wait,
checkpoint, restart, degraded, idle), folded from the signal sources the
port has (the train loop's phases, StepStats, retry backoffs, the
checkpoint's device->host copy and restore). It is published as the
``hvd_goodput_fraction`` / ``hvd_goodput_phase_seconds{phase=}`` gauges,
the ``goodput`` block of ``metrics_snapshot()``, and
:func:`goodput_report`.

:mod:`numerics` feeds per-tensor nonfinite counts and squared norms (the
eager coordinator's allreduce bins) and the loss (``train_loop``) to
streaming anomaly detectors (loss spike, grad-norm explosion, nonfinite
localized to its tensor) that fire flight recordings. :mod:`ledger` is the
append-only per-run JSONL record written at ``shutdown()`` and the
regression sentinel over it.
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
from horovod_tpu_torch.goodput.ledger import (  # noqa: F401,E402
    append_record,
    build_record,
    read_ledger,
    regression_report,
    write_on_shutdown,
)
