"""Span-based tracing of the port.

- ``spans``     : the recording core, ``trace.span("name", ...)`` context
                  managers into a per-process ring buffer (allocation-free
                  when ``HOROVOD_TRACE=0``), Chrome-trace export and the
                  flight recording dumped on stall, preemption and
                  degraded paths.
- ``straggler`` : per-rank step-time skew over the c10d store: which RANK
                  is slow, exported as ``hvd_straggler_skew_seconds``.

Not ported yet (ROADMAP A.13b): ``merge`` (the cross-rank trace merge) and
``profile`` (profiler capture windows).

Usage::

    from horovod_tpu_torch import tracing as trace
    with trace.span("train.load_batch", cat=trace.CAT_DATA):
        batch = next(loader)
"""

from horovod_tpu_torch.tracing.spans import (  # noqa: F401
    CAT_CHECKPOINT,
    CAT_COORDINATOR,
    CAT_DATA,
    CAT_ELASTIC,
    CAT_PREEMPTION,
    CAT_TIMELINE,
    CAT_TRAIN,
    CAT_WAIT,
    begin_async,
    disable,
    dump_flight_recording,
    enable,
    enabled,
    end_async,
    epoch_unix,
    export_chrome_trace,
    init_from_env,
    instant,
    record,
    reset,
    snapshot,
    span,
    span_counts,
    summary,
    trace_dir,
    trace_id,
)
