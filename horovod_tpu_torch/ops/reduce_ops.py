"""Reduction-op vocabulary of the port.

The names and values of ``horovod_tpu/ops/reduce_ops.py`` (the reference's
ReduceOp enum), kept as the port's own copy. Adasum is listed so that the
values match, but its composite is not ported yet: ``allreduce`` raises on
it.
"""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


# Horovod-style module aliases (hvd.Sum, hvd.Average, ...)
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


def check_supported(op) -> ReduceOp:
    try:
        return ReduceOp(op)
    except ValueError:
        raise ValueError(f"Unsupported reduce op: {op!r}") from None
