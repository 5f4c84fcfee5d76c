"""The matmul precision knob of the train steps.

The counterpart of ``jit_step``'s ``HOROVOD_TPU_MATMUL_PRECISION`` in
``horovod_tpu/parallel/trainer.py``, which runs each step under
``jax.default_matmul_precision``. Here a step runs inside
:func:`matmul_precision`, which sets torch's CUDA flags on entry and
restores the caller's on exit:

- ``float32`` / ``highest`` / ``F32_F32_F32``: IEEE f32 products and
  convolutions (``allow_tf32`` off for cuBLAS and cuDNN);
- ``tensorfloat32`` / ``high`` / ``TF32_TF32_F32``: TF32 for both;
- ``bfloat16`` / ``BF16_BF16_F32``: bf16 inputs with f32 accumulation.
  torch has no CUDA flag for that, so the port's own f32 products (the
  blockwise cross-entropy's, ``ops/blockwise_ce.py``, which reads
  :func:`current` in its forward and keeps the answer for its backward)
  take bf16 inputs; cuBLAS's other f32 products and cuDNN's convolutions
  take the nearest flag, TF32.

``default`` changes nothing (``jit_step`` skips it as well). Names that
``jax.default_matmul_precision`` refuses are refused with ``ValueError``
when the step is built; dot-algorithm presets JAX accepts but torch has
no flag for (f8, f16, the bf16 multi-pass ones, f64) raise
``NotImplementedError`` there. ``torch.set_float32_matmul_precision`` is
never called: it reaches CPU products through oneDNN, and CPU products
stay IEEE f32 at every setting. The hand-written kernels ignore the knob,
as Pallas kernels ignore JAX's.

The cuBLAS and cuDNN flags are process-wide in torch: they hold for the
duration of each step only, and a step that raises restores them too
(autograd's device threads, which run the backward, see them). While a
step runs they hold for every thread of the process, so a serving
replica's thread (``serving/fleet.py``) in the same process runs its f32
products and convolutions in TF32 meanwhile; a step built under a
non-default setting while a serving fleet is live logs a warning saying
so. Only the bf16 mode of the port's own products, which
:func:`current` reads, is per thread.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.precision")

# The names jax.default_matmul_precision accepts (JAX 0.9's enum: the
# precision names and the dot-algorithm presets).
JAX_PRECISION_NAMES = (
    "default", "high", "highest", "bfloat16", "tensorfloat32", "float32",
    "ANY_F8_ANY_F8_F32", "ANY_F8_ANY_F8_F32_FAST_ACCUM",
    "ANY_F8_ANY_F8_ANY", "ANY_F8_ANY_F8_ANY_FAST_ACCUM", "F16_F16_F16",
    "F16_F16_F32", "BF16_BF16_BF16", "BF16_BF16_F32", "BF16_BF16_F32_X3",
    "BF16_BF16_F32_X6", "BF16_BF16_F32_X9", "TF32_TF32_F32",
    "TF32_TF32_F32_X3", "F32_F32_F32", "F64_F64_F64")

# JAX name -> the port's mode ('ieee', 'tf32' or 'bf16'); 'default' is
# None (nothing changes).
MODES = {
    "default": None,
    "float32": "ieee", "highest": "ieee", "F32_F32_F32": "ieee",
    "tensorfloat32": "tf32", "high": "tf32", "TF32_TF32_F32": "tf32",
    "bfloat16": "bf16", "BF16_BF16_F32": "bf16",
}

_local = threading.local()


def resolve(name: Optional[str]) -> Optional[str]:
    """The mode of a precision name: None for 'default' (or empty),
    else 'ieee', 'tf32' or 'bf16'."""
    if name is None or name == "":
        return None
    if name not in JAX_PRECISION_NAMES:
        raise ValueError(
            f"HOROVOD_TPU_MATMUL_PRECISION={name!r}: not a name "
            f"jax.default_matmul_precision accepts "
            f"{list(JAX_PRECISION_NAMES)}")
    if name not in MODES:
        raise NotImplementedError(
            f"HOROVOD_TPU_MATMUL_PRECISION={name!r}: torch has no CUDA "
            f"flag for this dot algorithm; use one of "
            f"{sorted(k for k in MODES)}")
    return MODES[name]


def current() -> Optional[str]:
    """This thread's mode inside a step (None outside one, or under
    'default')."""
    return getattr(_local, "mode", None)


@contextlib.contextmanager
def matmul_precision(name: Optional[str]):
    """Run the body under ``name``'s flags, restoring the caller's on
    exit (also when the body raises)."""
    mode = resolve(name)
    if mode is None:
        yield
        return
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32, current())
    tf32 = mode != "ieee"
    mm.allow_tf32 = tf32
    cudnn.allow_tf32 = tf32
    _local.mode = mode
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved[0], saved[1]
        _local.mode = saved[2]


def _warn_if_serving(name: str) -> None:
    """Warn that the flags reach a live serving fleet's threads."""
    import sys
    fleet = sys.modules.get("horovod_tpu_torch.serving.fleet")
    if fleet is not None and fleet.active_fleet() is not None:
        logger.warning(
            "HOROVOD_TPU_MATMUL_PRECISION=%s: the TF32 flags are "
            "process-wide while a step runs, so the serving fleet in this "
            "process runs its f32 products and convolutions in TF32 "
            "meanwhile", name)


def wrap_step(step: Callable, name: Optional[str] = None) -> Callable:
    """``step`` run under HOROVOD_TPU_MATMUL_PRECISION (or ``name``),
    read and checked now, when the step is built; 'default' returns
    ``step`` itself."""
    if name is None:
        from horovod_tpu_torch.config import knobs
        name = knobs.get("HOROVOD_TPU_MATMUL_PRECISION")
    if resolve(name) is None:
        return step
    _warn_if_serving(name)

    def run(*args, **kw):
        with matmul_precision(name):
            return step(*args, **kw)

    run.__wrapped__ = step
    run.__doc__ = step.__doc__
    return run
