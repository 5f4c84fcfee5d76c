"""DistributedOptimizer: gradients averaged over the ranks before each
update.

The counterpart of ``horovod_tpu/parallel/distributed.py``
(``allreduce_gradients`` l.646, ``DistributedOptimizer`` l.809; the
reference's ``torch/optimizer.py``). The JAX package wraps an optax
transformation; the port wraps a ``torch.optim.Optimizer``: ``step()``
first syncs the ``.grad`` of every parameter through
``trainer.sync_gradients`` (one fused allreduce per dtype over the
default process group: NCCL on the card, gloo on the CPU), then runs the
inner optimizer's step.

Not ported yet (ROADMAP A.6): gradient compression and the wire codec,
``backward_passes_per_step > 1``, the reverse-backward bucket plan with
hook-overlapped allreduces, and the epilogue optimizers. Asking for any of
them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from horovod_tpu_torch.ops.reduce_ops import ReduceOp, check_supported
from horovod_tpu_torch.parallel.trainer import sync_gradients
from horovod_tpu_torch.runtime import context


class Compression:
    """Gradient compressors by name; only ``none`` is ported."""
    none = "none"
    fp16 = "fp16"
    bf16 = "bf16"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to horovod_tpu_torch (ROADMAP A.6)")


def allreduce_gradients(grads: Iterable[torch.Tensor],
                        op: ReduceOp = ReduceOp.AVERAGE
                        ) -> List[torch.Tensor]:
    """Sum (``op=Sum``) or average (``op=Average``) every gradient over
    the ranks as one fused allreduce per dtype; returns the synced
    tensors in order (views of the reduced buffers)."""
    op = check_supported(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise _not_ported(f"allreduce_gradients with op={op.name}")
    grads = list(grads)
    tree = {f"{i:06d}": g for i, g in enumerate(grads)}
    world = context.size() if op == ReduceOp.AVERAGE else 1
    synced = sync_gradients(tree, {k: ("world",) for k in tree}, world)
    return [synced[k] for k in sorted(tree)]


class DistributedOptimizer:
    """``optimizer`` with its gradients synced over the ranks in
    ``step()``: Horovod's ``hvd.DistributedOptimizer``. The runtime must
    be initialized (``horovod_tpu_torch.init``, NCCL on the card unless
    given ``device="cpu"``); the parameters stay where the model put
    them."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 compression: str = Compression.none,
                 backward_passes_per_step: int = 1,
                 bucket_bytes: Optional[int] = None):
        if compression != Compression.none:
            raise _not_ported(f"gradient compression {compression!r}")
        if backward_passes_per_step != 1:
            raise _not_ported("backward_passes_per_step > 1")
        if bucket_bytes:
            raise _not_ported("the reverse-backward bucket plan")
        op = check_supported(op)
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise _not_ported(f"DistributedOptimizer with op={op.name}")
        self.optimizer, self.op = optimizer, op

    def synchronize(self) -> None:
        """Replace every parameter's ``.grad`` by its sync over the
        ranks."""
        params = [p for group in self.optimizer.param_groups
                  for p in group["params"] if p.grad is not None]
        synced = allreduce_gradients([p.grad for p in params], self.op)
        for p, g in zip(params, synced):
            p.grad = g

    def step(self, closure=None):
        self.synchronize()
        return self.optimizer.step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)
