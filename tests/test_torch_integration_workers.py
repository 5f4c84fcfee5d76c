"""Functions and modules that ``tests/test_torch_integrations.py`` ships
to the port's worker pools (``TpuExecutor``, the Ray and Spark doubles).
No tests here. The module imports neither jax nor the JAX package, so a
worker that unpickles one of these by reference starts in seconds."""

import os

import torch
import torch.nn.functional as F
from torch import nn


def world_info():
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.runtime import context
    return (htt.rank(), htt.size(), context.get_context().device.type)


def gather_rank():
    import horovod_tpu_torch as htt
    return htt.allgather_object(htt.rank())


def elastic_worker(log_dir):
    """Generation 0 loses every task abruptly (an executor loss, not a
    user error); generation 1 succeeds."""
    import horovod_tpu_torch as htt
    gen = int(os.environ["HVD_TPU_ELASTIC_GENERATION"])
    if gen == 0:
        os._exit(3)
    with open(os.path.join(log_dir, f"g{gen}.r{htt.rank()}"), "w") as f:
        f.write("ok")
    return (gen, htt.rank(), htt.size())


class TwoLayer(nn.Module):
    """The JAX tests' ``_TwoLayer`` (dense 16, tanh, dense 1, squeezed)."""

    def __init__(self, in_features=6, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.l1 = nn.Linear(in_features, 16)
        self.l2 = nn.Linear(16, 1)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)

    def forward(self, x):
        return self.l2(torch.tanh(self.l1(x)))[..., 0]


def huber_loss(model, batch):
    bx, by = batch
    err = (model(bx) - by).abs()
    return torch.where(err < 1.0, 0.5 * err * err, err - 0.5).mean()


def clipped_sgd(params):
    return torch.optim.SGD(params, lr=5e-2, momentum=0.9)


def decayed_step(model, optimizer, loss_fn, batch):
    """A custom step: the synced gradients plus 1e-4 x the parameters,
    clipped to norm 1, then the inner optimizer's step."""
    loss = loss_fn(batch)
    loss.backward()
    optimizer.synchronize()
    with torch.no_grad():
        for p in model.parameters():
            p.grad.add_(p, alpha=1e-4)
    torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
    optimizer.optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss


def cross_entropy(model, batch):
    bx, by = batch
    return F.cross_entropy(model(bx), by.long())
