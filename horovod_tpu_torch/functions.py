"""State broadcast: the counterpart of ``horovod_tpu/functions.py``
(the reference's ``torch/functions.py``): ``broadcast_parameters``,
``broadcast_optimizer_state``, ``broadcast_object`` and
``allgather_object``.

The objects travel pickled, as ``uint8`` tensors on the runtime's device,
their sizes first, so they work in any world size; each rank gets its own
copy (the JAX package's single-process shortcut returns ``[obj]`` because
it has one process).
"""

from __future__ import annotations

import pickle
from typing import Any, List, Optional

import torch
from torch import nn

from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.runtime.context import get_context
from horovod_tpu_torch.utils import tree as tree_util


def _broadcast_tensor_(t: torch.Tensor, root_rank: int) -> None:
    """In place; a tensor off the runtime's device (NCCL cannot move a
    CPU tensor) goes through a copy on it."""
    dev = get_context().device
    if t.device == dev:
        collectives.broadcast_(t, root_rank)
    else:
        t.copy_(collectives.broadcast_(t.to(dev), root_rank))


def broadcast_parameters(params: Any, root_rank: int = 0) -> Any:
    """Make every rank's state root's, in place, so all ranks start
    identical: every parameter AND buffer of an ``nn.Module`` (the
    running statistics of batch norm included), or every leaf of a
    nested dict of tensors. Returns ``params``."""
    if isinstance(params, nn.Module):
        tensors = list(params.parameters()) + list(params.buffers())
    else:
        tensors = tree_util.tree_leaves(params)
    with torch.no_grad():
        for t in tensors:
            _broadcast_tensor_(t.data, root_rank)
    return params


class _TensorSpec:
    """A state tensor as root describes it to the other ranks."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype
        self.on_cpu = t.device.type == "cpu"


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> Any:
    """Make every rank's optimizer state root's (ref torch/functions.py:62):
    a ``torch.optim.Optimizer`` (or a wrapper with ``.optimizer``, such as
    ``DistributedOptimizer``) gets root's per-parameter state, keys,
    shapes and values, and root's hyperparameters in every param group,
    including state that only root has (a rank that never stepped gets
    it created, with root's values). A tree of tensors is broadcast as
    :func:`broadcast_parameters` does. Returns ``optimizer``."""
    opt = getattr(optimizer, "optimizer", optimizer)
    if not isinstance(opt, torch.optim.Optimizer):
        return broadcast_parameters(optimizer, root_rank)
    params = [p for g in opt.param_groups for p in g["params"]]
    spec = {i: {k: _TensorSpec(v) if torch.is_tensor(v) else v
                for k, v in opt.state[p].items()}
            for i, p in enumerate(params) if opt.state.get(p)}
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in opt.param_groups]
    spec, groups = broadcast_object((spec, groups), root_rank)
    for g, options in zip(opt.param_groups, groups):
        g.update(options)
    with torch.no_grad():
        for i, p in enumerate(params):
            if i not in spec:
                opt.state.pop(p, None)
                continue
            state = opt.state[p]
            for k in [k for k in state if k not in spec[i]]:
                del state[k]
            for k, v in spec[i].items():
                if not isinstance(v, _TensorSpec):
                    state[k] = v
                    continue
                t = state.get(k)
                if not (torch.is_tensor(t) and tuple(t.shape) == v.shape
                        and t.dtype == v.dtype):
                    t = torch.zeros(v.shape, dtype=v.dtype, device=(
                        "cpu" if v.on_cpu else p.device))
                    state[k] = t
                _broadcast_tensor_(t, root_rank)
    return optimizer


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """Root's ``obj`` on every rank (ref torch/functions.py:166): pickled
    to a ``uint8`` tensor, its size broadcast first, then the bytes."""
    del name
    ctx = get_context()
    dev = ctx.device
    if ctx.rank == root_rank:
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                   dtype=torch.uint8).to(dev)
        size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    collectives.broadcast_(size, root_rank)
    if ctx.rank != root_rank:
        payload = torch.empty(int(size.item()), dtype=torch.uint8,
                              device=dev)
    collectives.broadcast_(payload, root_rank)
    if ctx.rank == root_rank:
        return obj
    return pickle.loads(payload.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None) -> List[Any]:
    """Every rank's ``obj``, in rank order (ref torch/functions.py:218):
    pickled, gathered with the uneven allgather (sizes first), unpickled."""
    del name
    dev = get_context().device
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8).to(dev)
    sizes = collectives.allgather(torch.tensor(
        [payload.numel()], dtype=torch.int64, device=dev)).tolist()
    data = collectives.allgather(payload).cpu().numpy()
    out, off = [], 0
    for n in sizes:
        out.append(pickle.loads(data[off:off + n].tobytes()))
        off += n
    return out
