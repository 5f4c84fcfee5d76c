"""State broadcast: the counterpart of ``horovod_tpu/functions.py``'s
``broadcast_parameters`` (the reference's ``torch/functions.py``).

Not ported yet: ``broadcast_optimizer_state``, ``broadcast_object`` and
``allgather_object`` (ROADMAP A.9).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.utils import tree as tree_util


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
            collectives.broadcast_(t.data, root_rank)
    return params
