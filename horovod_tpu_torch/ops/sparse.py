"""Sparse gradient allreduce over the allgather, as the reference does it.

The counterpart of ``horovod_tpu/ops/sparse.py`` (l.24-59; the
reference's torch/mpi_ops.py:567 ``sparse_allreduce_async``): every rank
gathers every rank's (indices, values) and adds them into a dense tensor.
Per rank: rank r passes its own ``values`` ``[nnz_r, ...]`` and
``indices`` ``[nnz_r]``; the nnz may differ between ranks (the
allgather's uneven form).
"""

from __future__ import annotations

from typing import Tuple

import torch

from horovod_tpu_torch.ops import collectives


def sparse_allreduce(values: torch.Tensor, indices: torch.Tensor,
                     dense_first_dim: int, average: bool = True,
                     process_set=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dense, counts)``: the dense ``[dense_first_dim, ...]`` sum (or,
    with ``average``, the sum over the number of ranks) of every rank's
    rows ``values[j]`` at rows ``indices[j]``, and the int32 count of
    contributions per row. With ``process_set`` the gather runs in this
    rank's group of the set's size-uniform partition."""
    if process_set is not None and process_set.process_set_id != 0:
        world = len(process_set.ranks)
    else:
        world = collectives.get_context().size
    flat_vals = collectives.allgather(values, process_set=process_set)
    flat_idx = collectives.allgather(indices, process_set=process_set).long()
    dense = flat_vals.new_zeros((dense_first_dim,) + flat_vals.shape[1:])
    dense.index_add_(0, flat_idx, flat_vals)
    if average:
        dense = dense / world
    counts = torch.zeros(dense_first_dim, dtype=torch.int32,
                         device=flat_idx.device)
    counts.index_add_(0, flat_idx, torch.ones_like(flat_idx,
                                                   dtype=torch.int32))
    return dense, counts
