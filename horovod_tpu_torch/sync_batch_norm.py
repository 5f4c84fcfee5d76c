"""SyncBatchNorm: batch-norm statistics over the global batch of all
ranks.

The counterpart of ``horovod_tpu/sync_batch_norm.py`` (the reference's
torch/sync_batch_norm.py ``SyncBatchNorm``), channels-last ``(..., C)`` as
the port's ResNet is. With per-rank sums s_r, sq_r (in f32) and counts
n_r,

    N = sum_r n_r,  mean = sum_r s_r / N,  var = sum_r sq_r / N - mean^2

which equals batch norm over the concatenated batch for any split of the
rows between ranks (the reference's count-weighted statistics,
sync_batch_norm.py:218). The variance is E[x^2] - mean^2, as in the JAX
package, not Welford's. The three sums cross the ranks in one
:func:`collectives.psum`, which is differentiable (its backward sums the
cotangents over the ranks), so autograd gives the reference's
cross-rank backward. ``psum`` needs ``axis_name`` bound
(``collectives.bind_axis``); the :class:`SyncBatchNorm` module binds it
for its forward when the caller has not.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from horovod_tpu_torch.ops import collectives


def sync_batch_norm_stats(x: torch.Tensor, axis_name: str,
                          reduce_dims: Sequence[int],
                          count=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean, var)`` over the global batch, in f32. ``count`` overrides
    this rank's element count (masked or uneven batches)."""
    reduce_dims = tuple(reduce_dims)
    if count is None:
        count = 1
        for d in reduce_dims:
            count *= x.shape[d]
    n_local = torch.as_tensor(count, dtype=torch.float32,
                              device=x.device).reshape(1)
    s = torch.sum(x, dim=reduce_dims, dtype=torch.float32)
    sq = torch.sum(torch.square(x.float()), dim=reduce_dims)
    c = s.numel()
    both = collectives.psum(torch.cat([s.reshape(-1), sq.reshape(-1),
                                       n_local]), axis_name)
    n = both[2 * c]
    mean = both[:c].reshape(s.shape) / n
    var = both[c:2 * c].reshape(s.shape) / n - torch.square(mean)
    return mean, var


def sync_batch_norm(x: torch.Tensor, axis_name: str,
                    scale: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    epsilon: float = 1e-5, count=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x`` (..., C) normalized with the global batch's statistics over
    ``axis_name``; returns ``(y, mean, var)``, y in x's dtype, so the
    caller can update running statistics."""
    reduce_dims = tuple(range(x.dim() - 1))
    mean, var = sync_batch_norm_stats(x, axis_name, reduce_dims, count)
    y = (x.float() - mean) * torch.rsqrt(var + epsilon)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype), mean, var


class SyncBatchNorm(nn.Module):
    """Batch norm with cross-rank statistics (ref torch SyncBatchNorm):
    ``scale`` and ``bias`` parameters, ``mean``/``var`` running statistics
    updated as ``momentum * running + (1 - momentum) * batch`` (the JAX
    package's flax convention). Training mode (``self.training``, or
    ``use_running_average=False``) uses the global batch's statistics;
    eval mode the running ones, with no communication."""

    def __init__(self, num_features: int, axis_name: str = "hvd",
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 use_scale: bool = True, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.axis_name, self.momentum, self.epsilon = (axis_name, momentum,
                                                       epsilon)
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = (nn.Parameter(torch.ones(num_features, **f32))
                      if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, **f32))
                     if use_bias else None)
        self.register_buffer("mean", torch.zeros(num_features, **f32))
        self.register_buffer("var", torch.ones(num_features, **f32))

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        if use_running_average is None:
            use_running_average = not self.training
        out_dtype = self.dtype or x.dtype
        if use_running_average:
            y = (x.float() - self.mean) * torch.rsqrt(self.var + self.epsilon)
            if self.scale is not None:
                y = y * self.scale
            if self.bias is not None:
                y = y + self.bias
            return y.to(out_dtype)
        bound = self.axis_name in collectives._bound_axes.get()
        with (contextlib.nullcontext() if bound
              else collectives.bind_axis(self.axis_name)):
            y, mean, var = sync_batch_norm(x, self.axis_name, self.scale,
                                           self.bias, self.epsilon)
        with torch.no_grad():
            m = self.momentum
            self.mean.mul_(m).add_((1 - m) * mean)
            self.var.mul_(m).add_((1 - m) * var)
        return y.to(out_dtype)

