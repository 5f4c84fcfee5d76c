"""Lane-folded batch norm, the counterpart of
``horovod_tpu/models/folded_bn.py``.

For NHWC input with ``C`` dividing ``lane_width`` (128 by default) the
JAX module takes its train-mode statistics through the free reshape
``(N, H, W, C) -> (N, H, W/k, k*C)`` (k = lane_width / C, when k divides
W): the f32 sums run over that folded view, and channel c's sum is the
sum of lanes ``c, c+C, ..., c+(k-1)C``. The normalize applies the
per-channel affine tiled k times. The fold is a layout idea of the TPU's
128-wide vector lanes; the port keeps it so that its f32 reductions
associate as the JAX module's do, and the card's cost of it against
:class:`~horovod_tpu_torch.models.resnet.BatchNorm` is measured
(``chip_smoke.py`` phase 11).

The rules are the JAX module's, which differ from ``resnet.BatchNorm``
in where the normalize is computed: ``inv = rsqrt(var + eps) * scale``
and ``shift = bias - mean * inv`` in f32, cast to the compute dtype, and
``x * inv + shift`` in that dtype. Running statistics move as flax's,
with the biased batch variance.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from horovod_tpu_torch.ops import collectives


class FoldedBatchNorm(nn.Module):
    """Batch norm over the last axis through the lane-folded view:
    parameters ``scale`` and ``bias``, running ``mean`` and ``var``
    buffers. ``forward(x, train)``: train mode normalizes with the batch
    statistics (summed over the ranks of ``axis_name`` when it is bound,
    with ``n`` grown by the axis size) and advances the running
    statistics in place; eval mode normalizes with the running ones."""

    def __init__(self, c: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 axis_name: Optional[str] = None, zero_scale: bool = False,
                 lane_width: int = 128):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(c) if zero_scale
                                  else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.momentum, self.epsilon = momentum, epsilon
        self.dtype, self.axis_name = dtype, axis_name
        self.lane_width = lane_width

    def fold(self, x: torch.Tensor, train: bool) -> int:
        """The fold factor k for ``x`` (1: no fold)."""
        c = x.shape[-1]
        k = self.lane_width // c if c and self.lane_width % c == 0 else 1
        ok = k > 1 and x.ndim >= 2 and train and x.shape[-2] % k == 0
        return k if ok else 1

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        c = x.shape[-1]
        x = x.to(self.dtype or x.dtype)
        k = self.fold(x, train)
        folded = tuple(x.shape[:-2]) + (x.shape[-2] // k, k * c)
        if train:
            n = x.numel() // c
            xf = x.reshape(folded).float()
            dims = tuple(range(xf.ndim - 1))
            sums = xf.sum(dims).reshape(k, c).sum(0)
            sqs = (xf * xf).sum(dims).reshape(k, c).sum(0)
            if self.axis_name is not None:
                both = collectives.psum(torch.stack([sums, sqs]),
                                        self.axis_name)
                sums, sqs = both[0], both[1]
                n = n * collectives.axis_size(self.axis_name)
            mean = sums / n
            var = torch.clamp_min(sqs / n - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        shift = (self.bias - mean * inv).to(x.dtype)
        inv = inv.to(x.dtype)
        if k > 1:
            y = x.reshape(folded) * inv.repeat(k) + shift.repeat(k)
            return y.reshape(x.shape)
        return x * inv + shift
