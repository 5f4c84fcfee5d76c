"""Inception V3, the counterpart of ``horovod_tpu/models/inception.py``:
the third workload of Horovod's headline scaling table (90 % at 512 GPUs,
docs/benchmarks.rst:13-14).

The standard topology (torchvision's channel plan) as the JAX model has
it: NHWC, f32 parameters with compute in ``dtype``, f32 batch-norm
statistics (epsilon 1e-3, synced over ``bn_cross_replica_axis`` in train
mode), no auxiliary head, 3x3/1 SAME average pools that count the
padding in their divisor (flax's ``avg_pool`` default), the VALID
stride-2 convs and max-pools, branches concatenated on the last axis in
the JAX order, and an f32 head. Modules carry flax's names
(``BasicConv_i``, ``InceptionA_0`` ..., ``Conv_0``/``BatchNorm_0`` inside
each ``BasicConv``, ``Dense_0``). Convolutions and pools are PyTorch
operators, as the JAX package leaves them to XLA. The smallest input the
topology takes is 75^2.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import BatchNorm, Conv, Dense
from horovod_tpu_torch.models.vgg import max_pool_nhwc
from horovod_tpu_torch.utils.device import resolve_device


def _box3(x: torch.Tensor) -> torch.Tensor:
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, padding=1,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)


class _AvgPoolSame(torch.autograd.Function):
    """The 3x3/1 average pool with the zero padding counted is its own
    adjoint (stride 1, a symmetric window, a constant divisor of 9), so
    the backward pools the incoming gradient with the forward operator.
    PyTorch's own backward of this pool on a channels-last CUDA view
    (torch 2.11, CUDA 12.8, on an H100) gives gradients that do not match
    the CPU's, while its forward does; the card test
    ``test_cuda_inception_avg_pool_gradient_matches_the_cpu`` holds this
    one against the CPU."""

    @staticmethod
    def forward(ctx, x):
        return _box3(x)

    @staticmethod
    def backward(ctx, g):
        return _box3(g)


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")``
    of NHWC ``x``: the zero padding counts in the divisor."""
    return _AvgPoolSame.apply(x)


class BasicConv(nn.Module):
    """conv (no bias) + batch norm + ReLU (torchvision's BasicConv2d)."""

    def __init__(self, cin: int, features: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: Any = "SAME",
                 *, norm_kw: Dict[str, Any], dtype, gen):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, strides, padding,
                           dtype=dtype, gen=gen)
        self.BatchNorm_0 = BatchNorm(features, **norm_kw)
        self.out_channels = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x), train))


class _Block(nn.Module):
    """A module of ``BasicConv_i`` children, numbered in creation order
    (flax's call order). The branches hold them in plain lists, so each
    is registered once, under its flax name."""

    def __init__(self, norm_kw, dtype, gen):
        super().__init__()
        self._conv_kw = dict(norm_kw=norm_kw, dtype=dtype, gen=gen)
        self._n = 0

    def conv(self, cin, features, kernel, strides=(1, 1), padding="SAME"):
        m = BasicConv(cin, features, kernel, strides, padding,
                      **self._conv_kw)
        self.add_module(f"BasicConv_{self._n}", m)
        self._n += 1
        return m


class InceptionA(_Block):
    def __init__(self, cin: int, pool_features: int, **kw):
        super().__init__(**kw)
        c = self.conv
        self.b1 = [c(cin, 64, (1, 1))]
        self.b5 = [c(cin, 48, (1, 1)), c(48, 64, (5, 5))]
        self.b3 = [c(cin, 64, (1, 1)), c(64, 96, (3, 3)), c(96, 96, (3, 3))]
        self.bp = [c(cin, pool_features, (1, 1))]
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x, train):
        return torch.cat([_chain(self.b1, x, train), _chain(self.b5, x, train),
                          _chain(self.b3, x, train),
                          _chain(self.bp, avg_pool_same(x), train)], dim=-1)


class InceptionB(_Block):
    def __init__(self, cin: int, **kw):
        super().__init__(**kw)
        c = self.conv
        self.b3 = [c(cin, 384, (3, 3), (2, 2), "VALID")]
        self.bd = [c(cin, 64, (1, 1)), c(64, 96, (3, 3)),
                   c(96, 96, (3, 3), (2, 2), "VALID")]
        self.out_channels = 384 + 96 + cin

    def forward(self, x, train):
        return torch.cat([_chain(self.b3, x, train), _chain(self.bd, x, train),
                          max_pool_nhwc(x, 3, 2)], dim=-1)


class InceptionC(_Block):
    def __init__(self, cin: int, channels_7x7: int, **kw):
        super().__init__(**kw)
        c, c7 = self.conv, channels_7x7
        self.b1 = [c(cin, 192, (1, 1))]
        self.b7 = [c(cin, c7, (1, 1)), c(c7, c7, (1, 7)), c(c7, 192, (7, 1))]
        self.bd = [c(cin, c7, (1, 1)), c(c7, c7, (7, 1)), c(c7, c7, (1, 7)),
                   c(c7, c7, (7, 1)), c(c7, 192, (1, 7))]
        self.bp = [c(cin, 192, (1, 1))]
        self.out_channels = 4 * 192

    def forward(self, x, train):
        return torch.cat([_chain(self.b1, x, train), _chain(self.b7, x, train),
                          _chain(self.bd, x, train),
                          _chain(self.bp, avg_pool_same(x), train)], dim=-1)


class InceptionD(_Block):
    def __init__(self, cin: int, **kw):
        super().__init__(**kw)
        c = self.conv
        self.b3 = [c(cin, 192, (1, 1)), c(192, 320, (3, 3), (2, 2), "VALID")]
        self.b7 = [c(cin, 192, (1, 1)), c(192, 192, (1, 7)),
                   c(192, 192, (7, 1)), c(192, 192, (3, 3), (2, 2), "VALID")]
        self.out_channels = 320 + 192 + cin

    def forward(self, x, train):
        return torch.cat([_chain(self.b3, x, train), _chain(self.b7, x, train),
                          max_pool_nhwc(x, 3, 2)], dim=-1)


class InceptionE(_Block):
    def __init__(self, cin: int, **kw):
        super().__init__(**kw)
        c = self.conv
        self.b1 = [c(cin, 320, (1, 1))]
        self.b3 = [c(cin, 384, (1, 1))]
        self.b3_split = [c(384, 384, (1, 3)), c(384, 384, (3, 1))]
        self.bd = [c(cin, 448, (1, 1)), c(448, 384, (3, 3))]
        self.bd_split = [c(384, 384, (1, 3)), c(384, 384, (3, 1))]
        self.bp = [c(cin, 192, (1, 1))]
        self.out_channels = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x, train):
        b3 = _chain(self.b3, x, train)
        bd = _chain(self.bd, x, train)
        return torch.cat([_chain(self.b1, x, train)]
                         + [m(b3, train) for m in self.b3_split]
                         + [m(bd, train) for m in self.bd_split]
                         + [_chain(self.bp, avg_pool_same(x), train)],
                         dim=-1)


def _chain(convs, x, train):
    for m in convs:
        x = m(x, train)
    return x


class InceptionV3(nn.Module):
    """``forward(x, train)`` takes NHWC images (299^2 as published, 75^2
    at the least) and returns f32 logits. Parameters are drawn on the CPU
    from ``torch.Generator().manual_seed(seed)`` with flax's initializers
    and moved to ``device`` (``"cuda"`` raises without a GPU; ``"meta"``
    allocates nothing)."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_cross_replica_axis: Optional[str] = None, *,
                 in_channels: int = 3, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        # BatchNorm syncs over its axis in train mode only
        kw = dict(norm_kw=dict(momentum=0.9, epsilon=1e-3, dtype=dtype,
                               axis_name=bn_cross_replica_axis),
                  dtype=dtype, gen=gen)
        stem = [(32, (3, 3), (2, 2), "VALID"), (32, (3, 3), (1, 1), "VALID"),
                (64, (3, 3), (1, 1), "SAME"), None,
                (80, (1, 1), (1, 1), "VALID"), (192, (3, 3), (1, 1), "VALID"),
                None]
        cin = in_channels
        for i, spec in enumerate(s for s in stem if s):
            m = BasicConv(cin, *spec, **kw)
            self.add_module(f"BasicConv_{i}", m)
            cin = m.out_channels
        self._stem = stem
        blocks = [("InceptionA_0", InceptionA, dict(pool_features=32)),
                  ("InceptionA_1", InceptionA, dict(pool_features=64)),
                  ("InceptionA_2", InceptionA, dict(pool_features=64)),
                  ("InceptionB_0", InceptionB, {}),
                  ("InceptionC_0", InceptionC, dict(channels_7x7=128)),
                  ("InceptionC_1", InceptionC, dict(channels_7x7=160)),
                  ("InceptionC_2", InceptionC, dict(channels_7x7=160)),
                  ("InceptionC_3", InceptionC, dict(channels_7x7=192)),
                  ("InceptionD_0", InceptionD, {}),
                  ("InceptionE_0", InceptionE, {}),
                  ("InceptionE_1", InceptionE, {})]
        self.block_names = []
        for name, cls, extra in blocks:
            m = cls(cin, **extra, **kw)
            self.add_module(name, m)
            self.block_names.append(name)
            cin = m.out_channels
        self.Dense_0 = Dense(cin, num_classes, gen=gen)
        self.to(dev)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        i = 0
        for spec in self._stem:
            if spec is None:
                x = max_pool_nhwc(x, 3, 2)
                continue
            x = getattr(self, f"BasicConv_{i}")(x, train)
            i += 1
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.float().mean(dim=(1, 2)).to(self.dtype)
        return self.Dense_0(x)
