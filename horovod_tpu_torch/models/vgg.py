"""VGG, the counterpart of ``horovod_tpu/models/vgg.py``: the
bandwidth-worst-case workload of Horovod's headline scaling table
(docs/benchmarks.rst:13-14, 68 % at 512 GPUs for VGG-16, whose ~138M
parameters make its gradient allreduce about five times ResNet-50's).

As the JAX model: NHWC activations, HWIO kernels, f32 parameters with
compute in ``dtype``; every conv 3x3 SAME with a bias (flax's
``nn.Conv`` default), optionally followed by batch norm, then ReLU; 2x2
max-pools at ``"M"``; the flatten in NHWC's (H, W, C) order (at 224^2
the first classifier kernel is ``[25088, 4096]``); two hidden dense
layers in ``dtype`` and the head in f32. Modules carry flax's names
(``Conv_i``, ``BatchNorm_i``, ``Dense_i``), so
``resnet.variables_from_numpy`` loads a flax tree by name. Convolutions,
pools and dense layers are PyTorch operators, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import BatchNorm, Conv, Dense
from horovod_tpu_torch.utils.device import resolve_device

# Output channels per conv, 'M' = 2x2 max pool (standard VGG configs).
CFG_11 = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")
CFG_16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")
CFG_19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def max_pool_nhwc(x: torch.Tensor, k: int, s: int,
                  padding: int = 0) -> torch.Tensor:
    """``flax.linen.max_pool`` of NHWC ``x`` (VALID, or a symmetric
    ``padding`` of -inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s, padding=padding)
    return y.permute(0, 2, 3, 1)


class VGG(nn.Module):
    """``forward(x, train)`` takes NHWC images and returns f32 logits.
    ``image`` is the square input size the classifier is built for (flax
    infers it at init); ``in_channels`` the image channels. Parameters
    are drawn on the CPU from ``torch.Generator().manual_seed(seed)`` with
    flax's initializers and moved to ``device`` (``"cuda"`` raises without
    a GPU; ``"meta"`` allocates nothing)."""

    def __init__(self, cfg: Sequence = CFG_16, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 batch_norm: bool = False, classifier_width: int = 4096, *,
                 image: int = 224, in_channels: int = 3, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg, self.dtype, self.batch_norm = tuple(cfg), dtype, batch_norm
        cin, side, i = in_channels, image, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
                continue
            self.add_module(f"Conv_{i}", Conv(cin, int(v), (3, 3),
                                              dtype=dtype, gen=gen,
                                              use_bias=True))
            if batch_norm:
                self.add_module(f"BatchNorm_{i}", BatchNorm(
                    int(v), momentum=0.9, epsilon=1e-5, dtype=dtype))
            cin, i = int(v), i + 1
        dense = partial(Dense, gen=gen)
        self.Dense_0 = dense(side * side * cin, classifier_width, dtype=dtype)
        self.Dense_1 = dense(classifier_width, classifier_width, dtype=dtype)
        self.Dense_2 = dense(classifier_width, num_classes)
        self.to(dev)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = max_pool_nhwc(x, 2, 2)
                continue
            x = getattr(self, f"Conv_{i}")(x)
            if self.batch_norm:
                x = getattr(self, f"BatchNorm_{i}")(x, train)
            x = F.relu(x)
            i += 1
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x).float()


VGG11 = partial(VGG, cfg=CFG_11)
VGG16 = partial(VGG, cfg=CFG_16)
VGG19 = partial(VGG, cfg=CFG_19)
