"""The MNIST models, the counterparts of ``horovod_tpu/models/mlp.py``
(Horovod's examples/pytorch/pytorch_mnist.py ``Net`` and
examples/tensorflow2/tensorflow2_keras_mnist.py).

f32 parameters with compute in ``dtype``; modules carry flax's names
(``Dense_i``, ``Conv_i``), so ``resnet.variables_from_numpy`` loads a
flax tree by name. Dropout in train mode draws its mask from the
``torch.Generator`` the caller passes (flax draws it from the
``dropout`` rng the caller passes), keeping ``x / keep`` where the mask
is set.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import Conv, Dense
from horovod_tpu_torch.models.vgg import max_pool_nhwc
from horovod_tpu_torch.utils.device import resolve_device


class MLP(nn.Module):
    """Plain MLP for 28x28 inputs: flatten -> dense stack -> logits (in
    ``dtype``)."""

    def __init__(self, features: Sequence[int] = (128, 64),
                 num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 *, in_features: int = 28 * 28, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        widths = [in_features] + [int(f) for f in features]
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            self.add_module(f"Dense_{i}", Dense(a, b, gen=gen, dtype=dtype))
        self.n_hidden = len(widths) - 1
        self.add_module(f"Dense_{self.n_hidden}",
                        Dense(widths[-1], num_classes, gen=gen, dtype=dtype))
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n_hidden}")(x)


def dropout(x: torch.Tensor, rate: float, train: bool,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """``flax.linen.Dropout(rate, deterministic=not train)`` with its mask
    drawn from ``gen`` (on ``x``'s device)."""
    if not train or rate == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in train mode needs a torch.Generator "
                         "(pass gen=...)")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MnistCNN(nn.Module):
    """The reference's MNIST Net in NHWC: conv 10x5x5 -> max-pool -> conv
    20x5x5 -> dropout -> max-pool -> dense 50 -> dropout -> dense 10.
    ``forward(x, train=False, gen=None)`` takes ``[N, 28, 28]`` or
    ``[N, 28, 28, 1]``; train mode needs ``gen`` for the dropout."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.Conv_0 = Conv(1, 10, (5, 5), padding="VALID", dtype=dtype,
                           gen=gen, use_bias=True)
        self.Conv_1 = Conv(10, 20, (5, 5), padding="VALID", dtype=dtype,
                           gen=gen, use_bias=True)
        self.Dense_0 = Dense(4 * 4 * 20, 50, gen=gen, dtype=dtype)
        self.Dense_1 = Dense(50, num_classes, gen=gen, dtype=dtype)
        self.to(dev)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.ndim == 3:
            x = x[..., None]
        x = x.to(self.dtype)
        x = max_pool_nhwc(F.relu(self.Conv_0(x)), 2, 2)
        x = dropout(self.Conv_1(x), 0.5, train, gen)
        x = max_pool_nhwc(F.relu(x), 2, 2)
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        x = dropout(x, 0.5, train, gen)
        return self.Dense_1(x)
