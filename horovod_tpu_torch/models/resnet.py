"""ResNet v1.5, the headline training workload of the JAX package
(``horovod_tpu/models/resnet.py``), as ``nn.Module``s.

The JAX model's layout and numerics are kept: activations are NHWC,
convolution kernels HWIO, parameters f32 with compute in ``dtype``
(bf16 by default), batch-norm statistics in f32 with flax's semantics
(:class:`BatchNorm`). Every module is named as flax names it
(``conv_init``, ``bn_init``, ``BottleneckBlock_3``, ``Conv_1``,
``BatchNorm_2``, ``conv_proj``, ``norm_proj``, ``Dense_0``; parameters
``kernel``/``scale``/``bias``, running statistics ``mean``/``var`` as
buffers), so :func:`variables_from_numpy` loads a flax variable tree by
name and :func:`variables_to_numpy` gives one back.

Convolutions outside the fused 1x1 kernels (the 7x7 stem, the 3x3 convs,
the 1x1 convs of the plain blocks), max-pool and the dense head stay
PyTorch operators, as the JAX package leaves them to XLA. A convolution
sees its NHWC input as a channels-last NCHW view (``x.permute(0, 3, 1,
2)``, no copy).

``ResNet(fused_conv_bn=True)`` routes bottleneck blocks to
``models.fused_block.FusedBottleneckBlock``, whose 1x1 convs run the
conv+BN kernels. Not ported: ``space_to_depth`` and ``folded_bn``
(ROADMAP A.14); passing either raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.utils.device import resolve_device
from horovod_tpu_torch.utils.tree import flatten_dict, unflatten_dict


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=gen)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor,
              strides: Sequence[int] = (1, 1), padding: Any = "SAME"
              ) -> torch.Tensor:
    """``flax.linen.Conv(use_bias=False)`` of NHWC ``x`` with an HWIO
    ``kernel`` (cast to x's dtype): padding "SAME", "VALID" or
    ``[(lo, hi), (lo, hi)]``. Returns NHWC."""
    kh, kw = kernel.shape[:2]
    if padding == "SAME":
        pads = [_same_pads(x.shape[1], kh, strides[0]),
                _same_pads(x.shape[2], kw, strides[1])]
    elif padding == "VALID":
        pads = [(0, 0), (0, 0)]
    else:
        pads = [tuple(p) for p in padding]
    xc = x.permute(0, 3, 1, 2)
    w = kernel.permute(3, 2, 0, 1).to(x.dtype)
    (hl, hh), (wl, wh) = pads
    if hl == hh and wl == wh:
        y = F.conv2d(xc, w, stride=tuple(strides), padding=(hl, wl))
    else:
        y = F.conv2d(F.pad(xc, (wl, wh, hl, hh)), w, stride=tuple(strides))
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """``flax.linen.Conv(use_bias=False, dtype=dtype)``: an HWIO kernel."""

    def __init__(self, cin: int, cout: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: Any = "SAME",
                 *, dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        kh, kw = kernel_size
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(kh, kw, cin, cout), kh * kw * cin, gen))
        self.strides, self.padding, self.dtype = tuple(strides), padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x.to(self.dtype), self.kernel, self.strides,
                         self.padding)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the last axis, not torch's.

    Train mode takes ``mean = E[x]`` and ``var = max(0, E[x^2] - E[x]^2)``
    in f32 (with ``axis_name``, the mean over the ranks of the per-rank
    ``E[x]`` and ``E[x^2]``), and moves the running statistics as
    ``ra = momentum * ra + (1 - momentum) * batch`` with the BIASED
    variance (torch keeps the unbiased one and calls 1 - momentum its
    momentum). The output ``(x - mean) * rsqrt(var + eps) * scale + bias``
    is computed in f32 and cast to ``dtype``. Eval mode normalizes with the
    running statistics."""

    def __init__(self, c: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 axis_name: Optional[str] = None, zero_scale: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(c) if zero_scale
                                  else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.momentum, self.epsilon = momentum, epsilon
        self.dtype, self.axis_name = dtype, axis_name

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            mu, mu2 = xf.mean(dims), (xf * xf).mean(dims)
            if self.axis_name is not None:
                both = collectives.psum(torch.stack([mu, mu2]),
                                        self.axis_name)
                both = both / collectives.axis_size(self.axis_name)
                mu, mu2 = both[0], both[1]
            var = torch.clamp_min(mu2 - mu * mu, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mu)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mu, var = self.mean, self.var
        y = (xf - mu) * (torch.rsqrt(var + self.epsilon) * self.scale)
        return (y + self.bias).to(self.dtype or x.dtype)


class Dense(nn.Module):
    """``flax.linen.Dense(dtype=float32)``: kernel ``[in, out]``, bias."""

    def __init__(self, cin: int, cout: int, *, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(cin, cout),
                                                 cin, gen))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel + self.bias


def _norm(c: int, norm_kw: Mapping[str, Any],
          zero_scale: bool = False) -> BatchNorm:
    return BatchNorm(c, zero_scale=zero_scale, **norm_kw)


class ResNetBlock(nn.Module):
    """Basic two-conv residual block (resnet18/34)."""

    def __init__(self, cin: int, filters: int, *, norm_kw, act: Callable,
                 strides=(1, 1), dtype, gen):
        super().__init__()
        conv = partial(Conv, dtype=dtype, gen=gen)
        self.Conv_0 = conv(cin, filters, (3, 3), strides)
        self.BatchNorm_0 = _norm(filters, norm_kw)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = _norm(filters, norm_kw, zero_scale=True)
        self.needs_proj = cin != filters or tuple(strides) != (1, 1)
        if self.needs_proj:
            self.conv_proj = conv(cin, filters, (1, 1), strides)
            self.norm_proj = _norm(filters, norm_kw)
        self.act = act
        self.out_channels = filters

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = self.act(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = (self.norm_proj(self.conv_proj(x), train)
                    if self.needs_proj else x)
        return self.act(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck (resnet50/101/152), v1.5."""

    def __init__(self, cin: int, filters: int, *, norm_kw, act: Callable,
                 strides=(1, 1), dtype, gen):
        super().__init__()
        conv = partial(Conv, dtype=dtype, gen=gen)
        self.Conv_0 = conv(cin, filters, (1, 1))
        self.BatchNorm_0 = _norm(filters, norm_kw)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = _norm(filters, norm_kw)
        self.Conv_2 = conv(filters, 4 * filters, (1, 1))
        self.BatchNorm_2 = _norm(4 * filters, norm_kw, zero_scale=True)
        self.needs_proj = cin != 4 * filters or tuple(strides) != (1, 1)
        if self.needs_proj:
            self.conv_proj = conv(cin, 4 * filters, (1, 1), strides)
            self.norm_proj = _norm(4 * filters, norm_kw)
        self.act = act
        self.out_channels = 4 * filters

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = self.act(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.act(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = (self.norm_proj(self.conv_proj(x), train)
                    if self.needs_proj else x)
        return self.act(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 with the JAX model's options. ``forward(x, train)``
    takes NHWC images and returns f32 logits; in train mode the batch
    norms use batch statistics and advance their running statistics in
    place.

    - ``bn_cross_replica_axis``: batch-norm statistics summed over the
      ranks when that axis is bound (sync batch norm; the trainer binds it
      with ``data_parallel_train_step(bind_axis=True)``).
    - ``fused_conv_bn``: bottleneck blocks run as ``FusedBottleneckBlock``
      (the 1x1 conv+BN kernels), in ``fused_stages`` (1-based; None = all).
    - ``in_channels``: the image channels (flax infers them at init).
    - ``device``/``seed``: parameters are drawn on the CPU from
      ``torch.Generator().manual_seed(seed)`` with flax's initializers,
      then moved; ``device="cuda"`` raises without a GPU."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 act: Callable = F.relu,
                 bn_cross_replica_axis: Optional[str] = None,
                 space_to_depth: bool = False, folded_bn: bool = False,
                 fused_conv_bn: bool = False,
                 fused_stages: Optional[Tuple[int, ...]] = None, *,
                 in_channels: int = 3, device="cuda", seed: int = 0):
        super().__init__()
        if space_to_depth or folded_bn:
            raise NotImplementedError(
                "space_to_depth and folded_bn are not yet ported to "
                "horovod_tpu_torch (ROADMAP A.14)")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype, self.act = dtype, act
        norm_kw = dict(momentum=0.9, epsilon=1e-5, dtype=dtype,
                       axis_name=bn_cross_replica_axis)
        self.conv_init = Conv(in_channels, num_filters, (7, 7), (2, 2),
                              [(3, 3), (3, 3)], dtype=dtype, gen=gen)
        self.bn_init = _norm(num_filters, norm_kw)
        fused_cls = None
        if fused_conv_bn:
            if block_cls is not BottleneckBlock:
                raise ValueError("fused_conv_bn supports bottleneck "
                                 "architectures (resnet50/101/152)")
            from horovod_tpu_torch.models.fused_block import (
                FusedBottleneckBlock)
            fused_cls = FusedBottleneckBlock
        self.block_names = []
        counts: Dict[str, int] = {}
        cin = num_filters
        for i, block_size in enumerate(stage_sizes):
            stage_fused = fused_cls is not None and (
                fused_stages is None or (i + 1) in fused_stages)
            cls = fused_cls if stage_fused else block_cls
            for j in range(block_size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                block = cls(cin, num_filters * 2 ** i, norm_kw=norm_kw,
                            act=act, strides=strides, dtype=dtype, gen=gen)
                name = f"{cls.__name__}_{counts.get(cls.__name__, 0)}"
                counts[cls.__name__] = counts.get(cls.__name__, 0) + 1
                self.add_module(name, block)
                self.block_names.append(name)
                cin = block.out_channels
        self.Dense_0 = Dense(cin, num_classes, gen=gen)
        self.to(dev)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self.act(self.bn_init(self.conv_init(x), train))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1)
        x = x.permute(0, 2, 3, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.float().mean(dim=(1, 2)).to(self.dtype)
        return self.Dense_0(x)


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)


# ---------------------------------------------------------------------------
# flax variable trees <-> the module
# ---------------------------------------------------------------------------

def variables_from_numpy(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a flax variable tree (``{"params": ..., "batch_stats": ...}``
    of numpy arrays, e.g. ``jax.tree.map(np.asarray, model.init(...))``)
    into ``model`` by name, in place: ``params`` go to parameters,
    ``batch_stats`` to buffers, every array exactly (kernels stay HWIO).
    Raises KeyError naming a path with no counterpart, either way."""
    tables = {"params": dict(model.named_parameters()),
              "batch_stats": dict(model.named_buffers())}
    extra = set(variables) - set(tables)
    if extra:
        raise KeyError(f"unknown variable collections {sorted(extra)}")
    for coll, table in tables.items():
        seen = set()
        for path, arr in flatten_dict(variables.get(coll, {})).items():
            name = ".".join(path)
            if name not in table:
                raise KeyError(f"{coll}/{'/'.join(path)} has no counterpart "
                               f"in {type(model).__name__}")
            a = np.asarray(arr)
            t = table[name]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{coll}/{'/'.join(path)}: shape "
                                 f"{a.shape} != the model's "
                                 f"{tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.tensor(a))
            seen.add(name)
        missing = set(table) - seen
        if missing:
            raise KeyError(f"{coll}: no variable for "
                           f"{sorted(missing)[:5]} (of {len(missing)})")
    return model


def variables_to_numpy(model: nn.Module) -> Dict[str, Dict]:
    """The inverse of :func:`variables_from_numpy`: a flax-layout variable
    tree of numpy arrays (f32, kernels HWIO)."""
    return {coll: unflatten_dict({
        tuple(name.split(".")): t.detach().cpu().numpy().copy()
        for name, t in items})
        for coll, items in (("params", model.named_parameters()),
                            ("batch_stats", model.named_buffers()))}
