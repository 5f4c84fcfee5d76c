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
conv+BN kernels. ``space_to_depth=True`` replaces the 7x7/s2 stem by the
4x4/s1 conv ``conv_init_s2d`` on the (N, H/2, W/2, 4C) rearranged input;
``folded_bn=True`` takes every batch norm outside the fused blocks
through ``models.folded_bn.FoldedBatchNorm`` (named ``FoldedBatchNorm_i``
in the blocks, as flax names it).

:class:`Conv` and :class:`Dense` are shared with the other models of the
zoo (``vgg``, ``inception``, ``mlp``): ``Conv(use_bias=True)`` is flax's
default ``nn.Conv``, ``Dense(dtype=...)`` computes in that dtype.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.folded_bn import FoldedBatchNorm
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.utils.device import resolve_device
from horovod_tpu_torch.utils.tree import flatten_dict, unflatten_dict


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in. A tensor on the ``meta``
    device (a model built only to count its parameters) is left as it
    is."""
    if t.is_meta:
        return t
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
    """``flax.linen.Conv(use_bias=use_bias, dtype=dtype)``: an HWIO
    kernel, and with ``use_bias`` a zero-initialized ``bias`` added in
    ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: Any = "SAME",
                 *, dtype: torch.dtype, gen: torch.Generator,
                 use_bias: bool = False):
        super().__init__()
        kh, kw = kernel_size
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(kh, kw, cin, cout), kh * kw * cin, gen))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.strides, self.padding, self.dtype = tuple(strides), padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_nhwc(x.to(self.dtype), self.kernel, self.strides,
                      self.padding)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the last axis, not torch's.

    Train mode takes ``mean = E[x]`` and ``var = max(0, E[x^2] - E[x]^2)``
    in f32, or in f64 for f64 input, as flax promotes to at least f32
    (with ``axis_name``, the mean over the ranks of the per-rank
    ``E[x]`` and ``E[x^2]``), and moves the running statistics as
    ``ra = momentum * ra + (1 - momentum) * batch`` with the BIASED
    variance (torch keeps the unbiased one and calls 1 - momentum its
    momentum). The output ``(x - mean) * rsqrt(var + eps) * scale + bias``
    is computed in that type and cast to ``dtype``. Eval mode normalizes with the
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
        xf = x if x.dtype == torch.float64 else x.float()
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
    """``flax.linen.Dense(dtype=dtype)``: kernel ``[in, out]`` and bias,
    f32 parameters, the product and the bias computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, *, gen: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(cin, cout),
                                                 cin, gen))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


def _norm_cls(norm_kw: Mapping[str, Any]) -> type:
    return FoldedBatchNorm if norm_kw.get("folded") else BatchNorm


def _norm(c: int, norm_kw: Mapping[str, Any],
          zero_scale: bool = False) -> nn.Module:
    kw = {k: v for k, v in norm_kw.items() if k != "folded"}
    return _norm_cls(norm_kw)(c, zero_scale=zero_scale, **kw)


def _set_norm(block: nn.Module, i: int, c: int, norm_kw: Mapping[str, Any],
              zero_scale: bool = False) -> None:
    """A block's i-th norm, named as flax names it:
    ``<BatchNorm|FoldedBatchNorm>_<i>``."""
    block.norm_cls = _norm_cls(norm_kw).__name__
    block.add_module(f"{block.norm_cls}_{i}",
                     _norm(c, norm_kw, zero_scale=zero_scale))


def _block_norm(block: nn.Module, i: int) -> nn.Module:
    return getattr(block, f"{block.norm_cls}_{i}")


class ResNetBlock(nn.Module):
    """Basic two-conv residual block (resnet18/34)."""

    def __init__(self, cin: int, filters: int, *, norm_kw, act: Callable,
                 strides=(1, 1), dtype, gen):
        super().__init__()
        conv = partial(Conv, dtype=dtype, gen=gen)
        self.Conv_0 = conv(cin, filters, (3, 3), strides)
        _set_norm(self, 0, filters, norm_kw)
        self.Conv_1 = conv(filters, filters, (3, 3))
        _set_norm(self, 1, filters, norm_kw, zero_scale=True)
        self.needs_proj = cin != filters or tuple(strides) != (1, 1)
        if self.needs_proj:
            self.conv_proj = conv(cin, filters, (1, 1), strides)
            self.norm_proj = _norm(filters, norm_kw)
        self.act = act
        self.out_channels = filters

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = self.act(_block_norm(self, 0)(self.Conv_0(x), train))
        y = _block_norm(self, 1)(self.Conv_1(y), train)
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
        _set_norm(self, 0, filters, norm_kw)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        _set_norm(self, 1, filters, norm_kw)
        self.Conv_2 = conv(filters, 4 * filters, (1, 1))
        _set_norm(self, 2, 4 * filters, norm_kw, zero_scale=True)
        self.needs_proj = cin != 4 * filters or tuple(strides) != (1, 1)
        if self.needs_proj:
            self.conv_proj = conv(cin, 4 * filters, (1, 1), strides)
            self.norm_proj = _norm(4 * filters, norm_kw)
        self.act = act
        self.out_channels = 4 * filters

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = self.act(_block_norm(self, 0)(self.Conv_0(x), train))
        y = self.act(_block_norm(self, 1)(self.Conv_1(y), train))
        y = _block_norm(self, 2)(self.Conv_2(y), train)
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
    - ``space_to_depth``: the 4x4/s1 stem on the (N, H/2, W/2, 4C) input
      (channel order (a, b, c)); odd spatial dims raise ``ValueError``.
    - ``folded_bn``: :class:`FoldedBatchNorm` for ``bn_init`` and the
      plain blocks' norms.
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
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype, self.act = dtype, act
        self.space_to_depth = space_to_depth
        norm_kw = dict(momentum=0.9, epsilon=1e-5, dtype=dtype,
                       axis_name=bn_cross_replica_axis, folded=folded_bn)
        if space_to_depth:
            # the MLPerf stem: any 7x7/s2 conv is this 4x4/s1 conv on the
            # space-to-depth input (a zero-padded 8x8 kernel rearranged)
            self.conv_init_s2d = Conv(4 * in_channels, num_filters, (4, 4),
                                      (1, 1), [(2, 1), (2, 1)], dtype=dtype,
                                      gen=gen)
        else:
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
        if self.space_to_depth:
            n, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(
                    f"space_to_depth stem needs even spatial dims, got "
                    f"{h}x{w} — pad the input or use space_to_depth=False")
            x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
            x = self.conv_init_s2d(x)
        else:
            x = self.conv_init(x)
        x = self.act(self.bn_init(x, train))
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
