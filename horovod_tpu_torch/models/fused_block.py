"""Fused-BN bottleneck block: the conv+BN kernel path of ResNet.

The counterpart of ``horovod_tpu/models/fused_block.py``. It composes
``ops.conv_bn.conv1x1_bn_stats`` into the v1.5 bottleneck so that batch
norm costs no separate passes over the 1x1 convs' outputs:

- each 1x1 conv emits its output's per-channel sum and sum of squares
  from the kernel's epilogue (the BN statistics pass disappears);
- the 3x3 conv's input is normalized by one elementwise pass (the 3x3
  itself stays a PyTorch convolution);
- the expand conv consumes the RAW 3x3 output and applies normalize+ReLU
  in its kernel's prologue (the normalized activation is never written).

The statistics-to-affine math (mean, var, running statistics, scale,
bias) runs on ``(C,)`` vectors with ``flax.linen.BatchNorm``'s semantics:
biased batch variance in the running update, optional cross-replica sum
(``axis_name``). Parameters have the unfused ``BottleneckBlock``'s shapes
and initializers under flat names (``conv1_kernel``, ``bn1_scale``, ...);
:func:`plain_to_fused_variables` and :func:`fused_to_plain_variables`
convert flax variable trees of numpy arrays between the two layouts.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import Conv, conv_nhwc, lecun_normal_
from horovod_tpu_torch.ops import collectives, conv_bn
from horovod_tpu_torch.utils.tree import flatten_dict, unflatten_dict


def _conv1x1_stats(x, w, inv=None, shift=None, strides=(1, 1)):
    """Every 1x1 conv of the block goes through the fused op. (The JAX
    package routes shapes over its TPU VMEM budget to a plain composition;
    the Hopper gate has no such budget, and on the card a shape it refuses
    raises rather than leave the kernels.)"""
    return conv_bn.conv1x1_bn_stats(x, w, inv, shift, strides=strides)


def channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 per-channel (sum, sum of squares) over all leading dims. (The
    JAX package folds C < 128 channels into the 128 TPU lanes first; the
    sums are the same.)"""
    xf = x.reshape(-1, x.shape[-1]).float()
    return xf.sum(0), (xf * xf).sum(0)


class FusedBottleneckBlock(nn.Module):
    """Drop-in for ``resnet.BottleneckBlock`` (same constructor, same
    parameter shapes and initializers) computing train-mode BN through the
    fused conv+BN kernels. ``norm_kw`` holds the BatchNorm settings the
    ResNet passes its blocks (momentum, epsilon, dtype, axis_name)."""

    def __init__(self, cin: int, filters: int, *,
                 norm_kw: Mapping[str, Any], act: Callable,
                 strides=(1, 1), dtype, gen: torch.Generator):
        super().__init__()
        if act not in (F.relu, torch.relu):
            # The kernel prologue computes ReLU; any other act would be
            # replaced for the middle activation only.
            raise ValueError(
                "FusedBottleneckBlock supports act=relu only (the "
                "normalize+act prologue is fused into the conv kernel); "
                "use fused_conv_bn=False for other activations")
        f = filters
        self.act, self.strides = act, tuple(strides)
        self.momentum = norm_kw.get("momentum", 0.9)
        self.epsilon = norm_kw.get("epsilon", 1e-5)
        self.axis_name = norm_kw.get("axis_name")
        self.dtype = norm_kw.get("dtype") or dtype

        def kernel(ci, co):
            return nn.Parameter(lecun_normal_(torch.empty(1, 1, ci, co), ci,
                                              gen))

        self.conv1_kernel = kernel(cin, f)
        self.conv3_kernel = kernel(f, 4 * f)
        self.needs_proj = cin != 4 * f or self.strides != (1, 1)
        if self.needs_proj:
            self.proj_kernel = kernel(cin, 4 * f)
        self.Conv_0 = Conv(f, f, (3, 3), self.strides, dtype=dtype, gen=gen)
        for name, c in (("bn1", f), ("bn2", f), ("bn3", 4 * f),
                        ("bnp", 4 * f)):
            if name == "bnp" and not self.needs_proj:
                continue
            scale = torch.zeros(c) if name == "bn3" else torch.ones(c)
            setattr(self, f"{name}_scale", nn.Parameter(scale))
            setattr(self, f"{name}_bias", nn.Parameter(torch.zeros(c)))
            self.register_buffer(f"{name}_mean", torch.zeros(c))
            self.register_buffer(f"{name}_var", torch.ones(c))
        self.out_channels = 4 * f

    def _bn(self, name: str, s1, s2, count: float):
        """BN statistics -> the (inv, shift) affine vectors, and the
        running-statistics update (flax BatchNorm's math on (C,) vectors)."""
        if self.axis_name is not None:
            both = collectives.psum(torch.stack([s1, s2]), self.axis_name)
            s1, s2 = both[0], both[1]
            count = count * collectives.axis_size(self.axis_name)
        mean = s1 / count
        var = torch.clamp_min(s2 / count - mean * mean, 0.0)
        ra_mean = getattr(self, f"{name}_mean")
        ra_var = getattr(self, f"{name}_var")
        with torch.no_grad():
            m = self.momentum
            ra_mean.copy_(m * ra_mean + (1 - m) * mean)
            ra_var.copy_(m * ra_var + (1 - m) * var)
        inv = torch.rsqrt(var + self.epsilon) * getattr(self, f"{name}_scale")
        shift = getattr(self, f"{name}_bias") - mean * inv
        return inv, shift

    def _bn_eval(self, name: str):
        """(inv, shift) from the running statistics (eval path)."""
        inv = (torch.rsqrt(getattr(self, f"{name}_var") + self.epsilon)
               * getattr(self, f"{name}_scale"))
        return inv, getattr(self, f"{name}_bias") - getattr(
            self, f"{name}_mean") * inv

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dtype = self.dtype
        x = x.to(dtype)
        if not train:
            return self._eval_path(x)

        # conv1 (reduce): plain input, statistics from the epilogue
        y1, s1a, s1b = _conv1x1_stats(x, self.conv1_kernel.to(dtype))
        n1 = float(y1.shape[0] * y1.shape[1] * y1.shape[2])
        inv1, shift1 = self._bn("bn1", s1a, s1b, n1)
        z1 = self.act(y1 * inv1.to(dtype) + shift1.to(dtype))

        # conv2 (3x3): a PyTorch conv; its BN statistics by one reduce
        y2 = self.Conv_0(z1)
        s2a, s2b = channel_sums(y2)
        n2 = float(y2.shape[0] * y2.shape[1] * y2.shape[2])
        inv2, shift2 = self._bn("bn2", s2a, s2b, n2)

        # conv3 (expand): normalize+ReLU of y2 in the prologue, stats out
        y3, s3a, s3b = _conv1x1_stats(y2, self.conv3_kernel.to(dtype),
                                      inv2, shift2)
        inv3, shift3 = self._bn("bn3", s3a, s3b, n2)

        if self.needs_proj:
            yp, spa, spb = _conv1x1_stats(x, self.proj_kernel.to(dtype),
                                          strides=self.strides)
            invp, shiftp = self._bn("bnp", spa, spb, n2)
            residual = yp * invp.to(dtype) + shiftp.to(dtype)
        else:
            residual = x
        return self.act(y3 * inv3.to(dtype) + shift3.to(dtype) + residual)

    def _eval_path(self, x: torch.Tensor) -> torch.Tensor:
        """Eval: the plain composition over the SAME parameters."""
        dtype = x.dtype

        def conv1x1(v, w, strides=(1, 1)):
            return conv_nhwc(v, w.to(dtype), strides, "VALID")

        inv1, shift1 = self._bn_eval("bn1")
        z1 = self.act(conv1x1(x, self.conv1_kernel) * inv1.to(dtype)
                      + shift1.to(dtype))
        y2 = self.Conv_0(z1)
        inv2, shift2 = self._bn_eval("bn2")
        z2 = self.act(y2 * inv2.to(dtype) + shift2.to(dtype))
        inv3, shift3 = self._bn_eval("bn3")
        y3n = (conv1x1(z2, self.conv3_kernel) * inv3.to(dtype)
               + shift3.to(dtype))
        if self.needs_proj:
            invp, shiftp = self._bn_eval("bnp")
            residual = (conv1x1(x, self.proj_kernel, self.strides)
                        * invp.to(dtype) + shiftp.to(dtype))
        else:
            residual = x
        return self.act(y3n + residual)


# ---------------------------------------------------------------------------
# Checkpoint conversion: fused <-> plain variable trees
# ---------------------------------------------------------------------------
# The fused block flattens its parameters (conv1_kernel, bn1_scale, ...)
# where the plain BottleneckBlock nests submodules (Conv_0/kernel,
# BatchNorm_0/scale, ...). These map between the two layouts of flax-style
# variable trees (nested dicts of numpy arrays): the same arrays, renamed.

def translate_fused_key(key: Tuple[str, ...]) -> Tuple[str, ...]:
    """Fused-model flat variable path -> the plain model's path for the
    SAME array (bijective between the two trees)."""
    bn_map = {"bn1": "BatchNorm_0", "bn2": "BatchNorm_1",
              "bn3": "BatchNorm_2", "bnp": "norm_proj"}
    out: list = []
    for part in key:
        part = part.replace("FusedBottleneckBlock", "BottleneckBlock")
        if part == "conv1_kernel":
            out += ["Conv_0", "kernel"]
        elif part == "conv3_kernel":
            out += ["Conv_2", "kernel"]
        elif part == "proj_kernel":
            out += ["conv_proj", "kernel"]
        elif part == "Conv_0" and "Bottleneck" in "".join(out[-1:]):
            out += ["Conv_1"]          # the fused block's 3x3
        elif "_" in part and part.split("_")[0] in bn_map:
            bn, field = part.split("_", 1)
            out += [bn_map[bn], field]
        else:
            out.append(part)
    return tuple(out)


def plain_to_fused_variables(fused_template: Mapping,
                             plain_vars: Mapping) -> Dict:
    """A fused-model variable tree from a plain-model one:
    ``fused_template`` gives the fused tree's structure (e.g.
    ``resnet.variables_to_numpy(fused_model)``), every leaf is replaced by
    the corresponding array of ``plain_vars``. Raises KeyError naming the
    first unmatched path."""
    flat_plain = flatten_dict(plain_vars)
    out = {}
    for k in flatten_dict(fused_template):
        pk = translate_fused_key(k)
        if pk not in flat_plain:
            raise KeyError(
                f"no plain-model variable {'/'.join(pk)} for fused path "
                f"{'/'.join(k)} — are the two models the same architecture?")
        out[k] = flat_plain[pk]
    return unflatten_dict(out)


def fused_to_plain_variables(plain_template: Mapping,
                             fused_vars: Mapping) -> Dict:
    """Inverse of :func:`plain_to_fused_variables`: a fused-model state in
    the plain model's layout."""
    renamed = {translate_fused_key(k): v
               for k, v in flatten_dict(fused_vars).items()}
    out = {}
    for k in flatten_dict(plain_template):
        if k not in renamed:
            raise KeyError(
                f"no fused-model variable maps to plain path {'/'.join(k)}")
        out[k] = renamed[k]
    return unflatten_dict(out)
