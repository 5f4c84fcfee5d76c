"""Numerics of the model zoo's f32 train-mode path on a CUDA card, against
an f64 reference on the CPU. Run from the repository root on a machine
with a GPU:

    python3 tools/zoo_numerics.py

1. ``conv``: a 5x5 (pad 2) and a 3x3 (pad 1) convolution on NHWC tensors,
   through the route ``resnet.conv_nhwc`` takes (a channels-last view),
   through NCHW-contiguous tensors, with cuDNN off, and with cuDNN's
   ``fp32_precision = "ieee"``, at batch 2 and 8: the output's, the input
   gradient's and the weight gradient's largest difference from the f64
   CPU result, relative to its largest value.
2. ``inception``: Inception V3 (seed 3) in train mode, its stem whole at
   75^2 and each of its InceptionA-E blocks at ``chip_smoke.py``'s
   sizes, on seeded inputs of batch 2, on the card and on the CPU in f32,
   each against the CPU in f64: the largest relative gradient difference,
   the leaf where it is, and the pre-ReLU batch-norm outputs whose sign
   differs from f64's.

Prints one JSON line per case, then the card's name and power limit."""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def conv_case(rng, n, side, cin, cout, k):
    x = rng.standard_normal((n, side, side, cin))
    w = rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)
    g = rng.standard_normal((n, side, side, cout))

    def run(dev, dtype, route):
        xd = torch.from_numpy(x).to(dev, dtype).requires_grad_(True)
        wd = torch.from_numpy(w).to(dev, dtype).requires_grad_(True)
        xc, wc = xd.permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1)
        if route == "nchw_contiguous":
            xc, wc = xc.contiguous(), wc.contiguous()
        ctx = contextlib.nullcontext()
        if route == "cudnn_off":
            ctx = torch.backends.cudnn.flags(enabled=False)
        if route == "ieee":
            torch.backends.cudnn.conv.fp32_precision = "ieee"
        with ctx:
            y = F.conv2d(xc, wc, padding=k // 2).permute(0, 2, 3, 1)
            (y * torch.from_numpy(g).to(dev, dtype)).sum().backward()
        if route == "ieee":
            torch.backends.cudnn.conv.fp32_precision = "none"
        return y, xd.grad, wd.grad

    ref = run("cpu", torch.float64, "channels_last_view")
    out = {"case": f"conv {k}x{k} {cin}->{cout} batch {n} at {side}^2"}
    for dev, route in (("cpu", "channels_last_view"),
                       ("cuda", "channels_last_view"),
                       ("cuda", "nchw_contiguous"), ("cuda", "cudnn_off"),
                       ("cuda", "ieee")):
        got = run(dev, torch.float32, route)
        out[f"{dev} {route}"] = {name: rel(a, b) for name, a, b in zip(
            ("y", "dx", "dw"), got, ref)}
    return out


def inception_parts(ref):
    """(label, forward(model, x), modules(model), input shape, seed): the
    stem whole, then each block at chip_smoke.INCEPTION_BLOCK_SIDE."""
    from chip_smoke import INCEPTION_BLOCK_SIDE
    from horovod_tpu_torch.models import inception

    def stem(m, x):
        i = 0
        for spec in m._stem:
            if spec is None:
                x = inception.max_pool_nhwc(x, 3, 2)
                continue
            x = getattr(m, f"BasicConv_{i}")(x, True)
            i += 1
        return x

    parts = [("stem whole", stem,
              lambda m: [getattr(m, f"BasicConv_{i}") for i in range(5)],
              (2, 75, 75, 3), 100)]
    cin = ref.BasicConv_4.out_channels
    for j, name in enumerate(ref.block_names):
        side = INCEPTION_BLOCK_SIDE[name[len("Inception")]]
        # the seed of this block's inputs in chip_smoke.py (seven stem
        # parts come first there)
        parts.append((name, lambda m, x, n=name: getattr(m, n)(x, True),
                      lambda m, n=name: [getattr(m, n)],
                      (2, side, side, cin), 107 + j))
        cin = getattr(ref, name).out_channels
    return parts


def inception_case(models, label, fn, mods, shape, seed):
    from horovod_tpu_torch.models import resnet
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w, runs = None, {}
    for key, (dev, dtype) in (("f64", ("cpu", torch.float64)),
                              ("cpu", ("cpu", torch.float32)),
                              ("cuda", ("cuda", torch.float32))):
        m = models[key]
        pre = {}
        hooks = [mod.register_forward_hook(
            lambda mod, inp, out, n=f"{i}.{n}": pre.__setitem__(
                n, out.detach().cpu()))
            for i, part in enumerate(mods(m))
            for n, mod in part.named_modules()
            if isinstance(mod, resnet.BatchNorm)]
        xd = torch.from_numpy(x).to(dev, dtype).requires_grad_(True)
        y = fn(m, xd)
        if w is None:
            w = rng.standard_normal(tuple(y.shape)).astype(np.float32)
        (y * torch.from_numpy(w).to(dev, dtype)).sum().backward()
        for h in hooks:
            h.remove()
        grads = {f"{i}.{n}": p.grad for i, part in enumerate(mods(m))
                 for n, p in part.named_parameters()}
        grads["dx"] = xd.grad
        runs[key] = (pre, grads)
    pre64, g64 = runs["f64"]
    out = {"case": f"inception {label}", "shape": list(shape)}
    for key in ("cpu", "cuda"):
        pre, grads = runs[key]
        worst = max((rel(grads[n], g64[n]), n) for n in g64)
        out[key] = {"gradients_vs_f64": worst[0], "worst_leaf": worst[1],
                    "relu_sign_flips_vs_f64": int(sum(
                        int(((pre[n] > 0) != (pre64[n] > 0)).sum())
                        for n in pre64))}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("zoo_numerics: needs a CUDA card", file=sys.stderr)
        return 2
    from horovod_tpu_torch.models import inception
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"torch": torch.__version__,
                      "cudnn": torch.backends.cudnn.version(),
                      "device": torch.cuda.get_device_name(0)}))
    rng = np.random.default_rng(0)
    for n, side, cin, cout, k in ((2, 9, 48, 64, 5), (2, 7, 48, 64, 5),
                                  (2, 35, 48, 64, 5), (8, 9, 48, 64, 5),
                                  (2, 9, 64, 96, 3)):
        print(json.dumps(conv_case(rng, n, side, cin, cout, k)))
    models = {key: inception.InceptionV3(num_classes=10, dtype=dtype,
                                         device=dev, seed=3)
              for key, dev, dtype in (("f64", "cpu", torch.float64),
                                      ("cpu", "cpu", torch.float32),
                                      ("cuda", "cuda", torch.float32))}
    for label, fn, mods, shape, seed in inception_parts(models["f64"]):
        print(json.dumps(inception_case(models, label, fn, mods, shape,
                                        seed)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
