#!/usr/bin/env python3
"""Parent against change on one card, in one call.

    git archive <parent> | tar -x -C build/parent   # on the host, first
    python3 tools/compare_trees.py build/parent      # on the card
    python3 tools/compare_trees.py build/parent --phases conv,resnet,copy

Runs, in the order parent, change, change, parent (the change is the
checkout this script sits in), one fresh process per tree with that
tree as its working directory and first import path, so each imports
and builds its own ``horovod_tpu_torch``. Every tree is measured by the
change's ``chip_smoke.py``, one yardstick for both, in the phases asked
for (all by default):
  - ``flash``: the paged-decode kernel at its timed geometry (KVH 16 and
    4, ``check_kernel``) and the flash kernels at the flagship's training
    shape (``check_flash``), each held against its plain version first;
  - ``serve``, ``train``: ``serve_flagship`` and ``train_flagship``
    (``serve:``, ``decode profile:``, ``train:``, ``train profile:``);
  - ``conv``: both conv+BN kernels at every distinct 1x1 conv of
    ResNet-50, held to their plain versions, each timed at all 16 and
    summed over a step's 36 launches (``check_conv_all``; the forward also
    in device ms by torch.profiler);
  - ``resnet``: ``train_resnet50`` (``resnet train:`` and ``resnet train
    profile:``, the device and wall step);
  - ``copy``: the stream copy at the probe's shape (``check_stream_copy``).
Each tree prints a ``KERNELS {...}`` line. Needs one NVIDIA GPU.
"""

import importlib.util
import json
import os
import subprocess
import sys

CHANGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


PHASES = ("flash", "serve", "train", "conv", "resnet", "copy")


def run_tree(tree: str, phases) -> None:
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(CHANGE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import stream_copy as sc
    from horovod_tpu_torch.parallel import sequence as sq
    from horovod_tpu_torch.serving import kv_cache as kvc

    card = cs.card_line()
    cs.log("TREE", tree, card)
    cs.log("built in s: " + json.dumps(_build.build_all()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"tree": os.path.basename(tree), "card": card}
    if "flash" in phases:
        for kvh in (16, 4):
            r = cs.check_kernel(fa, kvc, gen, kvh=kvh, dtype=torch.bfloat16,
                                timed=True)
            res[f"paged_kvh{kvh}"] = {k: r[k] for k in (
                "ms", "event_ms", "bound_ms", "library_ms")}
        r = cs.check_flash(fa, sq, gen, b=cs.TRAIN_B, s_q=cs.TRAIN_S,
                           s_k=cs.TRAIN_S, h=16, d=64, dtype=torch.bfloat16,
                           timed=True)
        res["flash"] = {"ms": r["ms"], "library_fwd_ms": r["library_fwd_ms"],
                        "library_bwd_ms": r["library_bwd_ms"]}
    if "conv" in phases:
        timed, _ = cs.check_conv_all(cb, gen)
        res["conv_main"] = {k: timed["main"][k] for k in (
            "fwd_route", "route", "ms", "fwd_device_ms", "plain_ms",
            "gemm_ms", "bounds")}
        for key in ("fwd", "bwd"):
            res[f"conv_{key}_step"] = timed[f"{key}_step"]
            res[f"conv_{key}_ms"] = {sh["shape"]: sh["ms"]
                                     for sh in timed[f"{key}_shapes"]}
        res["conv_fwd_device_ms"] = {sh["shape"]: sh["device_ms"]
                                     for sh in timed["fwd_shapes"]}
    if "copy" in phases:
        r = cs.check_stream_copy(sc, gen)
        res["stream_copy"] = {k: r[k] for k in (
            "ms", "library_ms", "bound_ms")}
    cs.log("KERNELS " + json.dumps(res))
    if "serve" in phases:
        cs.serve_flagship(htt, fa, kvc, card)
    if "train" in phases:
        cs.train_flagship(htt, fa, card)
    if "resnet" in phases:
        cs.train_resnet50(htt, cb, card)
    cs.log("DONE", tree)


def main(argv) -> int:
    phases = ",".join(PHASES)
    if len(argv) >= 2 and argv[-2] == "--phases":
        phases, argv = argv[-1], argv[:-2]
    if any(p not in PHASES for p in phases.split(",")):
        print(__doc__, file=sys.stderr)
        return 2
    if len(argv) == 2 and argv[0] == "--tree":
        run_tree(os.path.abspath(argv[1]), phases.split(","))
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(argv[0])
    for tree in (parent, CHANGE, CHANGE, parent):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree, "--phases", phases])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
