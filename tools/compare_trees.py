#!/usr/bin/env python3
"""Parent against change on one card, in one call.

    git archive <parent> | tar -x -C build/parent   # on the host, first
    python3 tools/compare_trees.py build/parent      # on the card

Runs, in the order parent, change, change, parent (the change is the
checkout this script sits in), one fresh process per tree with that
tree as its working directory and first import path, so each imports
and builds its own ``horovod_tpu_torch``. Every tree is measured by the
change's ``chip_smoke.py``, one yardstick for both: the paged-decode
kernel at its timed geometry (KVH 16 and 4, ``check_kernel``) and the
flash kernels at the flagship's training shape (``check_flash``), each
held against its plain version first; then ``serve_flagship`` and
``train_flagship`` (``serve:``, ``decode profile:``, ``train:`` and
``train profile:`` lines). Each tree prints a ``KERNELS {...}`` line.
Needs one NVIDIA GPU.
"""

import importlib.util
import json
import os
import subprocess
import sys

CHANGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tree(tree: str) -> None:
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(CHANGE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import sequence as sq
    from horovod_tpu_torch.serving import kv_cache as kvc

    card = cs.card_line()
    cs.log("TREE", tree, card)
    cs.log("built in s: " + json.dumps(_build.build_all()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"tree": os.path.basename(tree), "card": card}
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
    cs.log("KERNELS " + json.dumps(res))
    cs.serve_flagship(htt, fa, kvc, card)
    cs.train_flagship(htt, fa, card)
    cs.log("DONE", tree)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--tree":
        run_tree(os.path.abspath(argv[1]))
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(argv[0])
    for tree in (parent, CHANGE, CHANGE, parent):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
