"""Compute-side worker main: ``python -m horovod_tpu_torch.data.compute_worker``
(the counterpart of ``horovod_tpu/data/compute_worker.py``).

Reference parity: ``horovod.tensorflow.data.compute_worker`` main
(reference: tensorflow/data/compute_worker.py:26) — each compute process
reads the service config file (waiting for it to appear), resolves its
worker index, and serves its dataset shard until shutdown.

The dataset factory is named as ``module:function`` and must accept
``(worker_index, num_workers)`` and return an iterable of batches.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys


def resolve_dataset_fn(spec: str):
    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit(
            f"--dataset-fn must be 'module:function', got {spec!r}")
    return getattr(importlib.import_module(mod_name), attr)


def main(argv=None) -> int:
    from horovod_tpu_torch.data.compute_service import (ComputeConfig,
                                                  compute_worker_fn)
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.data.compute_worker")
    p.add_argument("configfile", help="ComputeConfig JSON path")
    p.add_argument("--dataset-fn", required=True,
                   help="module:function returning an iterable of batches, "
                        "called as fn(worker_index, num_workers)")
    p.add_argument("--index", type=int, default=None,
                   help="Worker index (default: RANK env)")
    p.add_argument("--size", type=int, default=None,
                   help="Total workers (default: WORLD_SIZE env)")
    args = p.parse_args(argv)

    index = (args.index if args.index is not None
             else int(os.environ.get("RANK", "0")))
    size = (args.size if args.size is not None
            else int(os.environ.get("WORLD_SIZE", "1")))
    config = ComputeConfig.read(args.configfile, wait_for_file_creation=True)
    compute_worker_fn(config, resolve_dataset_fn(args.dataset_fn),
                      index=index, size=size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
