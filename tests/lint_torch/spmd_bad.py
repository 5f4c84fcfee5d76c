"""hvdlint-torch fixture: SPMD-consistency violations (HVD1xx) in torch
idiom. NOT imported at runtime; the golden finding list lives in
tests/test_torch_analysis.py."""

import datetime

import torch
import torch.distributed as dist
from torch.distributed import all_reduce

import horovod_tpu_torch as htt
from horovod_tpu_torch.resilience import CheckpointMismatchError


def rank_gated_all_reduce(t):
    # rank 0 reduces; every other rank waits in the next collective
    if dist.get_rank() == 0:
        dist.all_reduce(t)                                  # HVD101
    return t


def leader_only_barrier(step):
    r = htt.rank()
    if r == 0:
        torch.distributed.barrier()                         # HVD101 (taint)
    return step


def store_wait_before_exit(store, key):
    if htt.local_rank() != 0:
        return None                                         # HVD102
    # only local rank 0 reaches the wait for its peers' keys
    store.wait([key], datetime.timedelta(seconds=30))
    return key


def odd_ranks_skip_send(t, peer):
    if dist.get_rank() % 2:
        return t                                            # HVD102
    dist.send(t, peer)
    return t


def set_iteration_order(grads):
    for name in {"w", "b", "scale"}:                        # unordered
        all_reduce(grads[name])                             # HVD103
    return grads


def collective_in_handler(t, path):
    try:
        open(path).read()
    except OSError:
        # only the rank whose read failed broadcasts
        dist.broadcast(t, src=0)                            # HVD105
    return t


def swallow_mismatch(directory):
    try:
        return htt.restore_latest(directory)
    except CheckpointMismatchError:
        return None                                         # HVD106
