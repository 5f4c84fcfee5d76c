"""hvdlint-torch fixture: SPMD-clean torch code — zero findings
expected."""

import datetime

import torch
import torch.distributed as dist

import horovod_tpu_torch as htt


def uniform_all_reduce(t):
    dist.all_reduce(t)
    if dist.get_rank() == 0:
        print("sum:", t)         # gate only the host-side consumption
    return t


def rank_dependent_argument(t):
    # a rank-dependent VALUE; every rank issues the call
    dist.broadcast(t, src=0 if dist.get_rank() >= 0 else 1)
    return t


def local_copies_on_rank_zero(t, devices):
    # torch.cuda.comm.broadcast copies to this process's own cards: a
    # torch function, not a torch.distributed collective
    if dist.get_rank() == 0:
        return torch.cuda.comm.broadcast(t, devices)
    return [t]


def mask_not_branch(x):
    keep = torch.where(torch.tensor(htt.rank()) == 0, x, torch.zeros_like(x))
    return htt.allreduce(keep)


def sorted_iteration(grads):
    for name in sorted({"w", "b", "scale"}):
        dist.all_reduce(grads[name])
    return grads


def leader_writes_then_all_wait(store, key, value):
    if dist.get_rank() == 0:
        store.set(key, value)    # a write blocks nobody
    store.wait([key], datetime.timedelta(seconds=30))
    return store.get(key)
