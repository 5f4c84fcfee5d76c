"""hvdlint-torch fixture: trace-safety violations (HVD2xx) inside
torch.compile / torch.jit / CUDA-graph-captured bodies, and a metric
outside the registry namespace. NOT imported at runtime."""

import os
import random
import time

import numpy as np
import torch

from horovod_tpu_torch import metrics as M
from horovod_tpu_torch import tracing as trace


@torch.compile
def step_with_wallclock(x):
    t0 = time.perf_counter()                                # HVD201
    return x * 2, t0


@torch.compile(mode="reduce-overhead")
def step_with_host_rng(x):
    return x + np.random.rand()                             # HVD202


@torch.jit.script
def step_with_env(x):
    return x * float(os.environ["TRAIN_SCALE"])             # HVD203


def capture(step, static_x, graph):
    with torch.cuda.graph(graph):
        print("capturing")                                  # HVD204
        loss = step(static_x)
        value = loss.item()                                 # HVD205
    return value


def make_step():
    def traced(x):
        with trace.span("inner"):                           # HVD206
            return x * random.random()                      # HVD202
    return torch.compile(traced)


def make_adhoc_counter():
    return M.counter("requests_total", "requests served")   # HVD207
