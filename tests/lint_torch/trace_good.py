"""hvdlint-torch fixture: trace-safe torch code — zero findings
expected."""

import re
import time

import torch

from horovod_tpu_torch import metrics as M
from horovod_tpu_torch import tracing as trace

PATTERN = re.compile(r"hvd_[a-z_]+")    # re.compile traces nothing


@torch.compile
def clean_step(x, gen):
    # device RNG from a seeded generator
    return x + torch.randn(x.shape, generator=gen, device=x.device)


def host_loop(step, batches):
    # host code may do host things: only traced bodies are scanned
    t0 = time.time()
    for i, b in enumerate(batches):
        with trace.span("train.step", attrs={"step": i}):
            step(b)
    print("took", time.time() - t0)


def capture_then_read(step, static_x, graph):
    with torch.cuda.graph(graph):
        loss = step(static_x)
    graph.replay()
    return loss.item()          # after the capture, on the host


def make_counter():
    return M.counter("hvd_requests_total", "requests served")
