"""Pipeline parallelism over a mesh axis: GPipe microbatch rotation.

The counterpart of ``horovod_tpu/parallel/pipeline.py``. The stacked
layer leaves are sharded over the ``pp`` axis on their layer dimension,
so each rank holds a contiguous stage; activations go stage to stage with
a differentiable ``collectives.ppermute`` (one neighbour hop a step), and
the microbatches rotate through so every stage computes after the
warm-up (bubble = (pp-1)/(M+pp-1)).

Every rank runs the same steps and issues the same collectives, in the
backward too: which microbatch a stage holds, and whether its output is
kept, are masks (``torch.where``), never Python branches around a
collective, as the JAX package's ``jnp.where`` are.
"""

from __future__ import annotations

from typing import Callable

import torch

from horovod_tpu_torch.ops import collectives


def pipeline_apply(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                   x_microbatches: torch.Tensor,
                   pp_axis: str) -> torch.Tensor:
    """Run a pp-sharded stage function over microbatches.

    stage_fn applies THIS rank's stage to one microbatch ``[mb, ...] ->
    [mb, ...]``; x_microbatches ``[M, mb, ...]`` are every microbatch's
    stage-0 input, replicated over ``pp`` (only stage 0's copy enters).
    Returns ``[M, mb, ...]``, the last stage's outputs on every rank (a
    masked psum broadcasts them).

    Schedule: at step t stage s runs microbatch t - s; T = M + pp - 1
    steps. The last step's send is skipped on every rank: nothing reads
    it (the JAX scan discards it)."""
    pp = collectives.bound_axis_size(pp_axis)
    s_idx = collectives.axis_index(pp_axis)
    axis = collectives.mesh_axis(pp_axis)
    n_micro = x_microbatches.shape[0]
    total_steps = n_micro + pp - 1
    perm = [(i, (i + 1) % pp) for i in range(pp)]
    dev = x_microbatches.device
    first = torch.tensor(s_idx == 0, device=dev)
    slots = torch.arange(n_micro, device=dev)
    bshape = (n_micro,) + (1,) * (x_microbatches.dim() - 1)

    state = torch.zeros_like(x_microbatches[0])
    outputs = torch.zeros_like(x_microbatches)
    for t in range(total_steps):
        fresh = x_microbatches[min(t, n_micro - 1)]
        out = stage_fn(torch.where(first, fresh, state))
        m = t - s_idx
        keep = (slots == m) & (s_idx == pp - 1)       # [M]: all False off
        outputs = torch.where(keep.reshape(bshape), out.unsqueeze(0),
                              outputs)
        if t < total_steps - 1:
            state = collectives.ppermute(out, perm, axis)
    # only the last stage holds real outputs; the others hold zeros
    return collectives.psum(outputs, pp_axis)


def stage_layer_slice(n_layers: int, pp: int) -> int:
    """Layers per stage; n_layers must divide evenly across stages."""
    if n_layers % pp != 0:
        raise ValueError(f"{n_layers} layers not divisible by pp={pp}")
    return n_layers // pp
