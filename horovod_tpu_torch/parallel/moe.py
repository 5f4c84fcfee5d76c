"""Expert parallelism (switch MoE) over a mesh axis: all-to-all dispatch
and combine.

The counterpart of ``horovod_tpu/parallel/moe.py``: a top-1 (switch)
router with capacity-bounded static-shape dispatch, one differentiable
all-to-all over the bound ``ep`` axis each way
(``collectives.all_to_all``), the FFN of the local experts, and the
switch-transformer load-balancing loss. Dispatch and combine are one-hot
einsums, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops import collectives


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor          # load-balancing loss (switch style)
    dropped_fraction: torch.Tensor


def _top1_dispatch(gates: torch.Tensor, capacity: int):
    """Capacity-bounded one-hot dispatch and combine tensors.

    gates ``[T, E]`` router probabilities. Returns (dispatch ``[T, E,
    C]``, combine ``[T, E, C]``, onehot ``[T, E]``, dropped fraction):
    position (t, e, c) means token t occupies slot c of expert e; a token
    past its expert's capacity is dropped."""
    t_count, n_exp = gates.shape
    expert = torch.argmax(gates, dim=-1)                       # [T]
    onehot = F.one_hot(expert, n_exp).float()                  # [T, E]
    # position of each token in its expert's queue
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    kept = (pos < capacity) & (onehot > 0)
    pos_clamped = pos.clamp(0, capacity - 1).long()
    slot = F.one_hot(pos_clamped, capacity).float()            # [T, E, C]
    dispatch = slot * kept[..., None]
    gate_val = (gates * onehot).sum(dim=-1, keepdim=True)      # [T, 1]
    combine = dispatch * gate_val[..., None]
    dropped = 1.0 - dispatch.sum() / max(t_count, 1)
    return dispatch, combine, onehot, dropped


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor, ep_axis: Optional[str] = None,
            capacity_factor: float = 1.25,
            activation=None) -> Tuple[torch.Tensor, MoEMetrics]:
    """Switch-style MoE FFN.

    x ``[B, S, D]`` (any leading dims; flattened to tokens); router_w
    ``[D, E_total]`` (replicated over ``ep``); w_in ``[E_local, D, F]``
    and w_out ``[E_local, F, D]`` this rank's experts. With ``ep_axis``
    bound, E_total = E_local x ep and the tokens go to their experts' ranks
    with one all-to-all each way. ``activation`` defaults to the tanh GELU
    (``jax.nn.gelu``'s default)."""
    if activation is None:
        def activation(h):
            return F.gelu(h, approximate="tanh")
    orig_shape = x.shape
    d_model = x.shape[-1]
    tokens = x.reshape(-1, d_model)                            # [T, D]
    t_count = tokens.shape[0]
    e_local = w_in.shape[0]
    ep = collectives.bound_axis_size(ep_axis) if ep_axis else 1
    e_total = e_local * ep
    if router_w.shape[-1] != e_total:
        raise ValueError(
            f"router has {router_w.shape[-1]} experts, mesh provides "
            f"{e_total} ({e_local} local x ep={ep})")

    logits = tokens.float() @ router_w.float()
    gates = torch.softmax(logits, dim=-1)                      # [T, E]
    capacity = max(1, int(capacity_factor * t_count / e_total))
    dispatch, combine, onehot, dropped = _top1_dispatch(gates, capacity)

    # load-balancing aux loss (Switch Transformer eq. 4)
    aux = e_total * (onehot.mean(dim=0) * gates.mean(dim=0)).sum()

    # [T, E, C] x [T, D] -> [E_total, C, D] expert input buffers
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), tokens)
    if ep_axis:
        # rank j holds inputs for ALL experts from ITS tokens; after the
        # exchange rank k holds its e_local experts' inputs from every
        # rank's tokens
        blocks = expert_in.reshape(ep, e_local, capacity, d_model)
        recv = collectives.all_to_all(blocks, ep_axis, 0, 0)
        expert_in = recv.movedim(0, 1).reshape(e_local, ep * capacity,
                                               d_model)
    h = activation(torch.einsum("ecd,edf->ecf", expert_in,
                                w_in.to(expert_in.dtype)))
    expert_out = torch.einsum("ecf,efd->ecd", h, w_out.to(h.dtype))
    if ep_axis:
        # inverse exchange: each source rank gets its tokens' outputs
        back = expert_out.reshape(e_local, ep, capacity, d_model).movedim(1, 0)
        recv = collectives.all_to_all(back, ep_axis, 0, 0)
        expert_out = recv.reshape(e_total, capacity, d_model)
    out = torch.einsum("tec,ecd->td", combine.to(expert_out.dtype),
                       expert_out)
    return out.reshape(orig_shape), MoEMetrics(aux, dropped)
