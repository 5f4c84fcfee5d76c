"""Flagship Transformer LM of the PyTorch port.

The counterpart of ``horovod_tpu/models/transformer.py``: the same
configuration fields, the same parameter tree (keys, shapes, stacked
``[L, ...]`` layer leaves), so a JAX parameter tree carries across leaf
for leaf (:func:`params_from_numpy`), and the same training forward:
RMSNorm, QKV projections, interleaved RoPE, causal flash attention
(``parallel.sequence.local_attention``: the CUDA kernels on the card), a
tanh-GELU MLP, and the blockwise cross-entropy loss.

Every mesh axis of the JAX model is ported (``param_specs``,
``batch_spec``, ``grad_sync_axes``): data (``dp_axis``), tensor
(``tp_axis``: ``parallel.tensor_parallel``), sequence (``sp_axis``: ring
or Ulysses attention, ``parallel.sequence``), expert (``ep_axis`` with
``num_experts``: ``parallel.moe``) and pipeline (``pp_axis``:
``parallel.pipeline``) parallelism. The process model is the port's: one
process per card, each at its position of the mesh ``init(mesh_shape=,
axis_names=)`` builds, holding its shard of every parameter
(:func:`shard_params`) and its block of the batch (:func:`shard_batch`).
``forward``, ``logits_fn`` and ``loss_fn`` run with the configuration's
axes bound (``collectives.bind_axis``), as the JAX functions run inside
``shard_map``; the trainer's steps bind them. An axis that is not bound
raises ``NameError``, as ``lax.psum`` does outside ``shard_map``.

Where the JAX package uses ``jax.checkpoint``, the port uses
``torch.utils.checkpoint``: ``remat=True`` around each layer, and
``mlp_recompute=True`` (with ``remat=False``) around the MLP only, so its
two d_ff-wide activations are recomputed in the backward instead of kept.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel import moe as moe_lib
from horovod_tpu_torch.parallel import pipeline as pp_lib
from horovod_tpu_torch.parallel import sequence as sp_lib
from horovod_tpu_torch.parallel import tensor_parallel as tp_lib
from horovod_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


class P(tuple):
    """A PartitionSpec: one entry per dimension, each None (replicated),
    an axis name, or a tuple of axis names (linearized row-major in that
    order), as ``jax.sharding.PartitionSpec`` has them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    head_dim: int = 64
    n_layers: int = 8
    d_ff: int = 2048
    max_seq: int = 2048
    num_experts: int = 0            # 0 = dense FFN; >0 = switch-MoE
    capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    dtype: Any = torch.bfloat16
    # mesh axis names; None disables that parallelism dimension
    dp_axis: Optional[str] = "dp"
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None
    ep_axis: Optional[str] = None
    pp_axis: Optional[str] = None
    attention: str = "ring"
    n_microbatches: int = 1
    remat: bool = True              # checkpoint each layer
    mlp_recompute: bool = True      # checkpoint the MLP (remat=False)
    ce_block_vocab: Optional[int] = None   # None = HOROVOD_CE_BLOCK_VOCAB
    # The JAX package's lax.scan unroll. The port's layer stack is an
    # eager Python loop, so the field is kept for a shared configuration
    # and has no effect here.
    scan_unroll: int = 1

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Global parameter tree in f32 on ``device``: the keys and shapes of
    the JAX ``init_params``. Normal draws come from ``generator`` (seed 0
    on ``device`` when None); they are not JAX's numbers for the same
    seed, so carry a JAX tree across with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, f, a, v, l = (cfg.d_model, cfg.d_ff, cfg.qkv_dim, cfg.vocab_size,
                     cfg.n_layers)

    def dense(shape, scale_dim):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * (scale_dim ** -0.5)).to(dev)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    params: Params = {
        "embed": dense((v, d), d),
        "final_norm": ones((d,)),
        "head": dense((d, v), d),
        "layers": {
            "attn_norm": ones((l, d)),
            "mlp_norm": ones((l, d)),
            "wq": dense((l, d, a), d),
            "wk": dense((l, d, a), d),
            "wv": dense((l, d, a), d),
            "wo": dense((l, a, d), a),
        },
    }
    if cfg.num_experts:
        e = cfg.num_experts
        params["layers"]["router"] = dense((l, d, e), d)
        params["layers"]["w_in"] = dense((l, e, d, f), d)
        params["layers"]["w_out"] = dense((l, e, f, d), f)
    else:
        params["layers"]["w_in"] = dense((l, d, f), d)
        params["layers"]["w_out"] = dense((l, f, d), f)
    return params


def params_from_numpy(tree: Any, device="cuda",
                      dtype: torch.dtype = torch.float32) -> Params:
    """Carry a parameter tree of numpy arrays (a JAX tree passed through
    ``np.asarray``) across leaf for leaf: same keys, same shapes, the
    stacked ``[L, ...]`` layer leaves kept stacked."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    return conv(tree)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * rms * scale).to(x.dtype)


def param_specs(cfg: TransformerConfig) -> Params:
    """PartitionSpecs of :func:`init_params`'s tree: the layer stack over
    pp, projections over tp, experts over ep, the rest replicated."""
    tp, ep, pp = cfg.tp_axis, cfg.ep_axis, cfg.pp_axis
    specs: Params = {
        "embed": P(tp, None),
        "final_norm": P(None),
        "head": P(None, tp),
        "layers": {
            "attn_norm": P(pp, None),
            "mlp_norm": P(pp, None),
            "wq": P(pp, None, tp),
            "wk": P(pp, None, tp),
            "wv": P(pp, None, tp),
            "wo": P(pp, tp, None),
        },
    }
    if cfg.num_experts:
        specs["layers"]["router"] = P(pp, None, None)
        specs["layers"]["w_in"] = P(pp, ep, None, None)
        specs["layers"]["w_out"] = P(pp, ep, None, None)
    else:
        specs["layers"]["w_in"] = P(pp, None, tp)
        specs["layers"]["w_out"] = P(pp, tp, None)
    return specs


def batch_spec(cfg: TransformerConfig) -> P:
    """tokens/labels ``[B, S]``: batch over dp (and ep: expert
    parallelism carries distinct tokens per ep rank), sequence over sp."""
    batch_axes = tuple(a for a in (cfg.dp_axis, cfg.ep_axis) if a)
    if not batch_axes:
        return P(None, cfg.sp_axis)
    return P(batch_axes if len(batch_axes) > 1 else batch_axes[0],
             cfg.sp_axis)


def mesh_axes(cfg: TransformerConfig) -> Tuple[str, ...]:
    return tuple(a for a in (cfg.dp_axis, cfg.tp_axis, cfg.sp_axis,
                             cfg.ep_axis, cfg.pp_axis) if a)


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def grad_sync_axes(cfg: TransformerConfig) -> Params:
    """Axes each parameter's gradient is summed over: every axis of the
    configuration the leaf is replicated on (all of ``mesh_axes`` minus
    the ones its spec shards it over). With the psums' transposes of the
    step (a psum of the cotangents), each rank's gradient is d(sum of
    every rank's loss)/d(its leaf); the trainer sums it over these axes
    and scales by 1/W, W the product of all the axes."""
    all_axes = mesh_axes(cfg)

    def axes_for(spec: P) -> Tuple[str, ...]:
        used = {a for entry in spec for a in _spec_axes(entry)}
        return tuple(a for a in all_axes if a not in used)

    return _map_specs(axes_for, param_specs(cfg))


# ---------------------------------------------------------------------------
# the mesh: this rank's shards
# ---------------------------------------------------------------------------

def check_mesh(cfg: TransformerConfig) -> None:
    """Raise unless the runtime's mesh has every axis of a configuration
    with more than one (one axis alone may stand for every rank)."""
    from horovod_tpu_torch.runtime.context import get_context
    axes = mesh_axes(cfg)
    mesh = get_context().topology.mesh.shape
    missing = [a for a in axes if a not in mesh]
    if len(axes) > 1 and missing:
        raise ValueError(
            f"axes {missing} of the configuration are not on the mesh "
            f"{dict(mesh)}: initialize with init(mesh_shape=..., "
            f"axis_names={list(axes)})")


def _entry_axes(entry):
    names = _spec_axes(entry)
    return tuple(collectives.axis_of(a) for a in names)


def _shard_leaf(x: torch.Tensor, spec: P) -> torch.Tensor:
    from horovod_tpu_torch.runtime.context import get_context
    ctx = get_context()
    topo = ctx.topology
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = topo.axis_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split over {entry} ({n} ranks)")
        i = topo.axis_rank(ctx.rank, axes)
        blk = x.shape[dim] // n
        x = x.narrow(dim, i * blk, blk)
    return x.contiguous()


def shard_params(cfg: TransformerConfig, params: Params) -> Params:
    """This rank's shard of a GLOBAL parameter tree (``init_params``, or
    a JAX tree through :func:`params_from_numpy`), by ``param_specs`` at
    this rank's mesh position. Needs the runtime initialized."""
    specs = param_specs(cfg)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, s[k]) for k, v in p.items()}
        return _shard_leaf(p, s)
    return walk(params, specs)


def shard_batch(cfg: TransformerConfig, tokens) -> torch.Tensor:
    """This rank's block of a global ``[B, S]`` batch (tokens or labels,
    numpy or a tensor) by ``batch_spec``."""
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(np.ascontiguousarray(tokens))
    return _shard_leaf(tokens, batch_spec(cfg))


def gather_params(cfg: TransformerConfig, params: Params) -> Params:
    """The inverse of :func:`shard_params`: every rank gets the global
    tree (all-gathers over the sharded dims' axes; not differentiable).
    Every rank must call it."""
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.runtime.context import get_context
    ctx = get_context()
    specs = param_specs(cfg)

    def leaf(x, spec):
        x = x.detach()
        for dim, entry in enumerate(spec):
            axes = _entry_axes(entry)
            if axes:
                x = collectives._gather_dim(x, ctx.axis_group(axes), dim)
        return x

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, s[k]) for k, v in p.items()}
        return leaf(p, s)
    return walk(params, specs)


def _rope(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings; x ``[B, S, H, D]``, pos ``[S]`` global
    positions. Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])``
    with f32 angles and stacks them back in place."""
    d = x.shape[-1]
    freqs = 1.0 / (10000.0 ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = pos[:, None].float() * freqs[None, :]                # [S, D/2]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                      dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def _dense_mlp(cfg: TransformerConfig, h: torch.Tensor, w_in: torch.Tensor,
               w_out: torch.Tensor) -> torch.Tensor:
    """Dense FFN: ``gelu(h @ w_in) @ w_out`` with the tanh GELU
    (``jax.nn.gelu``'s default)."""
    u = torch.nn.functional.gelu(tp_lib.column_parallel(h, w_in),
                                 approximate="tanh")
    return tp_lib.row_parallel(u, w_out, cfg.tp_axis)


def _layer(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
           aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer block on local shards: x ``[B, S_local, D]`` in
    cfg.dtype (replicated over tp and ep), lp this layer's local
    parameters, aux the running MoE load-balancing loss."""
    dt = cfg.dtype
    b, s = x.shape[0], x.shape[1]
    sp = cfg.sp_axis
    pos0 = collectives.axis_index(sp) * s if sp else 0
    pos = pos0 + torch.arange(s, device=x.device)
    h = _rmsnorm(x, lp["attn_norm"])
    q = tp_lib.column_parallel(h, lp["wq"].to(dt))
    kk = tp_lib.column_parallel(h, lp["wk"].to(dt))
    vv = tp_lib.column_parallel(h, lp["wv"].to(dt))
    shp = (b, s, q.shape[-1] // cfg.head_dim, cfg.head_dim)  # H / tp heads
    q, kk, vv = (t.reshape(shp) for t in (q, kk, vv))
    q = _rope(q, pos)
    kk = _rope(kk, pos)
    if sp and cfg.attention == "ring":
        o = sp_lib.ring_attention(q, kk, vv, sp, causal=True)
    elif sp and cfg.attention == "ulysses":
        o = sp_lib.ulysses_attention(q, kk, vv, sp, causal=True)
    elif sp:
        raise ValueError(f"attention={cfg.attention!r}: expected 'ring' or "
                         f"'ulysses'")
    else:
        o = sp_lib.local_attention(q, kk, vv, causal=True)
    o = o.reshape(b, s, -1)
    attn_out = tp_lib.row_parallel(o, lp["wo"].to(dt), cfg.tp_axis)
    x = x + attn_out.to(x.dtype)

    h = _rmsnorm(x, lp["mlp_norm"])
    w_in, w_out = lp["w_in"].to(dt), lp["w_out"].to(dt)
    if cfg.num_experts:
        mlp_out, metrics = moe_lib.moe_ffn(
            h, lp["router"], w_in, w_out, ep_axis=cfg.ep_axis,
            capacity_factor=cfg.capacity_factor)
        aux = aux + metrics.aux_loss
    elif cfg.mlp_recompute and not cfg.remat:
        # Keep only the MLP's inputs; the backward recomputes the two
        # d_ff-wide activations from them.
        mlp_out = checkpoint(_dense_mlp, cfg, h, w_in, w_out,
                             use_reentrant=False)
    else:
        mlp_out = _dense_mlp(cfg, h, w_in, w_out)
    return x + mlp_out.to(x.dtype), aux


def _stack_fwd(cfg: TransformerConfig, layers: Params, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local layer stack, leaves ``[L_local, ...]`` (L / pp layers
    under pipeline parallelism). The leaves are unbound once, so the
    backward stacks each leaf's per-layer gradients in one step. Returns
    (x, summed MoE aux loss)."""
    per_layer = {k: v.unbind(0) for k, v in layers.items()}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(layers["wq"].shape[0]):
        lp = {k: v[i] for k, v in per_layer.items()}
        if cfg.remat:
            x, aux = checkpoint(_layer, cfg, lp, x, aux, use_reentrant=False)
        else:
            x, aux = _layer(cfg, lp, x, aux)
    return x, aux


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local-shard forward to the final hidden states (pre-head).

    tokens ``[B_local, S_local]`` int, this rank's block. Returns (hidden
    ``[B, S, D]`` in cfg.dtype, MoE aux loss). The configuration's axes
    must be bound (or all None)."""
    seq_total = tokens.shape[1]
    if cfg.sp_axis:
        seq_total *= collectives.bound_axis_size(cfg.sp_axis)
    if seq_total > cfg.max_seq:
        raise ValueError(f"sequence length {seq_total} exceeds "
                         f"cfg.max_seq={cfg.max_seq}")
    x = tp_lib.vocab_parallel_embed(tokens, params["embed"].to(cfg.dtype),
                                    cfg.tp_axis)
    if cfg.pp_axis:
        m = cfg.n_microbatches
        b = x.shape[0]
        if b % m != 0:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        x_mb = x.reshape((m, b // m) + tuple(x.shape[1:]))

        # The MoE aux loss is dropped under pp, as in the JAX package: it
        # would widen every stage-to-stage send for a regulariser term.
        def stage_fn(mb):
            return _stack_fwd(cfg, params["layers"], mb)[0]

        x = pp_lib.pipeline_apply(stage_fn, x_mb, cfg.pp_axis)
        x = x.reshape((b,) + tuple(x.shape[2:]))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = _stack_fwd(cfg, params["layers"], x)
    x = _rmsnorm(x, params["final_norm"])
    return x, aux


def logits_fn(cfg: TransformerConfig, params: Params,
              tokens: torch.Tensor) -> torch.Tensor:
    """Full f32 logits ``[B, S, V]`` (gathered over tp when sharded)."""
    x, _ = forward(cfg, params, tokens)
    logits = x @ params["head"].to(cfg.dtype)
    if cfg.tp_axis:
        logits = collectives.all_gather(logits, cfg.tp_axis, axis=-1)
    return logits.float()


def loss_fn(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean causal-LM cross entropy over every token of the global batch
    (f32 scalar, equal on every rank): the sum and the count are psummed
    over the data axes (dp, ep, sp, and pp with all but the last stage
    masked)."""
    x, aux = forward(cfg, params, tokens)
    per_tok = tp_lib.vocab_parallel_cross_entropy(
        x, params["head"].to(cfg.dtype), labels, cfg.tp_axis,
        block=cfg.ce_block_vocab)
    tc = torch.stack([per_tok.sum(),
                      torch.full((), float(per_tok.numel()),
                                 device=per_tok.device)])
    data_axes = [a for a in (cfg.dp_axis, cfg.ep_axis, cfg.sp_axis) if a]
    if cfg.pp_axis:
        # x is pp-replicated (the pipeline's outputs broadcast): count
        # each token once, on the last stage. This also zeroes the head's
        # and final norm's cotangents off the last stage, so the uniform
        # grad sync stays exact.
        last = collectives.axis_index(cfg.pp_axis) == \
            collectives.bound_axis_size(cfg.pp_axis) - 1
        tc = torch.where(torch.tensor(last, device=tc.device), tc,
                         torch.zeros_like(tc))
        data_axes.append(cfg.pp_axis)
    for ax in data_axes:
        tc = collectives.psum(tc, ax)
    loss = tc[0] / tc[1]
    if cfg.num_experts:
        aux_mean = aux / max(cfg.n_layers, 1)
        for ax in data_axes:
            aux_mean = collectives.pmean(aux_mean, ax)
        loss = loss + cfg.moe_aux_weight * aux_mean
    return loss


class TransformerLM:
    """Thin wrapper pairing a config with init/apply/loss."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> Params:
        return init_params(self.cfg, generator, device=device)

    def apply(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return logits_fn(self.cfg, params, tokens)

    def loss(self, params: Params, tokens: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        return loss_fn(self.cfg, params, tokens, labels)
