"""Flagship Transformer LM of the PyTorch port.

The counterpart of ``horovod_tpu/models/transformer.py``: the same
configuration fields, the same parameter tree (keys, shapes, stacked
``[L, ...]`` layer leaves), so a JAX parameter tree carries across leaf
for leaf (:func:`params_from_numpy`), and the same training forward:
RMSNorm, QKV projections, interleaved RoPE, causal flash attention
(``parallel.sequence.local_attention``: the CUDA kernels on the card), a
tanh-GELU MLP, and the blockwise cross-entropy loss.

Data parallelism (``dp_axis``) is the only parallel axis ported. It needs
nothing inside the model: each rank runs ``loss_fn`` on its own rows and
the trainer allreduces the gradients. ``tp_axis``, ``sp_axis``,
``ep_axis``, ``pp_axis`` and ``num_experts > 0`` raise
``NotImplementedError``.

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

from horovod_tpu_torch.parallel import sequence as sp_lib
from horovod_tpu_torch.parallel import tensor_parallel as tp_lib
from horovod_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


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


_LATER_SLICE = {"tp_axis": "tensor parallelism (slice 3)",
                "sp_axis": "sequence parallelism (slice 4)",
                "ep_axis": "expert parallelism (slice 4)",
                "pp_axis": "pipeline parallelism (slice 4)"}


def _check_parallel(cfg: TransformerConfig) -> None:
    """Raise on a configuration this slice does not run."""
    for field, what in _LATER_SLICE.items():
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r}: {what} is not yet "
                f"ported to horovod_tpu_torch; only dp_axis is")
    if cfg.num_experts:
        raise NotImplementedError(
            "num_experts > 0: the switch-MoE FFN is not yet ported to "
            "horovod_tpu_torch (slice 4)")


def mesh_axes(cfg: TransformerConfig) -> Tuple[str, ...]:
    return tuple(a for a in (cfg.dp_axis, cfg.tp_axis, cfg.sp_axis,
                             cfg.ep_axis, cfg.pp_axis) if a)


def grad_sync_axes(cfg: TransformerConfig) -> Params:
    """Axes each parameter's gradient is summed over: the tree of
    ``init_params`` with a tuple of axis names per leaf. With data
    parallelism alone every leaf is replicated, so every leaf syncs over
    ``dp_axis`` (the whole world)."""
    _check_parallel(cfg)
    axes = mesh_axes(cfg)
    layer_keys = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_in",
                  "w_out")
    return {"embed": axes, "final_norm": axes, "head": axes,
            "layers": {k: axes for k in layer_keys}}


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


def _layer(cfg: TransformerConfig, lp: Params,
           x: torch.Tensor) -> torch.Tensor:
    """One transformer block; x ``[B, S, D]`` in cfg.dtype, lp this
    layer's parameters."""
    dt = cfg.dtype
    b, s = x.shape[0], x.shape[1]
    pos = torch.arange(s, device=x.device)
    h = _rmsnorm(x, lp["attn_norm"])
    q = tp_lib.column_parallel(h, lp["wq"].to(dt))
    kk = tp_lib.column_parallel(h, lp["wk"].to(dt))
    vv = tp_lib.column_parallel(h, lp["wv"].to(dt))
    shp = (b, s, q.shape[-1] // cfg.head_dim, cfg.head_dim)
    q, kk, vv = (t.reshape(shp) for t in (q, kk, vv))
    q = _rope(q, pos)
    kk = _rope(kk, pos)
    o = sp_lib.local_attention(q, kk, vv, causal=True)
    o = o.reshape(b, s, -1)
    attn_out = tp_lib.row_parallel(o, lp["wo"].to(dt), cfg.tp_axis)
    x = x + attn_out.to(x.dtype)

    h = _rmsnorm(x, lp["mlp_norm"])
    w_in, w_out = lp["w_in"].to(dt), lp["w_out"].to(dt)
    if cfg.mlp_recompute and not cfg.remat:
        # Keep only the MLP's inputs; the backward recomputes the two
        # d_ff-wide activations from them.
        mlp_out = checkpoint(_dense_mlp, cfg, h, w_in, w_out,
                             use_reentrant=False)
    else:
        mlp_out = _dense_mlp(cfg, h, w_in, w_out)
    return x + mlp_out.to(x.dtype)


def _stack_fwd(cfg: TransformerConfig, layers: Params,
               x: torch.Tensor) -> torch.Tensor:
    """The layer stack, layer leaves ``[L, ...]``. The leaves are unbound
    once, so the backward stacks each leaf's per-layer gradients in one
    step."""
    per_layer = {k: v.unbind(0) for k, v in layers.items()}
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in per_layer.items()}
        if cfg.remat:
            x = checkpoint(_layer, cfg, lp, x, use_reentrant=False)
        else:
            x = _layer(cfg, lp, x)
    return x


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward to the final hidden states (pre-head).

    tokens ``[B, S]`` int. Returns (hidden ``[B, S, D]`` in cfg.dtype,
    MoE aux loss, always 0 here)."""
    _check_parallel(cfg)
    if tokens.shape[1] > cfg.max_seq:
        raise ValueError(f"sequence length {tokens.shape[1]} exceeds "
                         f"cfg.max_seq={cfg.max_seq}")
    x = tp_lib.vocab_parallel_embed(tokens, params["embed"].to(cfg.dtype),
                                    cfg.tp_axis)
    x = _stack_fwd(cfg, params["layers"], x)
    x = _rmsnorm(x, params["final_norm"])
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(cfg: TransformerConfig, params: Params,
              tokens: torch.Tensor) -> torch.Tensor:
    """Full f32 logits ``[B, S, V]``."""
    x, _ = forward(cfg, params, tokens)
    return (x @ params["head"].to(cfg.dtype)).float()


def loss_fn(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean causal-LM cross entropy over this rank's tokens (f32 scalar).

    The JAX function psums the sum and the count over the data axes to
    return the global mean; here the trainer averages the per-rank means
    over the ranks, which is the same number when every rank holds the
    same number of tokens."""
    x, _ = forward(cfg, params, tokens)
    per_tok = tp_lib.vocab_parallel_cross_entropy(
        x, params["head"].to(cfg.dtype), labels, cfg.tp_axis,
        block=cfg.ce_block_vocab)
    return per_tok.sum() / per_tok.numel()


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
