"""Flagship Transformer LM: parameter tree and norm of the PyTorch port.

The counterpart of ``horovod_tpu/models/transformer.py`` for serving:
the same configuration fields, the same parameter tree (keys, shapes,
stacked ``[L, ...]`` layer leaves) and the same RMSNorm, so a JAX
parameter tree carries across leaf for leaf (:func:`params_from_numpy`).
The training forward, ``logits_fn`` and ``loss_fn`` come with the
training slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

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
    remat: bool = True
    mlp_recompute: bool = True
    ce_block_vocab: Optional[int] = None
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
