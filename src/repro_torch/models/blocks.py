"""Transformer / hybrid block composition.

A block is a pre-norm mixer (attention | MLA | mamba) and a pre-norm FFN
(dense | MoE), both with residual connections; the block kind is a token
of `cfg.block_pattern`.

Under a mesh the residual stream is in its layout (`parallel.sharding`:
split along the sequence over the model dim when it divides, else whole
on every rank).  A normed input is gathered along the sequence for the
mixer (attention, MLA or mamba) and the dense MLP, whose row-parallel
outputs are the rank's terms: they are summed into the residual layout
(a reduce-scatter, or an all-reduce where the residual is whole) before
`x + mix` and `x + f`.  The MoE layer takes and returns the residual
layout itself.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .attention import (apply_attn, apply_mla, init_attn, init_kv_cache,
                        init_mla, init_mla_cache)
from .config import ModelConfig
from .layers import Builder, init_mlp, mlp_residual, rms_norm
from .moe import apply_moe, init_moe
from .ssm import apply_mamba, init_mamba, init_ssm_cache
from ..parallel.sharding import ShardCtx, gather_residual, reduce_residual


def init_block(make: Builder, cfg: ModelConfig, kind: str, moe: bool,
               prefix: str) -> Dict:
    p: Dict = {
        "ln1": make(f"{prefix}.ln1", (cfg.d_model,), ("embed",), 0.0),
        "ln2": make(f"{prefix}.ln2", (cfg.d_model,), ("embed",), 0.0),
    }
    if kind == "m":
        p["mixer"] = init_mamba(make, cfg, f"{prefix}.mamba")
    elif cfg.use_mla:
        p["mixer"] = init_mla(make, cfg, f"{prefix}.mla")
    else:
        p["mixer"] = init_attn(make, cfg, f"{prefix}.attn")
    if moe:
        p["mlp"] = init_moe(make, cfg, f"{prefix}.moe")
    elif cfg.d_ff > 0:
        p["mlp"] = init_mlp(make, cfg.d_model, cfg.d_ff, f"{prefix}.mlp",
                            cfg.gated_mlp)
    else:
        del p["ln2"]            # mixer-only block (mamba2)
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device=None, ctx: Optional[ShardCtx] = None
                     ) -> Dict:
    if kind == "m":
        return init_ssm_cache(cfg, batch, dtype, device, ctx)
    if cfg.use_mla:
        return init_mla_cache(cfg, batch, max_len, dtype, device)
    return init_kv_cache(cfg, batch, max_len, kind, dtype, device, ctx)


def apply_block(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, kind: str, moe: bool,
                ctx: ShardCtx, cache: Optional[Dict] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """x in the residual layout of the sequence `positions` (B, S) spans.
    Returns (x', cache', aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seq = positions.shape[1]
    h = gather_residual(rms_norm(x, p["ln1"], cfg.norm_eps), ctx, seq)
    if kind == "m":
        mix, cache = apply_mamba(p["mixer"], cfg, h, positions, cache, ctx)
    elif cfg.use_mla:
        mix, cache = apply_mla(p["mixer"], cfg, h, positions, cache, ctx)
    else:
        mix, cache = apply_attn(p["mixer"], cfg, h, positions,
                                "l" if kind == "l" else "a", cache, ctx)
    x = x + reduce_residual(mix, ctx)

    if "mlp" not in p:              # mixer-only block (mamba2)
        return x, cache, aux
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe:
        f, aux = apply_moe(p["mlp"], cfg, h, ctx, seq)
    else:
        f = mlp_residual(p["mlp"], h, cfg.act, x.dtype, ctx, seq, cfg.d_ff)
    x = x + f
    return x, cache, aux
