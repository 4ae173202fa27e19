"""Transformer / hybrid block parameters, the init half.

A block is a pre-norm mixer (attention | MLA | mamba) and a pre-norm FFN
(dense | MoE); the block kind is a token of `cfg.block_pattern`.  The
block's forward arrives with the model forward (ROADMAP queue 1
item 8).
"""
from __future__ import annotations

from typing import Dict

from .attention import init_attn, init_mla
from .config import ModelConfig
from .layers import Builder, init_mlp
from .moe import init_moe
from .ssm import init_mamba


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
