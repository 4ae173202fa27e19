"""Mixture-of-Experts parameters and capacity math, the init half.  The
dispatch and combine (the all2all traffic the schedule co-simulates)
arrive with the model forward (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import math
from typing import Dict

from .config import ModelConfig
from .layers import Builder, init_mlp


def init_moe(make: Builder, cfg: ModelConfig, prefix: str) -> Dict:
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    p = {
        "router": make(f"{prefix}.router", (d, e), ("embed", "experts"), 1.0),
        # expert weights: the contracted dims keep their own logical
        # axis (embed_e), the FFN dim shards (mlp_e), as in the
        # reference's layout
        "wi": make(f"{prefix}.wi", (e, d, f),
                   ("experts", "embed_e", "mlp_e"), 1.0),
        "wg": make(f"{prefix}.wg", (e, d, f),
                   ("experts", "embed_e", "mlp_e"), 1.0),
        "wo": make(f"{prefix}.wo", (e, f, d),
                   ("experts", "mlp_e", "embed_e"), 1.0),
    }
    if cfg.moe_shared:
        p["shared"] = init_mlp(make, d, cfg.moe_shared * f,
                               f"{prefix}.shared")
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    """Per-expert buffer slots for `tokens` routed tokens: the top-k
    share times the capacity factor, rounded up to a multiple of 8 (at
    least 8)."""
    c = int(math.ceil(tokens * cfg.moe_topk / cfg.moe_experts
                      * cfg.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)
