"""Mamba2 (SSD, arXiv:2405.21060) mixer parameters, the init half.  The
chunked SSD scan and its decode cache arrive with the model forward
(ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Dict

from .config import ModelConfig
from .layers import Builder


def _groups(cfg: ModelConfig) -> int:
    g = getattr(cfg, "ssm_groups", 1) or 1
    return g


def init_mamba(make: Builder, cfg: ModelConfig, prefix: str) -> Dict:
    d, din = cfg.d_model, cfg.ssm_heads * cfg.ssm_head_dim
    g, n, h = _groups(cfg), cfg.ssm_state, cfg.ssm_heads
    cc = din + 2 * g * n
    return {
        "in_z": make(f"{prefix}.in_z", (d, din), ("embed", "ssm_heads"), 1.0),
        "in_x": make(f"{prefix}.in_x", (d, din), ("embed", "ssm_heads"), 1.0),
        "in_bc": make(f"{prefix}.in_bc", (d, 2 * g * n),
                      ("embed", "ssm_state"), 1.0),
        "in_dt": make(f"{prefix}.in_dt", (d, h), ("embed", "ssm_heads"), 1.0),
        "conv_w": make(f"{prefix}.conv_w", (cfg.conv_width, cc),
                       ("conv", "ssm_heads"), 1.0),
        "conv_b": make(f"{prefix}.conv_b", (cc,), ("ssm_heads",), 0.0),
        "A_log": make(f"{prefix}.A_log", (h,), ("ssm_heads",), 0.0),
        "D": make(f"{prefix}.D", (h,), ("ssm_heads",), 0.0),
        "dt_bias": make(f"{prefix}.dt_bias", (h,), ("ssm_heads",), 0.0),
        "gamma": make(f"{prefix}.gamma", (din,), ("ssm_heads",), 0.0),
        "out": make(f"{prefix}.out", (din, d), ("ssm_heads", "embed"), 1.0),
    }
