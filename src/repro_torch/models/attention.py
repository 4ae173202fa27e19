"""Attention parameters, the init half: full/sliding-window GQA-MQA and
DeepSeek-V2 MLA.  The apply half (chunked attention, the KV caches)
arrives with the model forward (ROADMAP queue 1 item 8); the attention
kernels themselves already sit behind `repro_torch.kernels.ops`.
"""
from __future__ import annotations

from typing import Dict

from .config import ModelConfig
from .layers import Builder


def init_attn(make: Builder, cfg: ModelConfig, prefix: str) -> Dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": make(f"{prefix}.wq", (d, hq, dh), ("embed", "heads", "head"), 1.0),
        "wk": make(f"{prefix}.wk", (d, hkv, dh), ("embed", "kv", "head"), 1.0),
        "wv": make(f"{prefix}.wv", (d, hkv, dh), ("embed", "kv", "head"), 1.0),
        "wo": make(f"{prefix}.wo", (hq, dh, d), ("heads", "head", "embed"), 1.0),
    }
    if cfg.qk_norm:
        p["q_gamma"] = make(f"{prefix}.qg", (dh,), ("head",), 0.0)
        p["k_gamma"] = make(f"{prefix}.kg", (dh,), ("head",), 0.0)
    return p


def init_mla(make: Builder, cfg: ModelConfig, prefix: str) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.nope_head_dim + cfg.rope_head_dim
    return {
        "wq_a": make(f"{prefix}.wq_a", (d, cfg.q_lora), ("embed", "qlora"), 1.0),
        "q_gamma": make(f"{prefix}.qn", (cfg.q_lora,), ("qlora",), 0.0),
        "wq_b": make(f"{prefix}.wq_b", (cfg.q_lora, h, qd),
                     ("qlora", "heads", "head"), 1.0),
        "wkv_a": make(f"{prefix}.wkv_a", (d, cfg.kv_lora + cfg.rope_head_dim),
                      ("embed", "kvlora"), 1.0),
        "kv_gamma": make(f"{prefix}.kvn", (cfg.kv_lora,), ("kvlora",), 0.0),
        "wkv_b": make(f"{prefix}.wkv_b",
                      (cfg.kv_lora, h, cfg.nope_head_dim + cfg.v_head_dim),
                      ("kvlora", "heads", "head"), 1.0),
        "wo": make(f"{prefix}.wo", (h, cfg.v_head_dim, d),
                   ("heads", "head", "embed"), 1.0),
    }
