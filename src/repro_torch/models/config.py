"""Model configuration for every assigned architecture family.

A single ``ModelConfig`` covers dense / GQA / MQA / MLA transformers, MoE
(top-k routed + shared experts), Mamba2-SSD layers, hybrid interleaves
(Jamba) and local:global sliding-window patterns (Gemma-3).

The layer stack is expressed as ``prefix`` layers (unstacked, e.g. the first
dense layer of DeepSeek-V2) followed by ``n_periods`` repetitions of
``block_pattern`` whose parameters are stacked along a leading period axis.

Block pattern tokens:
  'a' full (global) causal attention
  'l' sliding-window (local) causal attention
  'g' explicit global attention (synonym of 'a'; used in local:global mixes)
  'm' Mamba2 (SSD) mixer
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- activations / norms ---
    act: str = "silu"                 # 'silu' (SwiGLU) | 'gelu' (GeGLU)
    gated_mlp: bool = True            # False: plain 2-matmul FFN
    norm_eps: float = 1e-6
    qk_norm: bool = False
    logit_softcap: float = 0.0        # gemma-style final-logit softcapping

    # --- attention pattern ---
    block_pattern: Tuple[str, ...] = ("a",)
    n_prefix_layers: int = 0          # unstacked leading layers (dense MLP)
    window: int = 4096                # sliding window for 'l' layers
    rope_base: float = 10000.0

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 0
    moe_shared: int = 0               # number of shared (always-on) experts
    moe_d_ff: int = 0                 # per-expert intermediate size
    moe_every: int = 1                # MoE on pattern positions where
    moe_offset: int = 0               # (pos % moe_every) == moe_offset
    capacity_factor: float = 1.25
    router_scale: float = 1.0         # routed-output scaling (DeepSeek)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4
    ssm_expand: int = 2

    # --- embeddings / head ---
    tie_embeddings: bool = False
    frontend: str = "none"            # 'none' | 'audio' | 'vision'
    frontend_tokens: int = 0          # prepended continuous-embedding tokens

    # --- numerics / execution ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"               # 'none' | 'full' | 'dots'
    attn_chunk: int = 1024            # kv-block size for chunked attention
    loss_chunk: int = 512             # seq-block size for chunked CE
    scan_layers: bool = True
    # Unroll inner lax.scan loops (attention KV blocks, SSD chunks, CE
    # chunks) — used by the dry-run so HLO cost_analysis counts every
    # iteration (scan bodies are otherwise counted once).
    unroll_loops: bool = False

    # ------------------------------------------------------------------
    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_scanned(self) -> int:
        return self.n_layers - self.n_prefix_layers

    @property
    def n_periods(self) -> int:
        n, p = self.n_scanned, self.pattern_len
        if n % p:
            raise ValueError(f"{self.name}: {n} scanned layers not divisible "
                             f"by pattern of {p}")
        return n // p

    def is_moe_pos(self, pos: int) -> bool:
        """MoE predicate for a position inside the block pattern."""
        if self.moe_experts == 0:
            return False
        return (pos % self.moe_every) == self.moe_offset

    @property
    def d_inner(self) -> int:         # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def is_hybrid(self) -> bool:
        return "m" in self.block_pattern and any(
            t in self.block_pattern for t in ("a", "l", "g"))

    @property
    def is_attention_free(self) -> bool:
        return set(self.block_pattern) == {"m"} and self.n_prefix_layers == 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k decode: no unbounded full-attention KV,
        or the full-attention share is bounded (hybrid / local:global)."""
        toks = set(self.block_pattern)
        if toks == {"m"}:
            return True
        if "m" in toks:               # hybrid: bounded attention share
            return True
        if "l" in toks:               # local:global sliding window mix
            return True
        return False

    def validate(self) -> None:
        assert self.n_prefix_layers + self.n_periods * self.pattern_len == \
            self.n_layers
        if any(t in self.block_pattern for t in ("a", "l", "g")) or \
                self.n_prefix_layers:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.moe_experts:
            assert 0 < self.moe_topk <= self.moe_experts
            assert self.moe_d_ff > 0
        if "m" in self.block_pattern:
            assert self.ssm_state > 0 and self.ssm_heads > 0

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        pat = self.block_pattern
        small = dict(
            n_layers=max(self.n_prefix_layers, 0) + 2 * len(pat),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab=256,
            window=32,
            attn_chunk=32,
            ssm_chunk=16,
            remat="none",
        )
        if self.use_mla:
            small.update(q_lora=32, kv_lora=32, rope_head_dim=8,
                         nope_head_dim=16, v_head_dim=16)
        if self.moe_experts:
            small.update(moe_experts=4, moe_topk=min(self.moe_topk, 2),
                         moe_shared=min(self.moe_shared, 1), moe_d_ff=64)
        if self.ssm_heads:
            small.update(ssm_heads=4, ssm_head_dim=8, ssm_state=16,
                         ssm_groups=min(self.ssm_groups, 2))
        if self.frontend_tokens:
            small.update(frontend_tokens=8)
        small.update(overrides)
        return dataclasses.replace(self, **small)
