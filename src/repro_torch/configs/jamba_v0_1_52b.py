"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf ai21labs/Jamba-v0.1]

Period of 8 layers with attention at offset 4 (attn_layer_period=8,
attn_layer_offset=4) and MoE every 2 layers at offset 1
(expert_layer_period=2, expert_layer_offset=1).  The SSM mixer here is the
SSD (Mamba2-style) formulation with Jamba's d_state=16, expand=2
(d_inner=8192 -> 128 heads x 64), 8 B/C groups for TP.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    block_pattern=("m", "m", "m", "m", "a", "m", "m", "m"),
    moe_experts=16,
    moe_topk=2,
    moe_d_ff=14336,
    moe_every=2,
    moe_offset=1,
    ssm_state=16,
    ssm_heads=128,
    ssm_head_dim=64,
    ssm_groups=8,
    conv_width=4,
)
