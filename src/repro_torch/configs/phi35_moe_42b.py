"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 on every layer.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2
[hf microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    block_pattern=("a",),
    moe_experts=16,
    moe_topk=2,
    moe_d_ff=6400,
)
