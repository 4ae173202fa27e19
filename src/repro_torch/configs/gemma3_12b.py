"""gemma3-12b [dense] — 5:1 local:global sliding-window, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf google/gemma-3-12b-pt]

Pattern: 5 sliding-window (1024) layers then 1 global layer, x8 periods.
QK-norm per gemma3; GeGLU; head_dim=256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    act="gelu",
    block_pattern=("l", "l", "l", "l", "l", "g"),
    window=1024,
    qk_norm=True,
    rope_base=1_000_000.0,
    tie_embeddings=True,
)
