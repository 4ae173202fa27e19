"""gemma-2b [dense] — GeGLU, head_dim=256, MQA.

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000
[arXiv:2403.08295; hf google/gemma-2b]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    act="gelu",
    block_pattern=("a",),
    tie_embeddings=True,
)
