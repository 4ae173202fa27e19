"""llava-next-mistral-7b [vlm] — Mistral-7B backbone, anyres tiling.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf llava-hf/llava-v1.6-mistral-7b-hf]

Vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (576 base-resolution tokens; anyres adds
tiles).  The backbone is Mistral-7B-v0.2 (full attention, rope 1e6).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    block_pattern=("a",),
    rope_base=1_000_000.0,
    frontend="vision",
    frontend_tokens=576,
)
