"""musicgen-medium [audio] — decoder-only LM over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24 -> MHA) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf facebook/musicgen-medium]

Audio frontend is a STUB per the assignment: the text-conditioning prefix
arrives as precomputed continuous embeddings (frontend_tokens); the EnCodec
codebook tokens are the LM vocabulary itself.  MusicGen's FFN is ungated
GELU (plain transformer decoder).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    act="gelu",
    gated_mlp=False,
    block_pattern=("a",),
    frontend="audio",
    frontend_tokens=64,
)
