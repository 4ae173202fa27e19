"""mamba2-780m [ssm] — pure SSD (state-space duality), attention-free.

48L d_model=1536 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; state-spaces/mamba2-780m]

Mixer-only blocks (no MLP sublayer, d_ff=0); expand=2 -> d_inner=3072,
head_dim=64 -> 48 heads, n_groups=1.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    block_pattern=("m",),
    ssm_state=128,
    ssm_heads=48,
    ssm_head_dim=64,
    ssm_groups=1,
    conv_width=4,
    tie_embeddings=True,
)
