"""deepseek-v2-236b [moe] — MLA latent attention + fine-grained MoE.

60L d_model=5120 128H d_ff=1536(routed expert) vocab=102400,
MoE 160 routed top-6 + 2 shared; MLA kv_lora=512, q_lora=1536,
rope_head_dim=64, nope=128, v=128.  First layer is a dense FFN
(intermediate 12288), layers 2..60 are MoE.  [arXiv:2405.04434; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,          # nope 128 + rope 64
    d_ff=12288,            # dense prefix layer intermediate
    vocab=102400,
    n_prefix_layers=1,
    block_pattern=("a",),
    use_mla=True,
    q_lora=1536,
    kv_lora=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    moe_experts=160,
    moe_topk=6,
    moe_shared=2,
    moe_d_ff=1536,
)
