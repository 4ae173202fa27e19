"""Paper-native workload configs.

* ``deepseek-v3-proxy`` — the paper's §6.3 isolation workload ("DeepSeek-V3
  16N NVL8 proxy"): an MLA+MoE model scaled so a 16-node slice trains it;
  used by the fig9/fig10 isolation benchmarks.
* ``spx-100m`` — the ~100M-parameter model for the end-to-end training
  example (examples/train_e2e.py).
"""
from repro_torch.models.config import ModelConfig

DEEPSEEK_V3_PROXY = ModelConfig(
    name="deepseek-v3-proxy",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,
    d_ff=8192,
    vocab=32768,
    n_prefix_layers=1,
    block_pattern=("a",),
    use_mla=True,
    q_lora=768,
    kv_lora=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    moe_experts=64,
    moe_topk=8,
    moe_shared=1,
    moe_d_ff=1024,
)

SPX_100M = ModelConfig(
    name="spx-100m",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab=32768,
    block_pattern=("a",),
    remat="none",
)
