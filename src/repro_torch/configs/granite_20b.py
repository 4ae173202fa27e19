"""granite-20b [dense] — llama-arch code model, MQA.

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf ibm-granite]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    block_pattern=("a",),
)
