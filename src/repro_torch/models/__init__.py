"""The model stack: configs, the parameter layout, the forward
(`prefill_step`, `decode_step`) and the differentiable training loss
(`loss_fn`)."""
from .attention import standard_attention_layers
from .config import ModelConfig
from .transformer import (backbone, decode_step, embed_input, init_caches,
                          init_params, logical_axes, loss_fn, param_count,
                          param_shapes, param_specs, params_from_jax,
                          prefill_step, shard_caches, tree_items, tree_leaves,
                          tree_map, tree_unflatten)

__all__ = [
    "ModelConfig", "init_params", "logical_axes", "init_caches",
    "shard_caches", "loss_fn", "prefill_step", "decode_step", "param_count",
    "backbone", "embed_input", "param_shapes", "param_specs", "params_from_jax",
    "tree_items", "tree_leaves", "tree_map", "tree_unflatten",
    "standard_attention_layers",
]
