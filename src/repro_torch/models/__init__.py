"""The model stack's parameter layout: configs, initializers and the
parameter tree (`transformer`).  The forward halves arrive with ROADMAP
queue 1 item 8."""
from .config import ModelConfig
from .transformer import (init_params, logical_axes, param_count,
                          param_shapes, params_from_jax, tree_items,
                          tree_leaves)

__all__ = [
    "ModelConfig", "init_params", "logical_axes", "param_count",
    "param_shapes", "params_from_jax", "tree_items", "tree_leaves",
]
