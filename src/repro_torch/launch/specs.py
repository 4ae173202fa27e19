"""The launcher's context selection, a partial port of the reference's
`launch/specs.py`: whether a config trains under FSDP, and the
`ShardCtx` a launcher builds for a mesh.  (The reference's
ShapeDtypeStruct builders serve its dry run and are ROADMAP queue 1
item 4d.)
"""
from __future__ import annotations

from typing import Optional

from ..models import param_count, param_shapes
from ..models.config import ModelConfig
from ..parallel.sharding import ShardCtx, make_rules

FSDP_PARAM_THRESHOLD = 5e9     # params above this shard over the data axis


def analytic_param_count(cfg: ModelConfig) -> int:
    """The parameter count of `cfg`, from `param_shapes` (no memory)."""
    return param_count(param_shapes(cfg))


def make_ctx(mesh, cfg: Optional[ModelConfig] = None,
             fsdp: Optional[bool] = None) -> ShardCtx:
    """The context for `mesh` (a `DeviceMesh` with named dims, or None
    for one rank): DP over ("pod", "data") where the mesh has a "pod"
    dim, else "data"; TP over "model"; FSDP over "data" when `fsdp`, or,
    left None, when `cfg` has more than FSDP_PARAM_THRESHOLD
    parameters, with `make_rules("data")`."""
    if mesh is None:
        return ShardCtx(mesh=None)
    multi = "pod" in tuple(mesh.mesh_dim_names or ())
    dp = ("pod", "data") if multi else ("data",)
    if fsdp is None and cfg is not None:
        fsdp = analytic_param_count(cfg) > FSDP_PARAM_THRESHOLD
    fsdp_axis = "data" if fsdp else None
    return ShardCtx(mesh=mesh, dp_axes=dp, tp_axis="model",
                    fsdp_axis=fsdp_axis, rules=make_rules(fsdp_axis))
