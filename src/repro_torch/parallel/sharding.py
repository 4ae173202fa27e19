"""The `ShardCtx` threaded through the model forward and the train step.

The reference maps logical axes onto a JAX mesh and constrains
activations with `with_sharding_constraint`.  This port takes a
`torch.distributed.device_mesh.DeviceMesh` with named dims
(`launch.mesh.make_mesh_for`) and data parallelism over it: the batch is
tiled over the data-parallel dims and the gradients are summed over
them by the plane collective engine (`core.collectives.plane_allreduce`,
through `ShardCtx.group`).  Tensor parallelism and FSDP are ROADMAP
queue 1 item 4c: a mesh whose model dim is above 1, or an FSDP axis,
raises `NotImplementedError`.  With a model dim of 1 the reference's
constraints change no layout, so every `shard_*` function the forward
calls returns its input as it is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def axis_size(mesh, name: str) -> int:
    """The size of the mesh dim `name`."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"mesh dims {names} have no {name!r}")
    return int(mesh.shape[names.index(name)])


def _rows(mesh, dims: Tuple[str, ...]) -> List[List[int]]:
    """The global ranks of every group over `dims`, one list a group, each
    in the reference's order: the coordinates on `dims` read as one
    row-major number (rank = pod x |data| + data)."""
    names = tuple(mesh.mesh_dim_names)
    idx = [names.index(d) for d in dims]
    rest = [i for i in range(len(names)) if i not in idx]
    n = int(np.prod([mesh.shape[i] for i in idx]))
    return mesh.mesh.permute(*rest, *idx).reshape(-1, n).tolist()


def mesh_group(mesh, dims: Tuple[str, ...]):
    """The process group over the mesh dims `dims`, flattened in the
    reference's order: a rank's index in it is its coordinates on `dims`
    read as one row-major number, as `P(("pod", "data"))` tiles a batch.

    One dim is the mesh's own group of that dim.  Several are one
    `new_group` for each combination of the other dims, created by every
    rank in one order (`new_group` is collective over the world).  The
    group's rank order is checked against the expected one, and a
    mismatch raises: `new_group` sorts its ranks, so a mesh whose ranks
    do not run row-major over `dims` would tile the batch in another
    order than the reference's."""
    import torch.distributed as dist
    rows = _rows(mesh, tuple(dims))
    me = dist.get_rank()
    if len(dims) == 1:
        group = mesh.get_group(dims[0])
    else:
        group = None
        for row in rows:
            g = dist.new_group(row)
            if me in row:
                group = g
    want = next(row for row in rows if me in row)
    got = dist.get_process_group_ranks(group)
    if list(got) != want:
        raise RuntimeError(
            f"the group over {tuple(dims)} orders its ranks {got}; the "
            f"reference's order is {want}")
    return group


@dataclass(frozen=True)
class ShardCtx:
    """Distribution context threaded through model apply functions.

    `mesh` is None (one rank) or a `DeviceMesh` with named dims whose
    `tp_axis` has size 1; `fsdp_axis` must be None."""
    mesh: Optional[Any] = None
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    fsdp_axis: Optional[str] = None
    # the process groups `group` made, by dims (not a field of the
    # context's value: two contexts over one mesh compare equal)
    _groups: Dict[Tuple[str, ...], Any] = field(
        default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if self.mesh is None:
            return
        if self.fsdp_axis is not None or self.tp_size > 1:
            raise NotImplementedError(
                f"ShardCtx with tensor parallelism (model dim "
                f"{self.tp_size}) or FSDP (axis {self.fsdp_axis!r}): the "
                "port shards data only; TP and FSDP are ROADMAP queue 1 "
                "item 4c")
        for a in self.dp_axes:
            axis_size(self.mesh, a)

    @property
    def plane_axes(self) -> Tuple[str, ...]:
        """DP axes the plane collective engine synchronizes explicitly
        (the reference's: the DP axes but the FSDP one)."""
        return tuple(a for a in self.dp_axes if a != self.fsdp_axis)

    @property
    def tp_size(self) -> int:
        if self.mesh is None:
            return 1
        return axis_size(self.mesh, self.tp_axis)

    @property
    def dp_spec(self):
        return tuple(self.dp_axes) if len(self.dp_axes) > 1 else \
            self.dp_axes[0]

    def group(self, dims: Tuple[str, ...]):
        """The process group over the mesh dims `dims` (`mesh_group`),
        made once a context; every rank must ask for it together the
        first time."""
        dims = tuple(dims)
        if dims not in self._groups:
            self._groups[dims] = mesh_group(self.mesh, dims)
        return self._groups[dims]


def local_ctx() -> ShardCtx:
    return ShardCtx(mesh=None)


def shard_residual(x, ctx: ShardCtx):
    """(B, S, D): unchanged (no model dim above 1)."""
    return x


def shard_heads(x, ctx: ShardCtx):
    """(B, S, H, D): unchanged (no model dim above 1)."""
    return x


def shard_logits(x, ctx: ShardCtx):
    """(B, S, V): unchanged (no model dim above 1)."""
    return x


def shard_cache(x, ctx: ShardCtx, kv_heads_axis: int = 2):
    """A KV or latent cache: unchanged (no model dim above 1)."""
    return x
