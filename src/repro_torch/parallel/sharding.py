"""The `ShardCtx` threaded through the model forward, for one rank.

The reference maps logical axes onto a JAX mesh and constrains
activations with `with_sharding_constraint`.  This port runs on one
device, so its context has no mesh (`tp_size == 1`), none of the
reference's axis fields, and every `shard_*` function the forward calls
returns its input as it is.  Sharding over
`torch.distributed` is ROADMAP queue 1 item 4; until then a context
with a mesh raises `NotImplementedError`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ShardCtx:
    """Distribution context threaded through model apply functions."""
    mesh: Optional[Any] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ShardCtx with a mesh: the port runs on one rank; sharding "
                "over torch.distributed is ROADMAP queue 1 item 4")

    @property
    def tp_size(self) -> int:
        return 1


def local_ctx() -> ShardCtx:
    return ShardCtx(mesh=None)


def shard_residual(x, ctx: ShardCtx):
    """(B, S, D): unchanged on one rank."""
    return x


def shard_heads(x, ctx: ShardCtx):
    """(B, S, H, D): unchanged on one rank."""
    return x


def shard_logits(x, ctx: ShardCtx):
    """(B, S, V): unchanged on one rank."""
    return x


def shard_cache(x, ctx: ShardCtx, kv_heads_axis: int = 2):
    """A KV or latent cache: unchanged on one rank."""
    return x
