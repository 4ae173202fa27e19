"""Shared layer primitives: norms, rotary embeddings, activations, the
MLP and the embeddings, and the `Builder` callback their initializers
are written against.

Parameters are plain tensors in nested dicts.  Every initializer is
written against a `Builder` callback, so the same code emits real
tensors (`tensor_builder`), shape-only `device="meta"` tensors
(`meta_builder`, what the schedule's byte accounting reads) or logical
axis names (`axes_builder`), and the trees stay structurally identical
by construction.

The apply half follows the reference operation for operation: weights
are cast to the activations' dtype at each call (`p[...].to(dt)`, as
the reference's `astype(dt)`), the norm and the rotary embedding run in
float32 and cast back, and the logits leave in float32.

Under tensor parallelism (`parallel.sharding`) the same code runs on a
rank's slices: `apply_mlp` on the column slices of `wi`/`wg` and the row
slice of `wo` gives the rank's terms of the output (`mlp_residual` sums
them into the residual layout), `lm_logits` on the rank's vocab slice of
the head gives its slice of the logits, and `embed_tokens` looks up the
rows its vocab slice holds and sums them over the model group.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import tp as tpc
from ..parallel.sharding import (ShardCtx, gather_residual, reduce_residual,
                                 shard_residual)

# A Builder receives (name, shape, logical_axes, scale) and returns a leaf.
Builder = Callable[[str, Tuple[int, ...], Tuple[str, ...], float], object]


def tensor_builder(generator: torch.Generator, dtype=torch.float32,
                   device=None) -> Builder:
    """Builder that materializes parameters: a truncated normal within
    ±2 standard deviations times `scale / sqrt(fan_in)`, drawn from
    `generator` on its own device and moved to `device`, or zeros where
    `scale == 0`.  `fan_in` is the leading dimension (of a 1-D leaf, its
    length)."""
    device = generator.device if device is None else torch.device(device)

    def make(name, shape, axes, scale):
        if scale == 0.0:
            return torch.zeros(shape, dtype=dtype, device=device)
        fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
        std = scale / math.sqrt(fan_in)
        x = torch.empty(shape, dtype=dtype, device=generator.device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (x * std).to(device)

    return make


def meta_builder(dtype=torch.float32) -> Builder:
    """Builder of shape-only leaves: `device="meta"` tensors of `dtype`,
    which hold no memory."""
    def make(name, shape, axes, scale):
        return torch.empty(shape, dtype=dtype, device="meta")
    return make


def axes_builder() -> Builder:
    """Builder that records logical axis names instead of tensors."""
    def make(name, shape, axes, scale):
        assert len(axes) == len(shape), (name, shape, axes)
        return axes
    return make


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(dt)


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, base: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32,
                                        device=device), exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int32."""
    freqs = rope_freqs(x.shape[-1], base, x.device)           # (D/2,)
    ang = positions.float()[..., None] * freqs                # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP and embeddings: params + apply
# ---------------------------------------------------------------------------

def init_mlp(make: Builder, d_model: int, d_ff: int, prefix: str,
             gated: bool = True) -> Dict:
    p = {
        "wi": make(f"{prefix}.wi", (d_model, d_ff), ("embed", "mlp"), 1.0),
        "wo": make(f"{prefix}.wo", (d_ff, d_model), ("mlp", "embed"), 1.0),
    }
    if gated:
        p["wg"] = make(f"{prefix}.wg", (d_model, d_ff), ("embed", "mlp"),
                       1.0)
    return p


def apply_mlp(p: Dict, x: torch.Tensor, act: str, dtype) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dtype))
    if "wg" in p:
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(dtype))
        h = act_fn(act)(g) * h
    else:
        h = act_fn(act)(h)
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dtype))


def mlp_residual(p: Dict, x: torch.Tensor, act: str, dtype, ctx: ShardCtx,
                 seq_len: int, d_ff: int) -> torch.Tensor:
    """The MLP of x (B, S', D) in the residual layout of a sequence of
    `seq_len`, returned in that layout: x gathered along S, then
    column-parallel `wi`/`wg` and row-parallel `wo` with the terms summed
    (reduce-scattered) when the model dim splits `d_ff`, else the whole
    MLP on every rank.  Without a mesh, `apply_mlp`."""
    y = apply_mlp(p, gather_residual(x, ctx, seq_len), act, dtype)
    if ctx.splits("mlp", d_ff):
        return reduce_residual(y, ctx)
    return shard_residual(y, ctx)


def init_embed(make: Builder, vocab: int, d_model: int,
               tie: bool) -> Dict:
    # the table's d_model dim has its own logical axis ('embed_t', never
    # sharded), as in the reference's layout
    p = {"tok": make("embed.tok", (vocab, d_model),
                     ("vocab", "embed_t"), 1.0)}
    if not tie:
        p["head"] = make("embed.head", (d_model, vocab),
                         ("embed", "vocab"), 1.0)
    return p


def embed_tokens(p: Dict, tokens: torch.Tensor, dtype,
                 ctx: Optional[ShardCtx] = None,
                 vocab: int = 0) -> torch.Tensor:
    """The rows of `tokens`, (B, S, D) whole on every rank.  Rows
    gathered, then cast: the same values as the reference's cast of the
    whole table, then its `take`.  Where the model dim splits the vocab
    (`vocab`, the whole table's rows), each rank looks up the tokens its
    slice holds, masks the others to zero and the rows are summed over
    the model group (one term a token is nonzero)."""
    if ctx is None or not ctx.splits("vocab", vocab):
        return p["tok"][tokens.long()].to(dtype)
    start, size = ctx.local_range(vocab)
    local = tokens.long() - start
    held = (local >= 0) & (local < size)
    rows = p["tok"][local.clamp(0, size - 1)].to(dtype)
    return tpc.reduce(torch.where(held[..., None], rows, 0.0),
                      ctx.tp_group)


def lm_logits(p: Dict, x: torch.Tensor, dtype,
              cap: float = 0.0) -> torch.Tensor:
    """Float32 logits of x over the head's vocab: a rank's slice under
    tensor parallelism (`sharding.shard_logits` gathers them)."""
    if "head" in p:
        logits = torch.einsum("bsd,dv->bsv", x, p["head"].to(dtype))
    else:
        logits = torch.einsum("bsd,vd->bsv", x, p["tok"].to(dtype))
    return softcap(logits.float(), cap)
