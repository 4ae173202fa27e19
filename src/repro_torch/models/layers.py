"""Shared layer primitives, the init half: the `Builder` callback and the
MLP and embedding initializers.

Parameters are plain tensors in nested dicts.  Every initializer is
written against a `Builder` callback, so the same code emits real
tensors (`tensor_builder`), shape-only `device="meta"` tensors
(`meta_builder`, what the schedule's byte accounting reads) or logical
axis names (`axes_builder`), and the trees stay structurally identical
by construction.  The apply half (norms, rotary embeddings, the MLP and
embedding forward) arrives with the model forward (ROADMAP queue 1
item 8).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

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
