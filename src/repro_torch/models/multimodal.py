"""Modality frontend stubs: `[audio]` (musicgen over EnCodec tokens) and
`[vlm]` (llava anyres patches) supply precomputed frame/patch
embeddings, which the backbone takes as `frontend_embeds`.  Here are
their shapes and a deterministic synthetic generator for smoke tests.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .transformer import torch_dtype


def frontend_shape(cfg: ModelConfig, batch: int):
    if cfg.frontend == "none" or cfg.frontend_tokens == 0:
        return None
    return (batch, cfg.frontend_tokens, cfg.d_model)


def synth_frontend(cfg: ModelConfig, batch: int,
                   generator: torch.Generator):
    """Standard normal embeddings times 0.02 in `cfg.dtype`, drawn from
    `generator` on its own device (the reference draws from
    `jax.random.PRNGKey(seed)`; the two give other numbers)."""
    shape = frontend_shape(cfg, batch)
    if shape is None:
        return None
    x = torch.randn(shape, generator=generator, device=generator.device)
    return x.to(torch_dtype(cfg.dtype)) * 0.02
