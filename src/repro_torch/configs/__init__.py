"""Architecture registry: `--arch <id>` -> ModelConfig, plus per-arch
input-shape sets for the dry-run matrix.  A copy of the reference
registry, entry for entry, over the port's `ModelConfig`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig

from .musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from .jamba_v0_1_52b import CONFIG as JAMBA_52B
from .mamba2_780m import CONFIG as MAMBA2_780M
from .deepseek_v2_236b import CONFIG as DEEPSEEK_V2_236B
from .phi35_moe_42b import CONFIG as PHI35_MOE
from .llama3_8b import CONFIG as LLAMA3_8B
from .gemma_2b import CONFIG as GEMMA_2B
from .gemma3_12b import CONFIG as GEMMA3_12B
from .granite_20b import CONFIG as GRANITE_20B
from .llava_next_mistral_7b import CONFIG as LLAVA_NEXT
from .spx_paper import DEEPSEEK_V3_PROXY, SPX_100M

ARCHS: Dict[str, ModelConfig] = {
    "musicgen-medium": MUSICGEN_MEDIUM,
    "jamba-v0.1-52b": JAMBA_52B,
    "mamba2-780m": MAMBA2_780M,
    "deepseek-v2-236b": DEEPSEEK_V2_236B,
    "phi3.5-moe-42b-a6.6b": PHI35_MOE,
    "llama3-8b": LLAMA3_8B,
    "gemma-2b": GEMMA_2B,
    "gemma3-12b": GEMMA3_12B,
    "granite-20b": GRANITE_20B,
    "llava-next-mistral-7b": LLAVA_NEXT,
    # paper-native extras (not part of the 40-cell matrix)
    "deepseek-v3-proxy": DEEPSEEK_V3_PROXY,
    "spx-100m": SPX_100M,
}

ASSIGNED = [n for n in ARCHS if n not in
            ("deepseek-v3-proxy", "spx-100m")]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    cfg.validate()
    return cfg


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (skip pure full-attention
    archs per the assignment; see DESIGN.md §Arch-applicability)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 524k-token decode KV is "
                       "quadratic-cost prefill territory; skipped per "
                       "assignment")
    return True, ""


def matrix():
    """All 40 (arch x shape) cells with applicability flags."""
    cells = []
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = shape_applicable(cfg, shape)
            cells.append((arch, shape, ok, why))
    return cells
