"""AdamW with decoupled weight decay and global-norm clipping; a copy of
the reference's `optim/adamw.py` in torch ops.

State mirrors the parameter tree, float32.  Every update is computed in
the reference's float32 order, leaf by leaf in `jax.tree.leaves` order:
the clip scale from the per-leaf sums of squares added left to right,
the bias corrections as `1 - b ** count` in float32, and the step
`p - lr * (step + wd * p)`.  `torch.optim.AdamW` decays the weights and
corrects the bias in another order, so it rounds differently and is not
used.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.models.transformer import (tree_leaves, tree_map,
                                            tree_unflatten)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> Dict:
    """Zero moments, float32, on each leaf's device; `count` a 0-d int32
    on the first leaf's."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(params, zeros),
        "v": tree_map(params, zeros),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32: each leaf's
    sum, then the sums added in leaf order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_update(grads, opt_state: Dict, params, cfg: AdamWConfig,
                 lr_scale: torch.Tensor | float = 1.0,
                 ) -> Tuple[Dict, Dict, Dict]:
    """Returns (new_params, new_opt_state, metrics); the inputs are not
    written."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.clip_norm > 0 else 1.0)
    count = opt_state["count"] + 1
    c1 = 1.0 - torch.pow(cfg.b1, count.to(torch.float32))
    c2 = 1.0 - torch.pow(cfg.b2, count.to(torch.float32))
    lr = cfg.lr * lr_scale

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        step = (m2 / c1) / (torch.sqrt(v2 / c2) + cfg.eps)
        p32 = p.to(torch.float32)
        p2 = p32 - lr * (step + cfg.weight_decay * p32)
        return p2.to(p.dtype), m2, v2

    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"]), tree_leaves(params)):
        p2, m2, v2 = upd(g, m, v, p)
        new_p.append(p2)
        new_m.append(m2)
        new_v.append(v2)
    return (tree_unflatten(params, new_p),
            {"m": tree_unflatten(opt_state["m"], new_m),
             "v": tree_unflatten(opt_state["v"], new_v),
             "count": count},
            {"grad_norm": gnorm})


def cosine_schedule(step: torch.Tensor | int, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to 1, then a cosine down to `floor`, in float32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
