"""Batched serving engine: slot-based continuous batching over a fixed
decode batch, with prefill and decode steps run eagerly under
`torch.inference_mode()`.

A request is admitted into a free slot by a prefill of the whole batch
(the other rows' prompts are zeros) whose caches are then kept for that
slot's row only: every other row keeps the cache it had.  The rows lie
along the batch axis of each cache leaf, which is axis 0 of a prefix
layer's leaves and axis 1 of a pattern position's leaves (stacked over
the periods first).  The reference restores `old.at[slot]` whenever a
leaf's leading axis equals the batch, which writes along the period axis
of the stacked leaves, and keeps the whole new prefill otherwise; the
port restores along the batch axis, as the reference's comment intends
(ROADMAP queue 3).

Under a mesh (tensor parallelism, FSDP or both) every rank runs the
engine on its slices of the weights with its own caches
(`init_caches(..., ctx)`: its kv heads, its SSM heads' state and conv
inputs, the whole MLA latent cache), and the steps return the whole
vocab's logits on every rank, so every rank picks the same greedy
tokens; `_keep_slot` restores each rank's own rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import decode_step, init_caches, prefill_step, tree_leaves
from ..models.config import ModelConfig
from ..models.transformer import torch_dtype
from ..parallel.sharding import ShardCtx


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


def _keep_slot(old: Dict, new: Dict, slot: int) -> Dict:
    """`old`'s caches with `slot`'s row taken from `new`, written into
    `old`'s tensors in place (they are the engine's own and nothing else
    reads them)."""
    def rows(o, n, axis):
        if isinstance(o, dict):
            return {k: rows(o[k], n[k], axis) for k in o}
        o.select(axis, slot).copy_(n.select(axis, slot))
        return o
    return {"prefix": [rows(o, n, 0) for o, n in zip(old["prefix"],
                                                      new["prefix"])],
            "period": [rows(o, n, 1) for o, n in zip(old["period"],
                                                      new["period"])]}


class ServeEngine:
    def __init__(self, cfg: ModelConfig, ctx: ShardCtx, params,
                 batch: int, max_len: int, greedy: bool = True):
        self.cfg, self.ctx, self.params = cfg, ctx, params
        self.batch, self.max_len = batch, max_len
        self.greedy = greedy
        self.device = tree_leaves(params)[0].device
        self.caches = init_caches(cfg, batch, max_len,
                                  torch_dtype(cfg.dtype), self.device, ctx)
        self.slots: List[Optional[Request]] = [None] * batch
        self.positions = np.zeros(batch, np.int32)
        self.next_tok = np.zeros(batch, np.int32)

        self._prefill = (
            lambda p, t, c: prefill_step(p, cfg, t, ctx, c))
        self._decode = (
            lambda p, t, q, c: decode_step(p, cfg, t, q, ctx, c))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def add_request(self, req: Request) -> bool:
        """Prefill a request into a free slot (one-slot batch prefill)."""
        try:
            slot = self.slots.index(None)
        except ValueError:
            return False
        s = req.prompt.shape[0]
        toks = np.zeros((self.batch, s), np.int32)
        toks[slot] = req.prompt
        logits, new_caches = self._prefill(
            self.params, torch.tensor(toks, device=self.device), self.caches)
        self.caches = _keep_slot(self.caches, new_caches, slot)
        self.slots[slot] = req
        self.positions[slot] = s
        self.next_tok[slot] = int(torch.argmax(logits[slot, -1]))
        return True

    @torch.inference_mode()
    def step(self) -> None:
        """One decode step for all active slots."""
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        toks = torch.tensor(self.next_tok[:, None], device=self.device)
        pos = torch.tensor(self.positions, device=self.device)
        logits, self.caches = self._decode(self.params, toks, pos,
                                           self.caches)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy().astype(
            np.int32)
        for i in active:
            req = self.slots[i]
            req.out.append(int(self.next_tok[i]))
            self.positions[i] += 1
            self.next_tok[i] = nxt[i]
            if (len(req.out) >= req.max_new or
                    self.positions[i] >= self.max_len - 1):
                req.done = True
                self.slots[i] = None

    def run(self, requests: List[Request], max_steps: int = 10_000
            ) -> List[Request]:
        pending = list(requests)
        finished: List[Request] = []
        steps = 0
        while (pending or any(self.slots)) and steps < max_steps:
            while pending and self.add_request(pending[0]):
                pending.pop(0)
            self.step()
            finished.extend(r for r in requests
                            if r.done and r not in finished)
            steps += 1
        return finished
