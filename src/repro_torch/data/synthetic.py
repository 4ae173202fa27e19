"""Deterministic synthetic data pipeline (NumPy only; a copy of the
reference's `data/synthetic.py`, held to it by array equality).

A seeded, stateless token stream (same sequence for a given (seed, step,
shard) triple) so training runs are reproducible and restart-consistent:
after checkpoint restore at step k, batch k+1 is identical to an
uninterrupted run — required for the fault-tolerance tests.

The generator is a order-5 linear-congruential mix over (seed, step,
position), cheap enough to build batches on the host for any vocab.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    frontend_tokens: int = 0
    d_model: int = 0              # for frontend embeds


def _mix(a: np.ndarray) -> np.ndarray:
    a = (a ^ (a >> 16)) * np.uint64(0x45d9f3b45d9f3b)
    a = (a ^ (a >> 31)) * np.uint64(0x9E3779B97F4A7C15)
    return a ^ (a >> 29)


def batch_at(cfg: DataConfig, step: int,
             shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """The (step, shard)-th batch. tokens/labels: (B_shard, S) int32."""
    assert cfg.global_batch % n_shards == 0
    b = cfg.global_batch // n_shards
    rows = np.arange(b, dtype=np.uint64) + \
        np.uint64(shard * b + step * cfg.global_batch)
    cols = np.arange(cfg.seq_len + 1, dtype=np.uint64)
    grid = _mix((rows[:, None] << np.uint64(20)) ^ cols[None, :] ^
                np.uint64(cfg.seed))
    toks = (grid % np.uint64(cfg.vocab)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend_tokens and cfg.d_model:
        f = _mix(grid[:, :cfg.frontend_tokens].astype(np.uint64) +
                 np.uint64(7))
        emb = ((f % np.uint64(2048)).astype(np.float32) / 1024.0 - 1.0)
        out["frontend_embeds"] = np.repeat(
            emb[:, :, None], cfg.d_model, axis=2).astype(np.float32) * 0.02
    return out


class DataLoader:
    """Host-side prefetching iterator over deterministic batches."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 shard: int = 0, n_shards: int = 1):
        self.cfg = cfg
        self.step = start_step
        self.shard = shard
        self.n_shards = n_shards

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = batch_at(self.cfg, self.step, self.shard, self.n_shards)
        self.step += 1
        return b

    def state(self) -> Dict:
        return {"step": self.step, "shard": self.shard,
                "n_shards": self.n_shards}

    @classmethod
    def restore(cls, cfg: DataConfig, state: Dict) -> "DataLoader":
        return cls(cfg, start_step=state["step"], shard=state["shard"],
                   n_shards=state["n_shards"])
