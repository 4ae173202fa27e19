"""Multi-plane configuration and payload-split math (§3.1, §4.3).

A plane at the framework level is a parallel collective *stream*: every DP
gradient bucket is split into micro-chunks and each micro-chunk is assigned
to a plane.  Assignment never changes numerics (summation commutes — the
paper's out-of-order-tolerance analogue); it drives stream scheduling,
telemetry, and the failover performance model.  A copy of the
reference's module (NumPy only).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PlaneConfig:
    n_planes: int = 4
    microchunks: int = 16         # collective streams per bucket (>= planes)
    bucket_mb: float = 4.0
    compression: str = "none"     # 'none' | 'int8'
    recovery_steps: int = 2       # PLB convergence budget ("a few RTTs")
    probe_timeout: int = 3        # consecutive probe misses -> plane failed
    ewma: float = 0.5             # per-plane goodput/latency EWMA factor

    def __post_init__(self):
        assert self.n_planes >= 1
        assert self.microchunks >= self.n_planes


def apportion(weights: np.ndarray, k: int) -> np.ndarray:
    """Largest-remainder apportionment of k micro-chunks to planes.

    weights: (P,) nonnegative; returns (k,) plane ids.  Zero-weight planes
    receive no chunks.  Deterministic.
    """
    w = np.asarray(weights, np.float64)
    P = w.shape[0]
    if w.sum() <= 0:
        w = np.ones(P)
    w = w / w.sum()
    ideal = w * k
    base = np.floor(ideal).astype(int)
    rem = k - base.sum()
    order = np.argsort(-(ideal - base), kind="stable")
    for i in range(rem):
        base[order[i % P]] += 1
    out = np.repeat(np.arange(P), base)
    assert out.shape[0] == k
    return out


def plane_loads(assignment: np.ndarray, n_planes: int,
                chunk_bytes: np.ndarray | float) -> np.ndarray:
    """Bytes per plane for a chunk->plane assignment."""
    loads = np.zeros(n_planes)
    cb = np.broadcast_to(np.asarray(chunk_bytes, np.float64),
                         assignment.shape)
    np.add.at(loads, assignment, cb)
    return loads


def effective_bandwidth(weights: np.ndarray, assignment: np.ndarray,
                        plane_rate: np.ndarray) -> float:
    """Normalized goodput of a chunked transfer: the slowest plane finishing
    its assigned share gates completion (the paper's 'dictated by the
    slowest plane' failure mode for load-oblivious spraying)."""
    P = plane_rate.shape[0]
    loads = plane_loads(assignment, P, 1.0)
    loads = loads / max(loads.sum(), 1e-12)
    t = np.where(loads > 0, loads / np.maximum(plane_rate, 1e-9), 0.0)
    tmax = t.max()
    return 1.0 / (P * tmax) if tmax > 0 else 1.0
