"""Plane-sharded collectives, the host-side stream accounting.

Every gradient leaf is split along axis 0 into micro-chunks; each
micro-chunk is an independent collective stream assigned to a plane by
the PLB weights (the assignment is pure scheduling: numerics do not
change).  `stream_report` computes the chunk sizes and their plane
assignment for a parameter tree of tensors, real or `device="meta"`,
reading only each leaf's `shape` and `dtype.itemsize`; the training-step
schedule (`repro_torch.comms`) takes its gradient bytes from it.  The
allreduce itself (`plane_allreduce` and its int8 codec) runs over a
data-parallel mesh and arrives with sharding (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.models.transformer import tree_leaves

from .planes import PlaneConfig


def _chunk_bounds(n0: int, k: int) -> List[Tuple[int, int]]:
    """np.array_split-style bounds of axis-0 into <=k chunks."""
    k = min(k, n0)
    sizes = [n0 // k + (1 if i < n0 % k else 0) for i in range(k)]
    bounds, off = [], 0
    for s in sizes:
        bounds.append((off, off + s))
        off += s
    return bounds


@dataclass
class StreamReport:
    chunk_bytes: np.ndarray      # (n_chunks,)
    assignment: np.ndarray       # (n_chunks,) plane ids
    bytes_per_plane: np.ndarray  # (P,)


def stream_report(grads, cfg: PlaneConfig,
                  weights: np.ndarray | None = None) -> StreamReport:
    """The micro-chunk -> plane assignment of a gradient tree (leaves in
    `jax.tree.leaves` order, `models.transformer.tree_leaves`) under the
    PLB weights (uniform by default).  A leaf without a dtype counts 4
    bytes an element."""
    if weights is None:
        weights = np.ones(cfg.n_planes) / cfg.n_planes
    sizes = []
    for leaf in tree_leaves(grads):
        shape = tuple(getattr(leaf, "shape", ()))
        dt = getattr(leaf, "dtype", None)
        itemsize = dt.itemsize if dt is not None else 4
        if len(shape) == 0 or int(np.prod(shape)) <= cfg.microchunks:
            sizes.append(int(np.prod(shape)) * itemsize)
            continue
        per = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        for (lo, hi) in _chunk_bounds(shape[0], cfg.microchunks):
            sizes.append((hi - lo) * per * itemsize)
    chunk_bytes = np.asarray(sizes, np.float64)
    assignment = greedy_assign(chunk_bytes, np.asarray(weights))
    bpp = np.zeros(cfg.n_planes)
    np.add.at(bpp, assignment, chunk_bytes)
    return StreamReport(chunk_bytes=chunk_bytes, assignment=assignment,
                        bytes_per_plane=bpp)


def greedy_assign(chunk_bytes: np.ndarray,
                  weights: np.ndarray) -> np.ndarray:
    """Byte-aware LPT assignment: largest chunk first onto the plane with
    the smallest weighted load. Chunk-count apportionment leaves planes
    imbalanced when chunk sizes are skewed (the embedding chunk alone can
    be 10x a layer chunk)."""
    P = weights.shape[0]
    w = np.asarray(weights, np.float64)
    if w.sum() <= 0:
        w = np.ones(P)
    w = np.maximum(w / w.sum(), 0.0)
    loads = np.zeros(P)
    out = np.zeros(chunk_bytes.shape[0], np.int64)
    order = np.argsort(-chunk_bytes, kind="stable")
    eligible = w > 1e-12
    for i in order:
        score = np.where(eligible,
                         (loads + chunk_bytes[i]) / np.maximum(w, 1e-12),
                         np.inf)
        p = int(np.argmin(score))
        out[i] = p
        loads[p] += chunk_bytes[i]
    return out
