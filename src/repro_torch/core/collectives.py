"""Plane-sharded collectives: the paper's technique as a gradient-sync
engine over `torch.distributed`.

Every gradient leaf is split along axis 0 into micro-chunks; each
micro-chunk is an independent collective stream assigned to a plane by
the PLB weights (the assignment is pure scheduling: numerics do not
change).  `plane_allreduce` lowers each stream as one `all_reduce`
("psum") or as a ring decomposition, `reduce_scatter_tensor` then
`all_gather_into_tensor` ("rs_ag"), whose all-gather can carry int8
codes ("rs_ag_int8": per-row scale, stochastic rounding, unbiased), the
distributed-optimization extension beyond the paper.  The codec is the
port's hand-written kernels (`kernels.ops.int8_encode` /
`int8_decode`) on CUDA tensors and their plain versions on CPU tensors;
the noise comes from `chunk_noise`, the same on every rank.  The group
is the data-parallel one of the caller's mesh
(`parallel.sharding.ShardCtx.group`).

`stream_report` computes the chunk sizes and their plane assignment for
a parameter tree of tensors, real or `device="meta"`, reading only each
leaf's `shape` and `dtype.itemsize`; the training-step schedule
(`repro_torch.comms`) takes its gradient bytes from it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.transformer import tree_leaves, tree_unflatten

from .planes import PlaneConfig

MODES = ("psum", "rs_ag", "rs_ag_int8")
# `PlaneConfig.compression` -> mode
_COMPRESSION_MODE = {"none": "psum", "int8": "rs_ag_int8"}


# ---------------------------------------------------------------------------
# int8 codec (per-row, last dim) and its noise
# ---------------------------------------------------------------------------

def int8_encode(x: torch.Tensor, noise: torch.Tensor):
    """Per-row (last-dim) scaled int8 with stochastic rounding
    (unbiased): (q int8 of x's shape, scale float32 of shape[:-1] + (1,)).
    `noise` is U(-0.5, 0.5) float32 of x's shape (`chunk_noise`).  The
    encode kernel on x's (rows, last dim) view."""
    C = x.shape[-1]
    q, scale = ops.int8_encode(x.reshape(-1, C), noise.reshape(-1, C))
    return q.view(x.shape), scale.view(*x.shape[:-1], 1)


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q x scale in float32, of q's shape; the decode kernel on the
    (rows, last dim) view."""
    C = q.shape[-1]
    return ops.int8_decode(q.reshape(-1, C), scale.reshape(-1, 1)).view(
        q.shape)


def fold_seed(seed: int, data: int) -> int:
    """A 63-bit seed from (seed, data), the port's `jax.random.fold_in`
    for integer keys (numpy's `SeedSequence` mixes the two)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def chunk_noise(seed: int, kidx: int, shape, device) -> torch.Tensor:
    """The codec's U(-0.5, 0.5) float32 noise for chunk `kidx` of a step
    keyed `seed`, of the reduced shard's `shape`, on `device`: a
    `torch.Generator` seeded from both, so every rank draws the same
    noise for a chunk (the reference draws `uniform(fold_in(key, kidx),
    shape, -0.5, 0.5)`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, kidx))
    return torch.rand(tuple(shape), generator=gen, device=device) - 0.5


def _chunk_bounds(n0: int, k: int) -> List[Tuple[int, int]]:
    """np.array_split-style bounds of axis-0 into <=k chunks."""
    k = min(k, n0)
    sizes = [n0 // k + (1 if i < n0 % k else 0) for i in range(k)]
    bounds, off = [], 0
    for s in sizes:
        bounds.append((off, off + s))
        off += s
    return bounds


def _scatter_dim(shape: Tuple[int, ...], dp: int) -> int:
    for d in range(min(2, len(shape))):
        if shape[d] % dp == 0 and shape[d] >= dp:
            return d
    return -1


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of x's tile `rank` along `dim` (the
    reference's `psum_scatter(..., tiled=True)`): the collective splits
    dim 0 only, so `dim` goes there and back."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in group rank order (the
    reference's `all_gather(..., tiled=True)`)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] * n,) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _psum_chunk(x: torch.Tensor, group, mode: str, seed: int, kidx: int,
                dp_size: int) -> torch.Tensor:
    """One micro-chunk collective stream."""
    if mode == "psum":
        return _all_reduce(x, group)
    sd = _scatter_dim(tuple(x.shape), dp_size)
    if sd < 0:
        return _all_reduce(x, group)
    # ring decomposition: reduce-scatter then all-gather
    red = _reduce_scatter(x, sd, group)
    if mode == "rs_ag" or sd >= x.ndim - 1:
        # (int8: cannot compress along the scaling dim, 1-D chunks)
        return _all_gather(red, sd, group)
    q, scale = int8_encode(red, chunk_noise(seed, kidx, red.shape,
                                            red.device))
    return int8_decode(_all_gather(q, sd, group),
                       _all_gather(scale, sd, group))


def plane_allreduce(grads, group, cfg: PlaneConfig,
                    key: Optional[int] = None, mode: Optional[str] = None,
                    mean: bool = True):
    """Sum (or mean) a gradient tree over the process group `group` (the
    data-parallel ranks, `ShardCtx.group(plane_axes)`) via micro-chunk
    streams.  `key` is the step's integer seed (0 when None): chunk k's
    codec noise is `chunk_noise(key, k, ...)`, chunks numbered from 1
    over the tree's leaves in order, as the reference folds its key.
    `mode` defaults from `cfg.compression` ("none" -> "psum", "int8" ->
    "rs_ag_int8").  The inputs are not written; every rank must call it
    with the same tree shapes."""
    import torch.distributed as dist
    dp_size = dist.get_world_size(group)
    if mode is None:
        mode = _COMPRESSION_MODE.get(cfg.compression, cfg.compression)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    seed = 0 if key is None else int(key)
    out = []
    kidx = 0
    for leaf in tree_leaves(grads):
        if leaf.ndim == 0 or leaf.numel() <= cfg.microchunks:
            out.append(_all_reduce(leaf, group))
            continue
        pieces = []
        for (lo, hi) in _chunk_bounds(leaf.shape[0], cfg.microchunks):
            kidx += 1
            pieces.append(_psum_chunk(leaf[lo:hi], group, mode, seed, kidx,
                                      dp_size))
        out.append(torch.cat(pieces, dim=0).to(leaf.dtype))
    if mean:
        out = [x / dp_size for x in out]
    return tree_unflatten(grads, out)


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
