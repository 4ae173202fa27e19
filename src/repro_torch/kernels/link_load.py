"""Link loads and their bottleneck scale min(1, cap / max(load, eps)):

  * `bottleneck` and `bottleneck_many` replace the Pallas kernel
    `repro/kernels/link_load.py::_bottleneck_kernel` (CPU tensors:
    `ref.bottleneck_ref`; CUDA: `netsim_bottleneck`, elementwise).  One
    call of the kernel is a few thousand elements a slot, so its launch,
    not its bytes, costs the time: `bottleneck_many` scales up to six
    (cap, load) pairs in one launch (a fat-tree slot's two stages in
    both directions and its two access directions), and `bottleneck`
    is its one-pair case;
  * `bucket_load_bottleneck` replaces `_load_bottleneck_kernel`, ECMP's
    fused link-bucket sum + bottleneck (CPU tensors:
    `ref.load_bottleneck_ref`; CUDA: `netsim_bucket_load_bottleneck`, a
    group of lanes a bucket, which gathers the rates itself).  It takes
    a leading lane axis: a batch of points of one structure in one
    launch;
  * `segment_sum_many` is the sparse aggregation: flow-ordered bucket
    sums over a CSR plan (`SegmentPlan`), the counterpart of the
    reference's `segment_load` (`jax.ops.segment_sum`) and
    `segment_load_chunk` (`acc.at[k].add`), which XLA computes there
    (CPU tensors: `ref.segment_sum_ref`; CUDA: `netsim_segment_sum`, one
    thread a bucket).  CUDA's scatter adds keep no order, so the kernel
    is what keeps a sparse run bit-equal to the dense one and to the
    NumPy engine's `np.add.at`.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import build, ref

EPS = 1e-12
MAX_GROUP = 6                   # (cap, load) pairs one launch takes
MAX_SEG_GROUP = 6               # (vals, plan) entries one segment_sum takes


def bottleneck_many(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
                    eps: float = EPS) -> Tuple[torch.Tensor, ...]:
    """`min(1, cap / max(load, eps))` for each of 1-6 `(cap, load)` pairs
    (each pair of matching shape, every tensor of one dtype and on one
    device), in one kernel launch.  Returns one result per pair, in
    order, each bit-equal to `ref.bottleneck_ref` of its pair."""
    pairs = tuple(pairs)
    if not 1 <= len(pairs) <= MAX_GROUP:
        raise ValueError(f"bottleneck_many: {len(pairs)} (cap, load) "
                         f"pairs; the kernel takes 1-{MAX_GROUP}")
    first = pairs[0][0]
    for k, (cap, load) in enumerate(pairs):
        for name, t in ((f"cap[{k}]", cap), (f"load[{k}]", load)):
            if t.device != first.device:
                raise ValueError(f"{name}: on {t.device}, expected "
                                 f"{first.device}")
            if t.dtype != first.dtype:
                raise ValueError(f"{name}: dtype {t.dtype}, expected "
                                 f"{first.dtype}")
        if load.shape != cap.shape:
            raise ValueError(f"load[{k}]: shape {tuple(load.shape)}, "
                             f"expected {tuple(cap.shape)}")
    if first.device.type == "cpu":
        return tuple(ref.bottleneck_ref(cap, load, eps=eps)
                     for cap, load in pairs)
    dev = build.cuda_device("bottleneck", first)
    dt = build.float_dtype("bottleneck", first)
    for k, (cap, load) in enumerate(pairs):
        build.check(f"cap[{k}]", cap, device=dev, dtype=dt, shape=cap.shape)
        build.check(f"load[{k}]", load, device=dev, dtype=dt,
                    shape=cap.shape)
    outs = tuple(torch.empty_like(cap) for cap, _ in pairs)
    n = len(pairs)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    build.launch("bottleneck", dt, dev, ptrs(c for c, _ in pairs),
                 ptrs(ld for _, ld in pairs), ptrs(outs),
                 (ctypes.c_int64 * n)(*(c.numel() for c, _ in pairs)), n,
                 eps)
    return outs


def bottleneck(cap: torch.Tensor, load: torch.Tensor, *,
               eps: float = EPS) -> torch.Tensor:
    """Elementwise scale factor, any matching shape: `bottleneck_many`
    with one pair."""
    return bottleneck_many(((cap, load),), eps=eps)[0]


def bucket_load_bottleneck(rate: torch.Tensor, plan: torch.Tensor,
                           cap: torch.Tensor, *, eps: float = EPS,
                           ordered: Optional[bool] = None):
    """`rate`: (..., F, P) flow rates; `plan`: (..., P, rows, C) int32
    flow indices per link bucket, padded with F; `cap`: (..., P, rows)
    link capacities; the leading axes (none for one point, (B,) for a
    batch) are the same on all three, and each lane's plan indexes its
    own F rows.  Returns `(load, frac)`, both (..., P, rows).

    `ordered=None` resolves to `rate.dtype == float64` (parity mode:
    buckets sum left to right in flow order).  It selects the plain
    version's sum; the kernel always sums in order, which is one of the
    orders an unordered sum may take."""
    if ordered is None:
        ordered = rate.dtype == torch.float64
    if rate.device.type == "cpu":
        return ref.load_bottleneck_ref(rate, plan, cap, eps=eps,
                                       ordered=ordered)
    dev = build.cuda_device("bucket_load_bottleneck", rate)
    dt = build.float_dtype("bucket_load_bottleneck", rate)
    *lead, F, P = rate.shape
    lead = tuple(lead)
    R, C = plan.shape[-2:]
    build.check("rate", rate, device=dev, dtype=dt, shape=lead + (F, P))
    build.check("plan", plan, device=dev, dtype=torch.int32,
                shape=lead + (P, R, C))
    build.check("cap", cap, device=dev, dtype=dt, shape=lead + (P, R))
    load, frac = torch.empty_like(cap), torch.empty_like(cap)
    build.launch("bucket_load_bottleneck", dt, dev, rate.data_ptr(),
                 plan.data_ptr(), cap.data_ptr(), load.data_ptr(),
                 frac.data_ptr(), math.prod(lead), F, P, R, C, eps)
    return load, frac


class SegmentPlan(NamedTuple):
    """A CSR plan of flow-ordered bucket sums: bucket k sums
    `vals.reshape(-1)[entries[offsets[k]:offsets[k + 1]]]`, its entries
    in flow order.  Offsets are positions in the whole `entries`, so a
    slice of `offsets` (one chunk's buckets) keeps the same `entries`."""
    offsets: torch.Tensor     # (K + 1,) int32
    entries: torch.Tensor     # (E,) int32 flat indices into the values


def segment_sum_many(items: Sequence[Tuple[torch.Tensor, SegmentPlan]], *,
                     acc: Optional[Sequence[torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """Flow-ordered bucket sums of 1-6 `(vals, plan)` entries in one
    kernel launch: each plan's (K,) sums of its `vals` (any contiguous
    shape, read flat; every `vals` of one float dtype and on one
    device).  Without `acc` each bucket starts from 0 and new tensors
    are returned; with `acc` (one (K,) tensor an entry) each bucket
    starts from its value there and the sums are written into `acc` in
    place and returned (a chunk of the flow axis continuing the chains of
    the chunks before it).  Bit-equal to `ref.segment_sum_ref` of each
    entry."""
    items = tuple(items)
    n = len(items)
    if not 1 <= n <= MAX_SEG_GROUP:
        raise ValueError(f"segment_sum_many: {n} entries; the kernel takes "
                         f"1-{MAX_SEG_GROUP}")
    if acc is not None and len(acc) != n:
        raise ValueError(f"segment_sum_many: {len(acc)} accumulators for "
                         f"{n} entries")
    first = items[0][0]
    sizes = []
    for k, (vals, plan) in enumerate(items):
        K = plan.offsets.numel() - 1
        sizes.append(K)
        named = [(f"vals[{k}]", vals, first.dtype),
                 (f"offsets[{k}]", plan.offsets, torch.int32),
                 (f"entries[{k}]", plan.entries, torch.int32)]
        if acc is not None:
            named.append((f"acc[{k}]", acc[k], first.dtype))
        for name, t, dtype in named:
            if t.device != first.device:
                raise ValueError(f"{name}: on {t.device}, expected "
                                 f"{first.device}")
            if t.dtype != dtype:
                raise ValueError(f"{name}: dtype {t.dtype}, expected "
                                 f"{dtype}")
        if plan.offsets.dim() != 1 or plan.entries.dim() != 1 or K < 0:
            raise ValueError(f"plan[{k}]: offsets and entries must be 1-D")
        if acc is not None and tuple(acc[k].shape) != (K,):
            raise ValueError(f"acc[{k}]: shape {tuple(acc[k].shape)}, "
                             f"expected {(K,)}")
    if first.device.type == "cpu":
        return tuple(ref.segment_sum_ref(vals, plan.offsets, plan.entries,
                                         acc=None if acc is None else acc[k])
                     for k, (vals, plan) in enumerate(items))
    dev = build.cuda_device("segment_sum", first)
    dt = build.float_dtype("segment_sum", first)
    for k, (vals, plan) in enumerate(items):
        build.check(f"vals[{k}]", vals, device=dev, dtype=dt,
                    shape=vals.shape)
        build.check(f"offsets[{k}]", plan.offsets, device=dev,
                    dtype=torch.int32, shape=plan.offsets.shape)
        build.check(f"entries[{k}]", plan.entries, device=dev,
                    dtype=torch.int32, shape=plan.entries.shape)
        if acc is not None:
            build.check(f"acc[{k}]", acc[k], device=dev, dtype=dt,
                        shape=(sizes[k],))
    outs = tuple(acc) if acc is not None else tuple(
        torch.empty(K, dtype=dt, device=dev) for K in sizes)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    build.launch("segment_sum", dt, dev, ptrs(v for v, _ in items),
                 ptrs(p.offsets for _, p in items),
                 ptrs(p.entries for _, p in items), ptrs(outs),
                 (ctypes.c_int64 * n)(*sizes), n, int(acc is not None))
    return outs


def segment_sum(vals: torch.Tensor, plan: SegmentPlan, *,
                acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`segment_sum_many` with one entry."""
    return segment_sum_many(((vals, plan),),
                            acc=None if acc is None else (acc,))[0]
