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
    (CPU tensors: `ref.segment_sum_ref`; CUDA: `netsim_segment_sum`, a
    group of lanes of one warp a bucket, its width picked per entry
    from the plan's widest bucket and mean).  CUDA's scatter adds keep
    no order, so the kernel is what keeps a sparse run bit-equal to the
    dense one and to the NumPy engine's `np.add.at`.  An entry may take
    caps: the launch then also writes the bottleneck scale of its sums
    (`ref.bottleneck_ref`), as `bucket_load_bottleneck` does for dense
    ECMP, so a sparse slot scales its access links, and under ECMP its
    fabric links, without a `bottleneck` launch.
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
    slice of `offsets` (one chunk's buckets) keeps the same `entries`.
    `width` is the most entries of any bucket (every chunk's, every
    lane's), a host int the kernel picks its lanes a bucket from; 0
    when unknown (the kernel then goes by the mean)."""
    offsets: torch.Tensor     # (K + 1,) int32
    entries: torch.Tensor     # (E,) int32 flat indices into the values
    width: int = 0


def segment_lanes_log2(K: int, E: int, width: int) -> int:
    """log2 of the lanes of one warp the kernel gives each bucket of an
    entry of `K` buckets, `E` entries in all (a chunked plan's: every
    chunk's) and widest bucket `width` (0: unknown).  It only shapes the
    work: the sums are the same at any width.  Timed on the H100 over
    the giga and training-schedule plans at every width from 1 to 32
    (`benchmarks/torch_segment_sum_designs.py`; PERF.md, section 6):
    a lane alone where buckets are short (under 2 entries on average,
    none over 16: the AR pair plan), 16 lanes where they are long (8 or
    more on average and some of 64 or more: a crowded schedule's access
    plan), else 2 lanes (the giga access and link plans, and a skewed
    plan of mostly empty buckets, whose empty ones cost warps)."""
    if E < 2 * K and width <= 16:
        return 0
    if E >= 8 * K and width >= 64:
        return 4
    return 1


def segment_sum_many(items: Sequence[Tuple[torch.Tensor, SegmentPlan]], *,
                     acc: Optional[Sequence[torch.Tensor]] = None,
                     caps: Optional[Sequence[Optional[torch.Tensor]]] = None,
                     eps: float = EPS):
    """Flow-ordered bucket sums of 1-6 `(vals, plan)` entries in one
    kernel launch: each plan's (K,) sums of its `vals` (any contiguous
    shape, read flat; every `vals` of one float dtype and on one
    device).  Without `acc` each bucket starts from 0 and new tensors
    are returned; with `acc` (one (K,) tensor an entry) each bucket
    starts from its value there and the sums are written into `acc` in
    place and returned (a chunk of the flow axis continuing the chains of
    the chunks before it).  Bit-equal to `ref.segment_sum_ref` of each
    entry.

    Without `caps` returns the tuple of sums.  With `caps` (one (K,)
    tensor or None an entry) returns `(sums, scales)`: `scales[k]` is
    `min(1, caps[k] / max(sums[k], eps))`, bit-equal to
    `ref.bottleneck_ref(caps[k], sums[k])`, or None where `caps[k]` is
    None."""
    items = tuple(items)
    n = len(items)
    if not 1 <= n <= MAX_SEG_GROUP:
        raise ValueError(f"segment_sum_many: {n} entries; the kernel takes "
                         f"1-{MAX_SEG_GROUP}")
    if acc is not None and len(acc) != n:
        raise ValueError(f"segment_sum_many: {len(acc)} accumulators for "
                         f"{n} entries")
    if caps is not None and len(caps) != n:
        raise ValueError(f"segment_sum_many: {len(caps)} caps for {n} "
                         "entries")
    cap_of = tuple(caps) if caps is not None else (None,) * n
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
        if cap_of[k] is not None:
            named.append((f"caps[{k}]", cap_of[k], first.dtype))
        for name, t, dtype in named:
            if t.device != first.device:
                raise ValueError(f"{name}: on {t.device}, expected "
                                 f"{first.device}")
            if t.dtype != dtype:
                raise ValueError(f"{name}: dtype {t.dtype}, expected "
                                 f"{dtype}")
        if plan.offsets.dim() != 1 or plan.entries.dim() != 1 or K < 0:
            raise ValueError(f"plan[{k}]: offsets and entries must be 1-D")
        for name, t in ((f"acc[{k}]", None if acc is None else acc[k]),
                        (f"caps[{k}]", cap_of[k])):
            if t is not None and tuple(t.shape) != (K,):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                                 f"expected {(K,)}")
    if first.device.type == "cpu":
        sums = tuple(ref.segment_sum_ref(vals, plan.offsets, plan.entries,
                                         acc=None if acc is None else acc[k])
                     for k, (vals, plan) in enumerate(items))
        if caps is None:
            return sums
        return sums, tuple(None if c is None else
                           ref.bottleneck_ref(c, s, eps=eps)
                           for c, s in zip(cap_of, sums))
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
        if cap_of[k] is not None:
            build.check(f"caps[{k}]", cap_of[k], device=dev, dtype=dt,
                        shape=(sizes[k],))
    outs = tuple(acc) if acc is not None else tuple(
        torch.empty(K, dtype=dt, device=dev) for K in sizes)
    scales = tuple(None if c is None else torch.empty_like(c)
                   for c in cap_of)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(None if t is None else t.data_ptr()
                                       for t in ts))

    def ints(xs):
        return (ctypes.c_int64 * n)(*xs)

    lanes = (ctypes.c_int * n)(*(
        segment_lanes_log2(K, p.entries.numel(), p.width)
        for K, (_, p) in zip(sizes, items)))
    build.launch("segment_sum", dt, dev, ptrs(v for v, _ in items),
                 ptrs(p.offsets for _, p in items),
                 ptrs(p.entries for _, p in items), ptrs(outs),
                 ptrs(cap_of), ptrs(scales), ints(sizes), lanes, n,
                 int(acc is not None), eps)
    return outs if caps is None else (outs, scales)


def segment_sum(vals: torch.Tensor, plan: SegmentPlan, *,
                acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`segment_sum_many` with one entry."""
    return segment_sum_many(((vals, plan),),
                            acc=None if acc is None else (acc,))[0]
