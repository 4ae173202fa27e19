"""Link loads and their bottleneck scale min(1, cap / max(load, eps)):

  * `bottleneck` and `bottleneck_many` replace the Pallas kernel
    `repro/kernels/link_load.py::_bottleneck_kernel` (CPU tensors:
    `ref.bottleneck_ref`; CUDA: `netsim_bottleneck`, elementwise).  One
    call of the kernel is a few thousand elements a slot, so its launch,
    not its bytes, costs the time: `bottleneck_many` scales up to four
    (cap, load) pairs in one launch, and `bottleneck` is its one-pair
    case;
  * `bucket_load_bottleneck` replaces `_load_bottleneck_kernel`, ECMP's
    fused link-bucket sum + bottleneck (CPU tensors:
    `ref.load_bottleneck_ref`; CUDA: `netsim_bucket_load_bottleneck`,
    one thread per bucket, which gathers the rates itself).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import build, ref

EPS = 1e-12
MAX_GROUP = 4                   # (cap, load) pairs one launch takes


def bottleneck_many(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
                    eps: float = EPS) -> Tuple[torch.Tensor, ...]:
    """`min(1, cap / max(load, eps))` for each of 1-4 `(cap, load)` pairs
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
    """`rate`: (F, P) flow rates; `plan`: (P, rows, C) int32 flow indices
    per link bucket, padded with F; `cap`: (P, rows) link capacities.
    Returns `(load, frac)`, both (P, rows).

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
    F, P = rate.shape
    _, R, C = plan.shape
    build.check("rate", rate, device=dev, dtype=dt, shape=(F, P))
    build.check("plan", plan, device=dev, dtype=torch.int32,
                shape=(P, R, C))
    build.check("cap", cap, device=dev, dtype=dt, shape=(P, R))
    load, frac = torch.empty_like(cap), torch.empty_like(cap)
    build.launch("bucket_load_bottleneck", dt, dev, rate.data_ptr(),
                 plan.data_ptr(), cap.data_ptr(), load.data_ptr(),
                 frac.data_ptr(), F, P, R, C, eps)
    return load, frac
