"""Link loads and their bottleneck scale min(1, cap / max(load, eps)):

  * `bottleneck` replaces the Pallas kernel
    `repro/kernels/link_load.py::_bottleneck_kernel` (CPU tensors:
    `ref.bottleneck_ref`; CUDA: `netsim_bottleneck`, elementwise);
  * `bucket_load_bottleneck` replaces `_load_bottleneck_kernel`, ECMP's
    fused link-bucket sum + bottleneck (CPU tensors:
    `ref.load_bottleneck_ref`; CUDA: `netsim_bucket_load_bottleneck`,
    one thread per bucket, which gathers the rates itself).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build, ref

EPS = 1e-12


def bottleneck(cap: torch.Tensor, load: torch.Tensor, *,
               eps: float = EPS) -> torch.Tensor:
    """Elementwise scale factor, any matching shape."""
    if cap.device.type == "cpu":
        return ref.bottleneck_ref(cap, load, eps=eps)
    dev = build.cuda_device("bottleneck", cap)
    dt = build.float_dtype("bottleneck", cap)
    build.check("cap", cap, device=dev, dtype=dt, shape=cap.shape)
    build.check("load", load, device=dev, dtype=dt, shape=cap.shape)
    out = torch.empty_like(cap)
    build.launch("bottleneck", dt, dev, cap.data_ptr(), load.data_ptr(),
                 out.data_ptr(), cap.numel(), eps)
    return out


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
