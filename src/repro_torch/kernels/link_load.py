"""Per-link bottleneck scale min(1, cap / max(load, eps)): replaces the
Pallas kernel `repro/kernels/link_load.py::_bottleneck_kernel`.

CPU tensors take `ref.bottleneck_ref`; CUDA tensors launch
`netsim_bottleneck` (elementwise, grid-stride).
"""
from __future__ import annotations

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
