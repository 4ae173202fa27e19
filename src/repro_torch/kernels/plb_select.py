"""NIC plane split (the fluid form of the paper's PLB, Fig. 4): replaces
the Pallas kernel `repro/kernels/plb_select.py::_plane_split_kernel`.

CPU tensors take `ref.plane_split_ref`; CUDA tensors launch
`netsim_plane_split` (one thread per flow, planes in registers).
"""
from __future__ import annotations

import torch

from . import build, ref

_MODES = {"spx": 0, "dcqcn": 1, "agg": 2, "swlb": 3}


def plane_split(rate: torch.Tensor, eligible: torch.Tensor,
                demand: torch.Tensor, *, mode: str,
                min_rate: float = 0.0) -> torch.Tensor:
    """`rate`/`eligible`: (F, P) allowance and PLB eligibility (bool);
    `demand`: (F,).  Returns the (F, P) offered split for `mode`
    (see `ref.plane_split_ref`)."""
    if mode not in _MODES:
        raise ValueError(f"unknown plane-split mode {mode!r}")
    if rate.device.type == "cpu":
        return ref.plane_split_ref(rate, eligible, demand, mode=mode,
                                   min_rate=min_rate)
    dev = build.cuda_device("plane_split", rate)
    dt = build.float_dtype("plane_split", rate)
    F, P = rate.shape
    build.check("rate", rate, device=dev, dtype=dt, shape=(F, P))
    build.check("eligible", eligible, device=dev, dtype=torch.bool,
                shape=(F, P))
    build.check("demand", demand, device=dev, dtype=dt, shape=(F,))
    if not 1 <= P <= 8:
        raise ValueError(f"plane_split: {P} planes; the kernel takes 1-8")
    out = torch.empty_like(rate)
    build.launch("plane_split", dt, dev, rate.data_ptr(),
                 eligible.data_ptr(), demand.data_ptr(), out.data_ptr(),
                 F, P, _MODES[mode], min_rate + 1e-9, 1.0 / P)
    return out
