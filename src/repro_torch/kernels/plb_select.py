"""The NIC's plane load balancer (the paper's PLB, Fig. 4), in its fluid
and its per-packet form:

  * `plane_split` replaces the Pallas kernel
    `repro/kernels/plb_select.py::_plane_split_kernel`.  CPU tensors
    take `ref.plane_split_ref`; CUDA tensors launch `netsim_plane_split`
    (one thread per flow), whose planes are a template parameter for
    P = 1, 2 and 4 and read at run time for other P.
  * `plb_select`, the plane of each packet, replaces `_plb_kernel`.
    CPU tensors take `ref.plb_select_ref`; CUDA tensors launch
    `netsim_plb_select` (one thread per packet, planes in registers).
"""
from __future__ import annotations

import torch

from . import build, ref
from .jsq_route import hash32

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


def plb_select(rate_allow: torch.Tensor, eligible: torch.Tensor,
               local_queue: torch.Tensor, tx_rate: torch.Tensor,
               pkt_hash: torch.Tensor) -> torch.Tensor:
    """`rate_allow`/`eligible`/`local_queue`: (P,); `tx_rate`/`pkt_hash`:
    (N,).  Returns the (N,) int32 plane per packet (see
    `ref.plb_select_ref`); operands are cast to float32, as the Pallas
    entry point casts them."""
    if rate_allow.device.type == "cpu":
        return ref.plb_select_ref(rate_allow, eligible, local_queue,
                                  tx_rate, pkt_hash)
    dev = build.cuda_device("plb_select", rate_allow)
    (P,) = rate_allow.shape
    (N,) = pkt_hash.shape
    if not 1 <= P <= 8:
        raise ValueError(f"plb_select: {P} planes; the kernel takes 1-8")
    rate, elig, queue = (t.to(torch.float32).contiguous()
                         for t in (rate_allow, eligible, local_queue))
    tx = tx_rate.to(torch.float32).contiguous()
    h = hash32("plb_select", pkt_hash)
    for name, t in (("rate_allow", rate), ("eligible", elig),
                    ("local_queue", queue)):
        build.check(name, t, device=dev, dtype=torch.float32, shape=(P,))
    build.check("tx_rate", tx, device=dev, dtype=torch.float32, shape=(N,))
    build.check("pkt_hash", h, device=dev, dtype=h.dtype, shape=(N,))
    out = torch.empty((N,), dtype=torch.int32, device=dev)
    build.launch("plb_select", torch.float32, dev, rate.data_ptr(),
                 elig.data_ptr(), queue.data_ptr(), tx.data_ptr(),
                 h.data_ptr(), out.data_ptr(), N, P)
    return out
