"""Queue integrator and NIC control update: replace the Pallas kernels
`repro/kernels/queue_ecn.py::_queue_update_kernel` and
`::_nic_update_kernel`.

CPU tensors take `ref.queue_update_ref` / `ref.nic_update_ref`; CUDA
tensors launch `netsim_queue_update` (elementwise, two outputs) and
`netsim_nic_update` (one thread per flow, planes in registers).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

EPS = 1e-12
_NIC_MODES = {"spx": 0, "dcqcn": 1, "agg": 2}


def queue_update(q: torch.Tensor, load: torch.Tensor, cap: torch.Tensor,
                 *, q_cap: float, eps: float = EPS):
    """One slot of fluid queue evolution.  Returns `(q_new, util)`."""
    if q.device.type == "cpu":
        return ref.queue_update_ref(q, load, cap, q_cap=q_cap, eps=eps)
    dev = build.cuda_device("queue_update", q)
    dt = build.float_dtype("queue_update", q)
    for name, t in (("q", q), ("load", load), ("cap", cap)):
        build.check(name, t, device=dev, dtype=dt, shape=q.shape)
    q_new = torch.empty_like(q)
    util = torch.empty_like(q)
    build.launch("queue_update", dt, dev, q.data_ptr(), load.data_ptr(),
                 cap.data_ptr(), q_new.data_ptr(), util.data_ptr(),
                 q.numel(), q_cap, eps)
    return q_new, util


def nic_update(qmean: torch.Tensor, rate: torch.Tensor,
               alpha: torch.Tensor, esr: torch.Tensor, *, mode: str,
               base_rtt_us: float, slot_us: float, ecn_thresh: float,
               target_rtt_us: float, min_rate: float, md: float,
               ai: float, rtt_gain: float, dcqcn_ai: float,
               alpha_g: float):
    """Fused RTT/ECN + CC rate step.  `qmean`/`rate`/`alpha`: (F, P);
    `esr`: (F, 1) bool.  Returns `(rtt, ecn, rate_new, alpha_new)`."""
    if mode not in _NIC_MODES:
        raise ValueError(f"unknown nic-update mode {mode!r}")
    if qmean.device.type == "cpu":
        return ref.nic_update_ref(
            qmean, rate, alpha, esr, mode=mode, base_rtt_us=base_rtt_us,
            slot_us=slot_us, ecn_thresh=ecn_thresh,
            target_rtt_us=target_rtt_us, min_rate=min_rate, md=md, ai=ai,
            rtt_gain=rtt_gain, dcqcn_ai=dcqcn_ai, alpha_g=alpha_g)
    dev = build.cuda_device("nic_update", qmean)
    dt = build.float_dtype("nic_update", qmean)
    F, P = qmean.shape
    for name, t in (("qmean", qmean), ("rate", rate), ("alpha", alpha)):
        build.check(name, t, device=dev, dtype=dt, shape=(F, P))
    build.check("esr", esr, device=dev, dtype=torch.bool, shape=(F, 1))
    if not 1 <= P <= 8:
        raise ValueError(f"nic_update: {P} planes; the kernel takes 1-8")
    consts = (ctypes.c_double * 14)(
        base_rtt_us, slot_us, 0.5, ecn_thresh, 4 * ecn_thresh,
        target_rtt_us, min_rate, md, 1 - md, ai, rtt_gain, dcqcn_ai,
        alpha_g, 1 - alpha_g)
    outs = [torch.empty_like(qmean) for _ in range(4)]
    build.launch("nic_update", dt, dev, qmean.data_ptr(), rate.data_ptr(),
                 alpha.data_ptr(), esr.data_ptr(),
                 *(o.data_ptr() for o in outs), F, P, _NIC_MODES[mode],
                 consts)
    return tuple(outs)
