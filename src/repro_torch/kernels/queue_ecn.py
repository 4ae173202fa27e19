"""Queue integrator and NIC control update: replace the Pallas kernels
`repro/kernels/queue_ecn.py::_queue_update_kernel` and
`::_nic_update_kernel`.

  * `queue_update_many` integrates up to four link arrays (a slot's up
    and down links; on a fat tree, those of both stages) in one launch
    of `netsim_queue_update`
    (elementwise): at giga scale one array is 8,192 links, so a
    launch's latency, not its bytes, costs the time.  `queue_update` is
    its one-entry case.  CPU tensors take `ref.queue_update_ref` per
    entry.
  * `nic_update`: CPU tensors take `ref.nic_update_ref`; CUDA tensors
    launch `netsim_nic_update` (one thread per flow, planes in
    registers).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build, ref

EPS = 1e-12
MAX_GROUP = 4                   # (q, load, cap) entries one launch takes
_NIC_MODES = {"spx": 0, "dcqcn": 1, "agg": 2}


def queue_update_many(
        entries: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
        *, q_cap: float, eps: float = EPS,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """One slot of fluid queue evolution for each of 1-4 `(q, load, cap)`
    entries (each entry of one shape, every tensor of one dtype and on
    one device), in one kernel launch.  Returns `(q_new, util)` per
    entry, in order, each bit-equal to `ref.queue_update_ref` of its
    entry."""
    entries = tuple(entries)
    if not 1 <= len(entries) <= MAX_GROUP:
        raise ValueError(f"queue_update_many: {len(entries)} (q, load, "
                         f"cap) entries; the kernel takes 1-{MAX_GROUP}")
    first = entries[0][0]
    for k, entry in enumerate(entries):
        if len(entry) != 3:
            raise ValueError(f"entry {k}: {len(entry)} tensors, expected "
                             "(q, load, cap)")
        for name, t in zip(("q", "load", "cap"), entry):
            if t.device != first.device:
                raise ValueError(f"{name}[{k}]: on {t.device}, expected "
                                 f"{first.device}")
            if t.dtype != first.dtype:
                raise ValueError(f"{name}[{k}]: dtype {t.dtype}, expected "
                                 f"{first.dtype}")
            if t.shape != entry[0].shape:
                raise ValueError(f"{name}[{k}]: shape {tuple(t.shape)}, "
                                 f"expected {tuple(entry[0].shape)}")
    if first.device.type == "cpu":
        return tuple(ref.queue_update_ref(q, load, cap, q_cap=q_cap,
                                          eps=eps)
                     for q, load, cap in entries)
    dev = build.cuda_device("queue_update", first)
    dt = build.float_dtype("queue_update", first)
    for k, entry in enumerate(entries):
        for name, t in zip(("q", "load", "cap"), entry):
            build.check(f"{name}[{k}]", t, device=dev, dtype=dt,
                        shape=entry[0].shape)
    q_new = tuple(torch.empty_like(q) for q, _, _ in entries)
    utils = tuple(torch.empty_like(q) for q, _, _ in entries)
    n = len(entries)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    build.launch("queue_update", dt, dev, ptrs(e[0] for e in entries),
                 ptrs(e[1] for e in entries), ptrs(e[2] for e in entries),
                 ptrs(q_new), ptrs(utils),
                 (ctypes.c_int64 * n)(*(e[0].numel() for e in entries)), n,
                 q_cap, eps)
    return tuple(zip(q_new, utils))


def queue_update(q: torch.Tensor, load: torch.Tensor, cap: torch.Tensor,
                 *, q_cap: float, eps: float = EPS):
    """One slot of fluid queue evolution.  Returns `(q_new, util)`:
    `queue_update_many` with one entry."""
    return queue_update_many(((q, load, cap),), q_cap=q_cap, eps=eps)[0]


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
