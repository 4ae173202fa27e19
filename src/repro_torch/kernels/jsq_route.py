"""Quantized-JSQ routing, in its fluid and its per-packet form:

  * `pair_fractions`, AR/WAR spine fractions (scores + softmax over
    spines), replaces the Pallas kernel
    `repro/kernels/jsq_route.py::_pair_score_kernel`.  CPU tensors take
    `ref.pair_score_softmax_ref`; CUDA tensors launch
    `netsim_pair_fractions`.  Bytes bound it (three inputs read, one
    output written), though its math (exp, two IEEE divisions, the row
    chains) takes nearly as long.  For S <= 32 spines, every registry
    fabric, a row is a group of lanes of one warp, one element a lane,
    so the loads stay coalesced; each warp stages its tile in shared
    memory, where one lane a row takes the row max and the left-to-right
    row sum once for the whole row.  Wider rows (S > 32) take one thread
    per element, each walking its row in shared memory.
  * `jsq_route`, the switch's per-packet egress port, replaces
    `_jsq_kernel`.  CPU tensors take `ref.jsq_route_ref`; CUDA tensors
    launch `netsim_jsq_route`: the port scores in shared memory, a
    group of 16 lanes of one warp a packet, each lane walking every
    16th port, then a shuffle reduction that keeps the lower port of
    two equal values (argmin's first index).
"""
from __future__ import annotations

import torch

from . import build, ref


def pair_fractions(q: torch.Tensor, cap: torch.Tensor, w: torch.Tensor, *,
                   nbins: int = 16, temperature: float = 1.0,
                   qmax: float = 8.0) -> torch.Tensor:
    """`q`/`cap`/`w`: (..., S) summed pair queue, path capacity and path
    weight.  Returns (..., S) fractions summing to 1 over alive spines."""
    if q.device.type == "cpu":
        return ref.pair_score_softmax_ref(q, cap, w, nbins=nbins,
                                          temperature=temperature,
                                          qmax=qmax)
    dev = build.cuda_device("pair_fractions", q)
    dt = build.float_dtype("pair_fractions", q)
    shape = tuple(q.shape)
    for name, t in (("q", q), ("cap", cap), ("w", w)):
        build.check(name, t, device=dev, dtype=dt, shape=shape)
    S = shape[-1]
    if not 1 <= S <= 1024:
        raise ValueError(f"pair_fractions: {S} spines; the kernel takes "
                         "1-1024")
    out = torch.empty_like(q)
    build.launch("pair_fractions", dt, dev, q.data_ptr(), cap.data_ptr(),
                 w.data_ptr(), out.data_ptr(), q.numel() // S, S,
                 1 - 1e-9, qmax, float(nbins), temperature)
    return out


def hash32(name: str, pkt_hash: torch.Tensor) -> torch.Tensor:
    """`pkt_hash` as a contiguous 32-bit tensor whose bits are the uint32
    hash (the kernels read it as uint32): int32 and uint32 pass as they
    are, other integer types are reduced mod 2**32."""
    if pkt_hash.dtype in (torch.int32, torch.uint32):
        return pkt_hash.contiguous()
    if pkt_hash.dtype.is_floating_point or pkt_hash.dtype == torch.bool:
        raise ValueError(f"{name}: pkt_hash dtype {pkt_hash.dtype}; "
                         "expected an integer type")
    h = pkt_hash.to(torch.int64) & 0xFFFFFFFF
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def jsq_route(queues: torch.Tensor, up_mask: torch.Tensor,
              weights: torch.Tensor, pkt_hash: torch.Tensor, *,
              nbins: int = 16, qmax: float = 1.0) -> torch.Tensor:
    """`queues`/`up_mask`/`weights`: (ports,); `pkt_hash`: (N,) 32-bit
    hashes.  Returns the (N,) int32 egress port per packet (see
    `ref.jsq_route_ref`); operands are cast to float32, as the Pallas
    entry point casts them."""
    if queues.device.type == "cpu":
        return ref.jsq_route_ref(queues, up_mask, weights, pkt_hash,
                                 nbins=nbins, qmax=qmax)
    dev = build.cuda_device("jsq_route", queues)
    (ports,) = queues.shape
    (N,) = pkt_hash.shape
    if not 1 <= ports <= 8192:
        raise ValueError(f"jsq_route: {ports} ports; the kernel takes "
                         "1-8192")
    q, up, w = (t.to(torch.float32).contiguous()
                for t in (queues, up_mask, weights))
    h = hash32("jsq_route", pkt_hash)
    for name, t in (("queues", q), ("up_mask", up), ("weights", w)):
        build.check(name, t, device=dev, dtype=torch.float32,
                    shape=(ports,))
    build.check("pkt_hash", h, device=dev, dtype=h.dtype, shape=(N,))
    out = torch.empty((N,), dtype=torch.int32, device=dev)
    build.launch("jsq_route", torch.float32, dev, q.data_ptr(),
                 up.data_ptr(), w.data_ptr(), h.data_ptr(), out.data_ptr(),
                 N, ports, qmax, float(nbins), 1.0 - 1e-6)
    return out
