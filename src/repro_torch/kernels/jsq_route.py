"""AR/WAR spine fractions (quantized-JSQ scores + softmax over spines):
replaces the Pallas kernel `repro/kernels/jsq_route.py::_pair_score_kernel`.

CPU tensors take `ref.pair_score_softmax_ref`; CUDA tensors launch
`netsim_pair_fractions` (one thread per (row, spine) element, whole rows
per block; the row max and the left-to-right row sum go through shared
memory).
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
