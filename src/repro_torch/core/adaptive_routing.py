"""Switch per-packet Adaptive Routing (§4.1): quantized Join-Shortest-Queue
over the ECMP group, extended with Weighted AR (§4.4.2) for remote capacity
asymmetry; in torch ops, a copy of the reference's
`core/adaptive_routing.py`.

These are the pure functions behind both the network simulator's switches
and the `jsq_route` kernel.  Random draws (the JSQ tie-break, the ECMP
hash collisions of `ecmp_fractions`) come from a `torch.Generator` the
caller passes, where the reference takes a PRNG key.
"""
from __future__ import annotations

from typing import Optional

import torch

BIG = 1e30


def quantize_queue(q: torch.Tensor, nbins: int = 16,
                   qmax: float = 1.0) -> torch.Tensor:
    """Quantized queue score (the hardware compares coarse bins, not exact
    byte counts)."""
    return torch.floor(torch.clamp(q / qmax, 0.0, 1.0 - 1e-6) * nbins)


def ar_scores(queues: torch.Tensor, up_mask: torch.Tensor,
              weights: Optional[torch.Tensor] = None,
              nbins: int = 16, qmax: float = 1.0) -> torch.Tensor:
    """Per-port AR score: lower is better.  Weighted AR divides the local
    queue score by the remote-capacity weight so degraded destinations
    attract proportionally less traffic.  Failed ports score BIG."""
    s = quantize_queue(queues, nbins, qmax) + 1.0
    if weights is not None:
        s = s / torch.clamp(weights, min=1e-6)
    return torch.where(up_mask.bool(), s, BIG)


def jsq_select(queues: torch.Tensor, up_mask: torch.Tensor,
               generator: torch.Generator,
               weights: Optional[torch.Tensor] = None,
               nbins: int = 16, qmax: float = 1.0) -> torch.Tensor:
    """Pick one egress port for a packet: min score, random tie-break
    (uniform in [0, 0.5), drawn from `generator`)."""
    s = ar_scores(queues, up_mask, weights, nbins, qmax)
    noise = torch.rand(s.shape, generator=generator, device=s.device) * 0.5
    return torch.argmin(s + noise, dim=-1)


def ecmp_select(flow_hash: torch.Tensor,
                up_mask: torch.Tensor) -> torch.Tensor:
    """Static ECMP: hash modulo the number of *up* ports (rehash on
    failure).  flow_hash: int (...,)."""
    up = up_mask.to(torch.int32)
    n_up = torch.clamp(up.sum(-1), min=1)
    idx = flow_hash % n_up
    # map rank-among-up -> physical port
    order = torch.cumsum(up, -1) - 1
    hit = (order == idx[..., None]) & up_mask.bool()
    return torch.argmax(hit.to(torch.int32), dim=-1)


def spray_fractions(queues: torch.Tensor, up_mask: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    nbins: int = 16, qmax: float = 1.0,
                    temperature: float = 1.0) -> torch.Tensor:
    """Fluid-model AR: the fraction of arriving load each egress port
    receives this slot.  A softmin over AR scores — at temperature->0 it is
    exact JSQ; finite temperature models the quantized/delayed decision."""
    s = ar_scores(queues, up_mask, weights, nbins, qmax)
    logit = -s / max(temperature, 1e-6)
    logit = torch.where(up_mask.bool(), logit, -BIG)
    return torch.softmax(logit, dim=-1)


def ecmp_fractions(n_flows: torch.Tensor, up_mask: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """Fluid ECMP: flows hash uniformly to up ports -> multinomial load
    split (balls into bins), capturing hash-collision imbalance.
    `n_flows` broadcasts against `up_mask`'s leading axes; each row's
    counts are `n_flows` draws from `generator` over its up ports."""
    up = up_mask.to(torch.float32)
    probs = up / torch.clamp(up.sum(-1, keepdim=True), min=1)
    n = torch.broadcast_to(torch.as_tensor(n_flows, device=up.device),
                           probs.shape[:-1])
    rows = probs.reshape(-1, probs.shape[-1])
    counts = torch.zeros_like(rows)
    for i, (p, k) in enumerate(zip(rows, n.reshape(-1).tolist())):
        if int(k) > 0 and float(p.sum()) > 0:
            draws = torch.multinomial(p, int(k), replacement=True,
                                      generator=generator)
            counts[i] = torch.bincount(draws, minlength=p.shape[0]).float()
    counts = counts.reshape(probs.shape)
    return counts / torch.clamp(n.to(torch.float32), min=1)[..., None]
