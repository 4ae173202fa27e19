"""NIC Plane Load Balancer (§4.3, Fig. 4) — per-(destination,)plane CC
contexts and the two-stage per-packet plane selection, in torch ops; a
copy of the reference's `core/plb.py`:

  1. **Rate filter** (E2E congestion): planes whose CC allowance falls below
     the current transmission rate are excluded.
  2. **Local queue selection**: among eligible planes, pick the shallowest
     local egress queue (mirrors switch adaptive routing).

State also tracks probe timeouts: consecutive missed RTT probes on a plane
remove it from the eligible set within a few RTTs (§4.4.1), inside the
update itself (no host round-trip).  The random tie-break noise of
`select_plane` comes from a `torch.Generator` the caller passes, where
the reference takes a PRNG key: the two draw different numbers, so only
selections the noise (at most 1e-3) cannot tip compare across packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .congestion import SpxCCConfig, spx_cc_update
from .planes import PlaneConfig


@dataclass
class PLBState:
    rate_allow: torch.Tensor     # (P,) CC rate allowance per plane (0..1)
    ewma_goodput: torch.Tensor   # (P,) smoothed delivered fraction
    local_queue: torch.Tensor    # (P,) NIC egress queue proxy (0..1)
    probe_miss: torch.Tensor     # (P,) int32 consecutive RTT-probe timeouts
    eligible: torch.Tensor       # (P,) bool: in the eligible set


def plb_init(n_planes: int, device="cpu") -> PLBState:
    """A fresh state: every plane eligible at full rate.  The PLB is the
    host-side controller's state (`FailoverController`), so it lives on
    the CPU unless `device` says otherwise."""
    p = n_planes
    return PLBState(
        rate_allow=torch.ones((p,), dtype=torch.float32, device=device),
        ewma_goodput=torch.ones((p,), dtype=torch.float32, device=device),
        local_queue=torch.zeros((p,), dtype=torch.float32, device=device),
        probe_miss=torch.zeros((p,), dtype=torch.int32, device=device),
        eligible=torch.ones((p,), dtype=torch.bool, device=device),
    )


def _select(state: PLBState, noise: torch.Tensor,
            tx_rate) -> torch.Tensor:
    """argmin over planes of the eligible queues plus `noise` (..., P)."""
    ok = state.eligible & (state.rate_allow >= tx_rate)
    # if the rate filter empties the set, fall back to eligible planes
    ok = torch.where(ok.any(), ok, state.eligible)
    q = torch.where(ok, state.local_queue, torch.inf)
    return torch.argmin(q + noise, dim=-1)


def select_plane(state: PLBState, generator: torch.Generator,
                 tx_rate: float | torch.Tensor = 0.25) -> torch.Tensor:
    """Two-stage hierarchical selection for one packet (Fig. 4); the
    tie-break noise, uniform in [0, 1e-3), is drawn from `generator`."""
    noise = torch.rand(state.local_queue.shape, generator=generator,
                       device=state.local_queue.device) * 1e-3
    return _select(state, noise, tx_rate)


def select_planes(state: PLBState, n: int, generator: torch.Generator,
                  tx_rate: float = 0.25) -> torch.Tensor:
    """Vectorized per-packet selection of `n` packets: (n,) plane ids,
    each packet's noise its own row of draws from `generator`."""
    noise = torch.rand((n,) + tuple(state.local_queue.shape),
                       generator=generator,
                       device=state.local_queue.device) * 1e-3
    return _select(state, noise, tx_rate)


def plb_update(state: PLBState, plane_rtt_us: torch.Tensor,
               plane_ecn: torch.Tensor, plane_delivered: torch.Tensor,
               probe_ok: torch.Tensor, plane_queue: torch.Tensor,
               cfg: PlaneConfig = PlaneConfig(),
               cc: SpxCCConfig = SpxCCConfig()) -> PLBState:
    """One control interval (a few RTTs): update per-plane CC contexts from
    their own signals — a congested/failed plane never throttles healthy
    ones (the paper's Global-CC failure mode)."""
    rate = spx_cc_update(state.rate_allow, plane_rtt_us, plane_ecn, cc)
    miss = torch.where(probe_ok, torch.zeros_like(state.probe_miss),
                       state.probe_miss + 1)
    eligible = miss < cfg.probe_timeout
    # a failed plane's allowance collapses; restored planes ramp from ewma
    rate = torch.where(eligible, rate, cc.min_rate)
    just_restored = eligible & ~state.eligible
    rate = torch.where(just_restored, torch.clamp(rate, min=0.5), rate)
    gp = cfg.ewma * state.ewma_goodput + (1 - cfg.ewma) * plane_delivered
    return PLBState(rate_allow=rate, ewma_goodput=gp,
                    local_queue=plane_queue.to(torch.float32),
                    probe_miss=miss, eligible=eligible)


def plane_weights(state: PLBState) -> torch.Tensor:
    """Normalized chunk weights for the collective engine: healthy planes
    weighted by their CC allowance."""
    w = torch.where(state.eligible, state.rate_allow, 0.0)
    s = w.sum()
    p = w.shape[0]
    return torch.where(s > 0, w / torch.clamp(s, min=1e-9),
                       torch.full((p,), 1.0 / p, dtype=w.dtype,
                                  device=w.device))
