"""Congestion-control rate laws (§4.2): SPX CC and a DCQCN baseline,
in torch ops; a copy of the reference's `core/congestion.py`.

Both are pure, vectorizable update rules shared by the NIC PLB contexts
and the network simulator.  Rates are normalized to line rate (1.0 =
100 %).

SPX CC design points from the paper:
  * ECN marks only when in-network load balancing is exhausted; the sender
    reacts *only* to those marks (no reaction to transient micro-bursts that
    adaptive routing resolves sub-RTT).
  * RTT probes guide precise rate adjustment around a target delay.
  * Fast additive recovery so a collective recovers within itself.

DCQCN baseline: classic alpha-based multiplicative decrease on any ECN,
slow byte-counter recovery — the "overreacts to synchronized bursts"
behaviour evaluated in §6.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SpxCCConfig:
    target_rtt_us: float = 8.0     # jitter-free fabric RTT target
    base_rtt_us: float = 4.0
    md_factor: float = 0.7         # multiplicative decrease on ECN
    ai_rate: float = 0.05          # additive increase per update (fast)
    rtt_gain: float = 0.15         # proportional RTT-error correction
    min_rate: float = 0.01


@dataclass(frozen=True)
class DcqcnConfig:
    alpha_g: float = 0.0625        # alpha EWMA gain
    rate_ai: float = 0.005         # slow additive increase
    min_rate: float = 0.01


def spx_cc_update(rate: torch.Tensor, rtt_us: torch.Tensor,
                  ecn: torch.Tensor,
                  cfg: SpxCCConfig = SpxCCConfig()) -> torch.Tensor:
    """rate/rtt/ecn: same-shape tensors. ecn in [0,1] = marked fraction.

    Only ECN (LB-exhaustion signal) triggers decrease; RTT error trims the
    rate toward the target delay; otherwise fast additive increase."""
    rtt_err = (rtt_us - cfg.target_rtt_us) / cfg.target_rtt_us
    decrease = rate * (cfg.md_factor + (1.0 - cfg.md_factor) *
                       torch.clamp(1.0 - ecn, 0.0, 1.0))
    trimmed = rate * (1.0 - cfg.rtt_gain * torch.clamp(rtt_err, 0.0, 2.0))
    increase = torch.clamp(rate + cfg.ai_rate, max=1.0)
    out = torch.where(ecn > 0.0, decrease,
                      torch.where(rtt_err > 0.25, trimmed, increase))
    return torch.clamp(out, cfg.min_rate, 1.0)


def dcqcn_update(rate: torch.Tensor, alpha: torch.Tensor,
                 ecn: torch.Tensor, cfg: DcqcnConfig = DcqcnConfig()):
    """Returns (rate', alpha'). Cuts on any ECN; recovers slowly."""
    alpha_new = (1.0 - cfg.alpha_g) * alpha + cfg.alpha_g * (ecn > 0)
    cut = rate * (1.0 - alpha_new / 2.0)
    grow = torch.clamp(rate + cfg.rate_ai, max=1.0)
    rate_new = torch.where(ecn > 0, cut, grow)
    return torch.clamp(rate_new, cfg.min_rate, 1.0), alpha_new
