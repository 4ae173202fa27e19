"""Fault injection and failover control (§4.4, §6.5–6.6); a copy of the
reference's `core/fault_tolerance.py`.

* Poisson link-flap schedules with the paper's MTBF methodology (10
  flaps/min fleet-wide, 10 s flap duration; concurrent-failure count is
  Poisson-distributed), draw for draw, so that both packages lower a
  `poisson_flap` fault to the same schedule, with the helpers Fig 14
  composes its runs by: the Poisson pmf of the number of concurrently
  failed links and the links down at a time.
* `FailoverController` — host-side controller that feeds plane-health
  signals into the PLB update (float32 tensors on the CPU, as the
  reference runs it) and tracks recovery latency in steps, mirroring the
  <3 ms hardware PLB vs ~1 s software LB comparison.
* Elastic mesh planning for permanent node loss (checkpoint/restart path).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .planes import PlaneConfig
from .plb import PLBState, plane_weights, plb_init, plb_update


@dataclass(frozen=True)
class FlapEvent:
    link: int
    t_down: float
    t_up: float


def poisson_flaps(rng: np.random.Generator, n_links: int,
                  flaps_per_minute: float, duration_s: float,
                  horizon_s: float) -> List[FlapEvent]:
    """Fleet-wide flap rate -> per-link exponential inter-arrival times,
    sorted by the time each link goes down."""
    lam_per_link = flaps_per_minute / 60.0 / max(n_links, 1)
    events: List[FlapEvent] = []
    for link in range(n_links):
        t = 0.0
        while True:
            t += rng.exponential(1.0 / max(lam_per_link, 1e-12))
            if t >= horizon_s:
                break
            events.append(FlapEvent(link, t, t + duration_s))
    events.sort(key=lambda e: e.t_down)
    return events


def concurrent_failure_pmf(flaps_per_minute: float, duration_s: float,
                           max_k: int = 10) -> np.ndarray:
    """Poisson pmf over the number of concurrently failed links, 0 to
    `max_k`, renormalized: the weights that compose per-k runs into an
    expected P99 completion time."""
    lam = flaps_per_minute / 60.0 * duration_s
    k = np.arange(max_k + 1)
    logp = k * np.log(max(lam, 1e-12)) - lam - \
        np.array([np.sum(np.log(np.arange(1, kk + 1))) if kk else 0.0
                  for kk in k])
    p = np.exp(logp)
    return p / p.sum()


def links_down_at(events: List[FlapEvent], t: float) -> List[int]:
    """The links of `events` down at time `t`."""
    return [e.link for e in events if e.t_down <= t < e.t_up]


# ---------------------------------------------------------------------------
# failover controller (host side; drives the PLB update)
# ---------------------------------------------------------------------------

@dataclass
class RecoveryRecord:
    plane: int
    fail_step: int
    converged_step: Optional[int] = None

    @property
    def recovery_steps(self) -> Optional[int]:
        if self.converged_step is None:
            return None
        return self.converged_step - self.fail_step


class FailoverController:
    """Threads PLBState through the train loop; injects plane failures and
    measures convergence (steps until weights match plane health)."""

    def __init__(self, cfg: PlaneConfig):
        self.cfg = cfg
        self.state: PLBState = plb_init(cfg.n_planes)
        self.plane_up = np.ones(cfg.n_planes, bool)
        self.step = 0
        self.records: List[RecoveryRecord] = []
        self._open: Dict[int, RecoveryRecord] = {}

    def fail_plane(self, plane: int) -> None:
        if self.plane_up[plane]:
            self.plane_up[plane] = False
            rec = RecoveryRecord(plane, self.step)
            self.records.append(rec)
            self._open[plane] = rec

    def restore_plane(self, plane: int) -> None:
        self.plane_up[plane] = True

    def on_step(self, plane_queue: Optional[np.ndarray] = None,
                plane_rtt_us: Optional[np.ndarray] = None) -> np.ndarray:
        """Advance one step; returns current plane weights (numpy)."""
        p = self.cfg.n_planes
        up = torch.from_numpy(self.plane_up.copy())
        f32 = torch.float32
        rtt = (torch.as_tensor(np.asarray(plane_rtt_us), dtype=f32)
               if plane_rtt_us is not None
               else torch.where(up, 6.0, 1e3).to(f32))
        ecn = torch.zeros((p,), dtype=f32)
        delivered = torch.where(up, 1.0, 0.0).to(f32)
        queue = (torch.as_tensor(np.asarray(plane_queue), dtype=f32)
                 if plane_queue is not None
                 else torch.where(up, 0.1, 1.0).to(f32))
        self.state = plb_update(self.state, rtt, ecn, delivered, up, queue,
                                self.cfg)
        self.step += 1
        w = plane_weights(self.state).numpy()
        # convergence check for open failures: failed plane weight ~ 0
        for plane, rec in list(self._open.items()):
            if not self.plane_up[plane] and w[plane] < 1e-3:
                rec.converged_step = self.step
                del self._open[plane]
        return w

    def weights(self) -> np.ndarray:
        return plane_weights(self.state).numpy()


# ---------------------------------------------------------------------------
# elastic scaling (permanent failures -> re-mesh plan)
# ---------------------------------------------------------------------------

def elastic_mesh_plan(n_devices: int, model_parallel: int,
                      pods: int = 1) -> Tuple[int, ...]:
    """Largest (pod, data, model) mesh that fits the surviving devices,
    keeping TP intact and shrinking DP — the checkpoint-restart re-mesh
    used after permanent node loss."""
    if n_devices < model_parallel:
        raise ValueError("fewer devices than one TP group")
    per_pod = n_devices // pods
    dp = per_pod // model_parallel
    if dp < 1:
        raise ValueError("cannot form a single DP replica per pod")
    if pods > 1:
        return (pods, dp, model_parallel)
    return (dp, model_parallel)
