"""Poisson link-flap schedules with the paper's MTBF methodology
(§6.6): a fleet-wide flap rate becomes per-link exponential
inter-arrival times.  A copy of the reference's
`core/fault_tolerance.py::poisson_flaps`, draw for draw, so that both
packages lower a `poisson_flap` fault to the same schedule."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


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
