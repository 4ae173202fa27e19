"""Simulation parameters of one run, and the two ways an ECMP path
assignment leaves a dead path: the seeded re-hash and the fast-reroute
walk down a precomputed backup table."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.trace import TraceSpec


@dataclass
class SimConfig:
    slots: int = 2000
    slot_us: float = 10.0
    routing: str = "ar"          # 'ar' | 'war' | 'ecmp'
    nic: str = "spx"             # 'spx' | 'dcqcn' | 'global' | 'esr' | 'swlb'
    base_rtt_us: float = 4.0
    warmup_frac: float = 0.25
    sw_lb_delay_ms: float = 1000.0
    seed: int = 0
    record_every: int = 1
    trace: TraceSpec = TraceSpec()

    def sw_lb_delay_slots(self) -> int:
        """swlb reaction delay in slots (0 for hardware-PLB stacks)."""
        return (int(self.sw_lb_delay_ms * 1000 / self.slot_us)
                if self.nic == "swlb" else 0)


def rehash_dead_assign(alive: np.ndarray, assign: np.ndarray,
                       rng: np.random.Generator, n_spines: int
                       ) -> np.ndarray:
    """Re-hash ECMP assignments whose path died onto a surviving path
    (`n_spines` is the path-axis size: spines on leaf_spine, cores on
    fat_tree).

    `alive`: (F, P, J) path liveness; `assign`: (F, P) current path per
    (flow, plane).  Draws from `rng` only when some assignment is dead
    with an alive alternative, so a replay at each capacity-change
    boundary (`events.ecmp_assign_segments`) consumes the stream draw for
    draw as a per-slot check would."""
    cur = np.take_along_axis(alive, assign[:, :, None], axis=2)[:, :, 0]
    bad = ~cur & alive.any(-1)
    if bad.any():
        # deterministic re-hash: first alive spine after a seeded offset
        off = rng.integers(0, n_spines, size=assign.shape)
        order = (off[:, :, None] + np.arange(n_spines)[None, None]) \
            % n_spines
        alive_ord = np.take_along_axis(alive, order, axis=2)
        first = np.argmax(alive_ord, axis=2)
        new = np.take_along_axis(order, first[:, :, None],
                                 axis=2)[:, :, 0]
        assign = np.where(bad, new, assign)
    return assign


def backup_reassign(alive: np.ndarray, assign: np.ndarray,
                    backup: np.ndarray) -> np.ndarray:
    """Fast-reroute: walk each dead assignment down the precomputed
    backup chain (`backup[j]` = successor path of j, a single J-cycle;
    see `topology.backup_path_table`) to the first alive path.  RNG-free
    and deterministic.

    `alive`: (F, P, J) path liveness as *routing* sees it; `assign`:
    (F, P).  Entries whose whole path axis is dead keep their
    assignment (the re-hash's contract)."""
    cur = np.take_along_axis(alive, assign[:, :, None], axis=2)[:, :, 0]
    bad = ~cur & alive.any(-1)
    if not bad.any():
        return assign
    new = assign.copy()
    for _ in range(alive.shape[-1] - 1):
        dead_now = ~np.take_along_axis(alive, new[:, :, None],
                                       axis=2)[:, :, 0]
        step = bad & dead_now
        if not step.any():
            break
        new = np.where(step, backup[new], new)
    return np.where(bad, new, assign)
