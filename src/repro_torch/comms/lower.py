"""Lower a planned schedule to fabric flows + a demand-multiplier
timeline (a copy of the reference's `comms/lower.py`).

Rank layout over the tenant's hosts is tp-fastest:
``rank(t, d, p) = t + tp * (d + dp * p)``, so TP groups land on
adjacent hosts (same leaf when possible — NVLink-domain locality),
DP peers stride across leaves, and PP stages stride furthest.

Two flow classes come out:

  * **closed transfers** (lane 0, finite `bytes_total`, staggered
    `start_slot`): the per-step DP ring streams, MoE all2all exchanges,
    and checkpoint writes.  They are *not* window-gated — under
    congestion they simply finish late, which is exactly the step-time
    inflation signal the resiliency experiment measures.
  * **pulsed open-loop streams** (lanes >= 1, infinite bytes): PP
    activation / gradient edges and TP collective streams, gated by the
    fwd / bwd / compute windows of the `(T, K)` phase-multiplier
    timeline (lane 0 is the global always-1.0 lane).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.netsim.fabric import Flow

from .schedule import (BWD_LANE, COMPUTE_LANE, FWD_LANE,
                       LANES_PER_SCHEDULE, Phase, TrainSchedule,
                       plan_schedule)


def lower_schedule(w, hosts: List[int], topo, sim, group: str,
                   lane_offset: int = 0
                   ) -> Tuple[List[Flow], np.ndarray, TrainSchedule]:
    """WorkloadSpec(kind='schedule') -> (flows, phase_mult, schedule).

    `phase_mult` is `(sim.slots, LANES_PER_SCHEDULE)` with this
    schedule's lanes in local positions 1..3; flows already carry
    `lane_offset`-adjusted global lane ids so multiple schedules can
    stack timelines column-wise (`scenarios.compile.build_flows`).
    """
    ss = w.schedule
    plan = plan_schedule(ss, sim.slot_us, sim.slots,
                         start_slot=w.start_slot, n_planes=topo.n_planes)
    n_ranks = ss.n_ranks
    if len(hosts) < n_ranks:
        raise ValueError(
            f"schedule workload for tenant {w.tenant!r} needs "
            f"{n_ranks} ranks but the tenant owns {len(hosts)} hosts")
    hh = [int(h) for h in hosts[:n_ranks]]
    dp, tp, pp = ss.dp, ss.tp, ss.pp

    def rank(t: int, d: int, p: int) -> int:
        return t + tp * (d + dp * p)

    lane = lambda k: lane_offset + k  # noqa: E731
    flows: List[Flow] = []

    # --- pulsed open-loop streams (window-gated, infinite bytes) -------
    if tp > 1:
        for p in range(pp):
            for d in range(dp):
                ring = [hh[rank(t, d, p)] for t in range(tp)]
                flows += [Flow(ring[i], ring[(i + 1) % tp],
                               demand=w.demand, group=group,
                               phase=lane(COMPUTE_LANE))
                          for i in range(tp)]
    if pp > 1:
        for d in range(dp):
            for t in range(tp):
                for p in range(pp - 1):
                    a, b = hh[rank(t, d, p)], hh[rank(t, d, p + 1)]
                    flows.append(Flow(a, b, demand=w.demand, group=group,
                                      phase=lane(FWD_LANE)))
                    flows.append(Flow(b, a, demand=w.demand, group=group,
                                      phase=lane(BWD_LANE)))

    # --- per-step closed transfers -------------------------------------
    phases: List[Phase] = []
    step_flows: List[Tuple[int, ...]] = []
    for s in range(ss.steps):
        t0 = plan.step_starts[s]
        t_bwd = t0 + plan.w_fwd
        t_sync = t_bwd + plan.w_bwd
        t_end = t_sync + plan.w_sync
        idx: List[int] = []

        # MoE all2all dispatch/combine: launched with the forward pass,
        # ordered pairs within each EP (= DP) group.
        n0 = len(flows)
        if plan.a2a_pair > 0 and dp > 1:
            for p in range(pp):
                for t in range(tp):
                    for d1 in range(dp):
                        for d2 in range(dp):
                            if d1 == d2:
                                continue
                            flows.append(Flow(
                                hh[rank(t, d1, p)], hh[rank(t, d2, p)],
                                demand=w.demand / (dp - 1),
                                bytes_total=plan.a2a_pair,
                                start_slot=t0, group=group))
            idx += range(n0, len(flows))
        phases.append(Phase("fwd", s, t0, t_bwd,
                            sim_bytes=plan.a2a_pair * (len(flows) - n0),
                            n_flows=len(flows) - n0))
        phases.append(Phase("bwd", s, t_bwd, t_sync, 0.0, 0))

        # DP gradient sync: one ring stream per rank, launched when the
        # backward pass drains.
        n0 = len(flows)
        for p in range(pp):
            for t in range(tp):
                for d in range(dp):
                    flows.append(Flow(
                        hh[rank(t, d, p)], hh[rank(t, (d + 1) % dp, p)],
                        demand=w.demand, bytes_total=plan.ar_flow,
                        start_slot=t_sync, group=group))
        idx += range(n0, len(flows))
        phases.append(Phase("sync", s, t_sync, t_end,
                            sim_bytes=plan.ar_flow * (len(flows) - n0),
                            n_flows=len(flows) - n0))

        # Background checkpoint write after every k-th step (excluded
        # from the step-completion index — it rides the pad window and
        # beyond).
        if ss.ckpt_every and (s + 1) % ss.ckpt_every == 0:
            n0 = len(flows)
            for r in range(n_ranks):
                flows.append(Flow(
                    hh[r], hh[(r + n_ranks // 2) % n_ranks],
                    demand=w.demand, bytes_total=plan.ckpt_rank,
                    start_slot=t_end, group="ckpt"))
            phases.append(Phase("ckpt", s, t_end, t0 + plan.step_period,
                                sim_bytes=plan.ckpt_rank * n_ranks,
                                n_flows=n_ranks))
        step_flows.append(tuple(idx))

    # --- (T, K) demand-multiplier timeline -----------------------------
    pm = np.zeros((sim.slots, LANES_PER_SCHEDULE))
    pm[:, 0] = 1.0
    for s in range(ss.steps):
        t0 = plan.step_starts[s]
        pm[t0:t0 + plan.w_fwd, FWD_LANE] = 1.0
        pm[t0 + plan.w_fwd:t0 + plan.w_fwd + plan.w_bwd, BWD_LANE] = 1.0
    pm[:, COMPUTE_LANE] = np.maximum(pm[:, FWD_LANE], pm[:, BWD_LANE])

    sched = TrainSchedule(
        model=plan.model, dp=dp, tp=tp, pp=pp, steps=ss.steps,
        n_ranks=n_ranks, w_fwd=plan.w_fwd, w_bwd=plan.w_bwd,
        w_sync=plan.w_sync, pad=plan.pad,
        step_starts=plan.step_starts, phases=tuple(phases),
        step_flows=tuple(step_flows), lane_offset=lane_offset,
        grad_bytes_real=plan.grad_bytes_real,
        a2a_bytes_real=plan.a2a_bytes_real,
        ckpt_bytes_real=plan.ckpt_bytes_real)
    return flows, pm, sched
