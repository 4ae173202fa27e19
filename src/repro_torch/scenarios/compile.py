"""Lower a `ScenarioSpec` to the topology, flows and fault metadata the
slot engine consumes.

Compilation is deterministic and draw-for-draw the same as the reference
compiler: all randomness flows through one
`np.random.default_rng(workload_seed)` consumed in declaration order
(tenants first, then workloads), so a spec yields the same flow list in
both packages.  Faults reach the engine as a capacity timeline
(`netsim.events`), so no event closures are built here; a
`poisson_flap` fault is drawn once into a slot schedule
(`poisson_flap_schedule`), and failure reaction lowers to the reference's
lag (`spec.reaction_lag`, applied to the timeline by the engine) and its
fast-reroute backup table.  A schedule workload lowers through
`repro_torch.comms` to its flows, a (slots, K) demand-multiplier
timeline and its `TrainSchedule` step metadata.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.comms import lower_schedule
from repro_torch.core.fault_tolerance import poisson_flaps
from repro_torch.netsim import events
from repro_torch.netsim.fabric import Flow
from repro_torch.netsim.sim import SimConfig
from repro_torch.netsim.topology import (Fabric, FatTree, LeafSpine,
                                         backup_path_table)
from repro_torch.netsim.workloads import (all2all, bisection_pairs,
                                          one_to_many, ring_neighbors)

from .spec import (ScenarioSpec, WorkloadSpec, fault_planes,
                   fault_transition_slots)


@dataclass
class CompiledScenario:
    """One run bundle: the pristine topology, the flow list, the sim
    parameters, the tenant host sets, the fault transition slots the
    runner measures recovery from, with schedule workloads the demand
    timeline and step metadata and, under a `mode="backup"` failure
    reaction, the fast-reroute successor table."""
    spec: ScenarioSpec
    topo: Fabric
    flows: List[Flow]
    cfg: SimConfig
    tenants: Dict[str, List[int]]
    fault_slots: Tuple[Tuple[int, str], ...]   # (slot, label), sorted
    # schedule workloads only: (slots, K) demand-multiplier timeline
    # (lane 0 always 1.0) + per-schedule `comms.TrainSchedule` metadata
    phase_mult: Optional[np.ndarray] = None
    schedules: Tuple = ()
    backup: Optional[np.ndarray] = None        # (J,) int32

    def run(self, device=None, dtype=None):
        """Simulate on the slot engine (see `netsim.engine.run_compiled`
        for `device` and `dtype`)."""
        from repro_torch.netsim.engine import run_compiled
        return run_compiled(self, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# tenants
# ---------------------------------------------------------------------------

def resolve_tenants(spec: ScenarioSpec, rng: np.random.Generator
                    ) -> Dict[str, List[int]]:
    n = spec.topo.n_hosts
    taken: set = set()
    out: Dict[str, List[int]] = {}
    for t in spec.tenants:
        if t.placement == "explicit":
            hosts = list(t.hosts)
        elif t.placement == "block":
            count = n - t.offset if t.n_hosts is None else t.n_hosts
            hosts = list(range(t.offset, t.offset + count))
        elif t.placement == "interleave":
            hosts = list(range(t.offset, n, t.stride))
            if t.n_hosts is not None:
                hosts = hosts[:t.n_hosts]
        elif t.placement == "random":
            pool = np.array(sorted(set(range(n)) - taken))
            count = len(pool) if t.n_hosts is None else t.n_hosts
            hosts = sorted(int(h) for h in
                           rng.choice(pool, size=count, replace=False))
        elif t.placement == "remainder":
            hosts = sorted(set(range(n)) - taken)
            if t.n_hosts is not None:
                hosts = hosts[:t.n_hosts]
        else:                                          # pragma: no cover
            raise ValueError(t.placement)
        if len(set(hosts)) != len(hosts):
            dupes = sorted({h for h in hosts if hosts.count(h) > 1})
            raise ValueError(
                f"{spec.name}: tenant {t.name} lists hosts {dupes} "
                "more than once")
        clash = taken & set(hosts)
        if clash:
            raise ValueError(
                f"{spec.name}: tenant {t.name} overlaps hosts {clash}")
        bad = [h for h in hosts if not 0 <= h < n]
        if bad:
            raise ValueError(
                f"{spec.name}: tenant {t.name} hosts {bad} outside "
                f"[0, {n})")
        taken |= set(hosts)
        out[t.name] = hosts
    return out


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

def _build_workload(w: WorkloadSpec, topo: LeafSpine, hosts: List[int],
                    rng: np.random.Generator, group: str) -> List[Flow]:
    if w.kind == "bisection":
        flows = bisection_pairs(topo, hosts, rng, group=group)
        for f in flows:
            f.demand *= w.demand
            f.bytes_total = w.bytes_total
        return flows
    if w.kind == "all2all":
        flows = all2all(topo, hosts, group=group,
                        bytes_per_pair=w.bytes_total)
        for f in flows:
            f.demand *= w.demand
        return flows
    if w.kind == "allreduce":
        flows = ring_neighbors(hosts, group=group,
                               bytes_per_hop=w.bytes_total)
        for f in flows:
            f.demand *= w.demand
        return flows
    if w.kind == "incast":
        sinks, srcs = hosts[:w.sinks], hosts[w.sinks:]
        return [Flow(int(a), int(b), w.demand, w.bytes_total, group=group)
                for a in srcs for b in sinks]
    if w.kind == "permutation":
        order = rng.permutation(hosts)
        return [Flow(int(order[i]), int(order[(i + 1) % len(order)]),
                     w.demand, w.bytes_total, group=group)
                for i in range(len(order))]
    if w.kind == "storage":
        flows = []
        arr = np.asarray(hosts)
        for h in hosts:
            peers = arr[arr != h]
            dsts = rng.choice(peers, size=min(w.fanout, len(peers)),
                              replace=False)
            flows += [Flow(int(h), int(d), w.demand, w.bytes_total,
                           group=group) for d in dsts]
        return flows
    if w.kind == "one2many":
        srcs, dsts = hosts[:w.srcs], hosts[w.srcs:]
        if not dsts:
            raise ValueError(
                f"one2many workload for tenant {w.tenant!r}: srcs="
                f"{w.srcs} leaves no destination hosts")
        flows = one_to_many(topo, srcs, dsts, group=group,
                            bytes_per_flow=w.bytes_total)
        for f in flows:
            f.demand *= w.demand
        return flows
    if w.kind == "pairs":
        foreign = sorted({h for p in w.pairs for h in p} - set(hosts))
        if foreign:
            raise ValueError(
                f"pairs workload for tenant {w.tenant!r} references "
                f"hosts {foreign} outside the tenant")
        return [Flow(int(a), int(b), w.demand, w.bytes_total, group=group)
                for a, b in w.pairs]
    raise ValueError(f"unknown workload kind {w.kind!r}")


def build_flows(spec: ScenarioSpec, topo: LeafSpine,
                tenants: Dict[str, List[int]],
                rng: np.random.Generator
                ) -> Tuple[List[Flow], Optional[np.ndarray], Tuple]:
    """Lower every workload, consuming `rng` in declaration order.
    Returns `(flows, phase_mult, schedules)`: `phase_mult` is the
    (slots, K) demand-multiplier timeline (None when no schedule
    workload is present) and `schedules` the matching
    `comms.TrainSchedule` metadata, flow indices already rebased onto
    the global flow list.  Multiple schedule workloads stack their lanes
    column-wise; lane 0 stays the shared always-1.0 lane."""
    flows: List[Flow] = []
    pm: Optional[np.ndarray] = None
    schedules: List = []
    for w in spec.workloads:
        group = w.group or w.tenant
        if w.kind == "schedule":
            lane_off = 0 if pm is None else pm.shape[1] - 1
            fl, wpm, sched = lower_schedule(
                w, tenants[w.tenant], spec.topo, spec.sim, group,
                lane_offset=lane_off)
            schedules.append(sched.shifted(len(flows)))
            pm = wpm if pm is None else np.concatenate(
                [pm, wpm[:, 1:]], axis=1)
            flows += fl          # start slots are schedule-internal
            continue
        fl = _build_workload(w, topo, tenants[w.tenant], rng, group)
        if w.start_slot:
            for f in fl:
                f.start_slot = w.start_slot
        flows += fl
    return flows, pm, tuple(schedules)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def build_topology(ts) -> Fabric:
    """Instantiate the runtime fabric a `TopologySpec` describes."""
    if ts.kind == "fat_tree":
        return FatTree(
            n_pods=ts.n_pods, leaves_per_pod=ts.leaves_per_pod,
            n_aggs=ts.n_aggs, n_cores=ts.n_cores,
            hosts_per_leaf=ts.hosts_per_leaf, n_planes=ts.n_planes,
            parallel_links=ts.parallel_links, link_cap=ts.link_cap,
            core_link_cap=ts.core_link_cap, access_cap=ts.access_cap)
    return LeafSpine(
        n_leaves=ts.n_leaves, n_spines=ts.n_spines,
        hosts_per_leaf=ts.hosts_per_leaf, n_planes=ts.n_planes,
        parallel_links=ts.parallel_links, link_cap=ts.link_cap,
        access_cap=ts.access_cap)


def poisson_flap_schedule(spec: ScenarioSpec, index: int
                          ) -> Tuple[Tuple[int, int, int, int], ...]:
    """Slot schedule of the `kind="poisson_flap"` fault `spec.faults[
    index]`: sorted `(down_slot, up_slot, plane, link)` rows.  Per-link
    exponential inter-arrivals (`core.fault_tolerance.poisson_flaps`)
    make the fleet (every fabric link on every selected plane) flap
    `flaps_per_min` times a minute, drawn from
    `default_rng((workload_seed, 6007, index))` as the reference draws
    them.  `link` indexes leaf-spine uplinks row-major and, on a fat
    tree, leaf-agg links followed by pod-core links; `up_slot =
    down_slot + down_slots` exactly."""
    f = spec.faults[index]
    topo = spec.topo
    planes = list(fault_planes(f, topo.n_planes))
    if topo.kind == "fat_tree":
        n_links = (topo.n_leaves * topo.n_aggs
                   + topo.n_pods * topo.n_cores)
    else:
        n_links = topo.n_leaves * topo.n_spines
    slot_s = spec.sim.slot_us * 1e-6
    stop = spec.sim.slots if f.stop_slot is None \
        else min(f.stop_slot, spec.sim.slots)
    window = stop - f.start_slot
    if window <= 0:
        return ()
    rng = np.random.default_rng((spec.workload_seed, 6007, index))
    evs = poisson_flaps(rng, len(planes) * n_links, f.flaps_per_min,
                        duration_s=f.down_slots * slot_s,
                        horizon_s=window * slot_s)
    out = []
    for ev in evs:
        dn = f.start_slot + int(ev.t_down // slot_s)
        out.append((dn, dn + f.down_slots,
                    planes[ev.link // n_links], ev.link % n_links))
    return tuple(sorted(out))


def fault_transitions(spec: ScenarioSpec) -> Tuple[Tuple[int, str], ...]:
    """Sorted (slot, label) degradation instants of every fault."""
    scheds = {i: poisson_flap_schedule(spec, i)
              for i, f in enumerate(spec.faults) if f.kind == "poisson_flap"}
    return tuple(sorted(
        {sl for i, f in enumerate(spec.faults)
         for sl in fault_transition_slots(f, spec.sim.slots,
                                          sched=scheds.get(i))},
        key=lambda x: (x[0], x[1])))


def compile_scenario(spec: ScenarioSpec) -> CompiledScenario:
    spec.validate()
    events.check_timeline_faults(spec)
    topo = build_topology(spec.topo)
    rng = np.random.default_rng(spec.workload_seed)
    tenants = resolve_tenants(spec, rng)
    flows, phase_mult, schedules = build_flows(spec, topo, tenants, rng)
    if not flows:
        raise ValueError(f"{spec.name}: scenario compiled to zero flows")
    cfg = SimConfig(
        slots=spec.sim.slots, slot_us=spec.sim.slot_us,
        routing=spec.sim.routing, nic=spec.sim.nic,
        base_rtt_us=spec.sim.base_rtt_us,
        warmup_frac=spec.sim.warmup_frac,
        sw_lb_delay_ms=spec.sim.sw_lb_delay_ms,
        seed=spec.sim.seed, record_every=spec.sim.record_every,
        trace=spec.sim.trace)
    backup = None
    r = spec.reaction
    if r is not None and r.enabled and r.mode == "backup":
        cpa = (spec.topo.n_cores // spec.topo.n_aggs
               if spec.topo.kind == "fat_tree" else 1)
        backup = backup_path_table(spec.topo.kind, spec.topo.n_paths,
                                   cores_per_agg=cpa)
    return CompiledScenario(spec=spec, topo=topo, flows=flows, cfg=cfg,
                            tenants=tenants,
                            fault_slots=fault_transitions(spec),
                            phase_mult=phase_mult, schedules=schedules,
                            backup=backup)
