"""Lower a `ScenarioSpec` to the topology, flows and fault metadata the
slot engine consumes.

Compilation is deterministic and draw-for-draw the same as the reference
compiler: all randomness flows through one
`np.random.default_rng(workload_seed)` consumed in declaration order
(tenants first, then workloads), so a spec yields the same flow list in
both packages.  Faults reach the engine as a capacity timeline
(`netsim.events`), so no event closures are built here.  Schedule
workloads, `poisson_flap` faults and failure reaction belong to later
slices of the port and raise `NotImplementedError`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.netsim import events
from repro_torch.netsim.fabric import Flow
from repro_torch.netsim.sim import SimConfig
from repro_torch.netsim.topology import Fabric, FatTree, LeafSpine
from repro_torch.netsim.workloads import (all2all, bisection_pairs,
                                          one_to_many, ring_neighbors)

from .spec import ScenarioSpec, WorkloadSpec, fault_transition_slots


@dataclass
class CompiledScenario:
    """One run bundle: the pristine topology, the flow list, the sim
    parameters, the tenant host sets and the fault transition slots the
    runner measures recovery from."""
    spec: ScenarioSpec
    topo: Fabric
    flows: List[Flow]
    cfg: SimConfig
    tenants: Dict[str, List[int]]
    fault_slots: Tuple[Tuple[int, str], ...]   # (slot, label), sorted

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
                rng: np.random.Generator) -> List[Flow]:
    """Lower every workload, consuming `rng` in declaration order."""
    flows: List[Flow] = []
    for w in spec.workloads:
        group = w.group or w.tenant
        if w.kind == "schedule":
            raise NotImplementedError(
                f"{spec.name}: schedule workloads arrive with the "
                "phases slice of the port")
        fl = _build_workload(w, topo, tenants[w.tenant], rng, group)
        if w.start_slot:
            for f in fl:
                f.start_slot = w.start_slot
        flows += fl
    return flows


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


def fault_transitions(spec: ScenarioSpec) -> Tuple[Tuple[int, str], ...]:
    """Sorted (slot, label) degradation instants of every fault."""
    return tuple(sorted(
        {sl for f in spec.faults
         for sl in fault_transition_slots(f, spec.sim.slots)},
        key=lambda x: (x[0], x[1])))


def compile_scenario(spec: ScenarioSpec) -> CompiledScenario:
    spec.validate()
    if spec.reaction is not None:
        raise NotImplementedError(
            f"{spec.name}: failure reaction arrives with the "
            "failure-reaction slice of the port")
    events.check_timeline_faults(spec)
    topo = build_topology(spec.topo)
    rng = np.random.default_rng(spec.workload_seed)
    tenants = resolve_tenants(spec, rng)
    flows = build_flows(spec, topo, tenants, rng)
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
    return CompiledScenario(spec=spec, topo=topo, flows=flows, cfg=cfg,
                            tenants=tenants,
                            fault_slots=fault_transitions(spec))
