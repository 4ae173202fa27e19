"""Named experiment library: the paper-figure parameter studies
(fig8/9/10/11/12/14a/15) as `Experiment` definitions, plus reusable
multi-axis grids — a copy of the reference's `repro.experiments.library`
with the same registrations, derive hooks and testbed factories, so a
study is the same grid in both packages.

Derive hooks read only what a result provides: `mean_goodput`/
`completion_slot` exist on every engine's result; the full `goodput`/
`rtt` timelines exist only on the reference's NumPy results, so the
hooks that need them (`fig8_metrics`' latency, `fig12_metrics`,
`fig15_oscillation`) give on the port what they give on the
reference's JAX backend: without those columns.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Tuple

import numpy as np

from repro_torch.scenarios.registry import fig11_partial_uplink
from repro_torch.scenarios.spec import (FaultSpec, ScenarioSpec, SimSpec,
                                  TenantSpec, TopologySpec, WorkloadSpec)

from .axes import Axis, product, zip_axes
from .experiment import Experiment, register_experiment

# the paper's paired stacks: SPX NIC + adaptive routing vs commodity
# Ethernet (DCQCN + ECMP); fig11 pairs SPX with weighted-AR instead
ETH_SPX = zip_axes(Axis("sim.nic", ("dcqcn", "spx")),
                   Axis("sim.routing", ("ecmp", "ar")))
ETH_SPX_WAR = zip_axes(Axis("sim.nic", ("dcqcn", "spx")),
                       Axis("sim.routing", ("ecmp", "war")))

STACK_NAMES = {"dcqcn": "eth", "spx": "spx", "swlb": "sw_lb",
               "global": "globalcc", "esr": "esr"}


# ---------------------------------------------------------------------------
# derive hooks
# ---------------------------------------------------------------------------

def fig8_metrics(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    gp = res.mean_goodput
    out = {"p01_bw": float(np.quantile(gp, 0.01)),
           "median_bw": float(np.median(gp))}
    rtt = getattr(res, "rtt", None)          # reference NumPy results only
    if rtt is not None:
        lat = rtt[rtt.shape[0] // 2:]
        out["p99_lat_us"] = float(np.quantile(lat, 0.99))
    return out


def fig9_metrics(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    """Collective bw is gated by the slowest flow (stragglers, §2.1)."""
    if "victim" in res.groups:
        vi = res.groups.index("victim")
        vflows = res.mean_goodput[res.group_of == vi]
        v = vflows.reshape(16, 15).sum(1)
        return {"victim_bw_frac": float(v.mean()),
                "cct_gated_bw": float(vflows.min() * 15)}
    per_rank = res.mean_goodput.reshape(32, 31).sum(1)
    return {"rank_bw_frac": float(per_rank.mean()),
            "cct_gated_bw": float(res.mean_goodput.min() * 31)}


def fig10_metrics(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    vi = res.groups.index("victim")
    vflows = res.mean_goodput[res.group_of == vi]
    return {"victim_gated_bw": max(float(vflows.min() * 15), 1e-3)}


def fig11_metrics(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    n_ranks = len(c.tenants["main"])
    per_rank = res.mean_goodput.reshape(n_ranks, -1).sum(1)
    # the degraded leaf's ranks gate the collective (§2.1)
    return {"bw_frac": float(per_rank.mean()),
            "cct_gated_bw": float(res.mean_goodput.min() * (n_ranks - 1))}


def fig12_metrics(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    goodput = getattr(res, "goodput", None)  # reference NumPy results only
    if goodput is None:
        return {}
    g = goodput[:, 0]
    fail_slot = spec.faults[0].start_slot
    # recovery = first slot after failure with goodput >= 0.9 x the
    # 3-plane steady state (0.75 of original line rate)
    post = np.flatnonzero((np.arange(len(g)) > fail_slot)
                          & (g >= 0.9 * 0.75))
    rec_ms = ((post[0] - fail_slot) * spec.sim.slot_us / 1000.0
              if len(post) else float("inf"))
    return {"recovery_ms": float(rec_ms),
            "steady": float(g[-10:].mean()),
            "pre_fail": float(g[fail_slot - 5])}


def train_comms_metrics(spec: ScenarioSpec, c, res) -> Dict:
    """Per-step completion times from the compiled training schedule:
    each step's time is its last closed collective (DP sync / EP a2a)
    completion minus the scheduled step start (`comms.TrainSchedule`).
    Works on every engine — only `completion_slot` is read.  The
    in-run baseline is the fastest step, so a single faulted run yields
    its own inflation and recovery ratios."""
    scheds = getattr(c, "schedules", ())
    comp = getattr(res, "completion_slot", None)
    if not scheds or comp is None:
        return {}
    sched = scheds[0]
    st = sched.step_times(np.asarray(comp), spec.sim.slots)
    ref = max(float(np.nanmin(st)), 1e-9)
    return {"step_time_slots": [float(x) for x in st],
            "step_period": int(sched.step_period),
            "step_inflation": float(np.nanmax(st) / ref),
            "last_step_ratio": float(st[-1] / ref)}


def fig14a_metrics(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    gp = np.maximum(res.mean_goodput, 1e-3)
    return {"p99_cct": float(1.0 / np.quantile(gp, 0.01))}


def fig15_per_nic(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    mi = res.groups.index("main")
    gp = res.mean_goodput[res.group_of == mi]
    n_nics = 8 if spec.workloads[0].kind == "one2many" else 24
    per_nic = gp.reshape(n_nics, -1).sum(1)
    return {"per_nic_bw": float(per_nic.mean())}


def fig15_convergence(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    mi = res.groups.index("main")
    sel = res.group_of == mi
    comp = res.completion_slot[sel].astype(float)
    comp[comp < 0] = spec.sim.slots // spec.sim.record_every
    warm = spec.workloads[0].start_slot
    comp -= warm
    # per-flow rate 1/16 -> msg duration in slots = 16 x bytes_total
    msg_slots = spec.workloads[0].bytes_total * 16
    ratio = msg_slots / max(float(np.mean(comp)), 1e-9)
    return {"normalized_bw": float(min(ratio, 1.0))}


def fig15_oscillation(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    goodput = getattr(res, "goodput", None)  # reference NumPy results only
    if goodput is None:
        return {}
    mi = res.groups.index("main")
    series = goodput[:, res.group_of == mi].sum(1)
    tail = series[len(series) // 2:]
    return {"bw_cv": float(tail.std() / max(tail.mean(), 1e-9)),
            "mean_bw": float(tail.mean())}


# ---------------------------------------------------------------------------
# spec factories for the non-registry testbeds
# ---------------------------------------------------------------------------

def fig14a_spec() -> ScenarioSpec:
    """Fig 14a proxy fabric: 64-rank random ring on a 128-host
    single-plane 16x16 fabric (SPX/WAR stack).  The k concurrent failed
    links arrive as a `faults` axis."""
    return ScenarioSpec(
        name="fig14a_fabric_flaps",
        description="Fig 14a: P99 CCT of a random 64-rank ring vs k "
                    "concurrent fabric link failures.",
        topo=TopologySpec(n_leaves=16, n_spines=16, hosts_per_leaf=8,
                          n_planes=1),
        tenants=(TenantSpec("main", placement="random", n_hosts=64),
                 TenantSpec("rest", placement="remainder")),
        workloads=(WorkloadSpec("permutation", tenant="main"),),
        sim=SimSpec(slots=300, nic="spx", routing="war", seed=11),
        workload_seed=11)


def fig14a_faults(k: int) -> Tuple[FaultSpec, ...]:
    """Exactly k uniformly-drawn uplink kills at slot 0."""
    if k == 0:
        return ()
    return (FaultSpec("random_fail", start_slot=0, count=k, frac=1.0),)


def fig15_testbed(kind: str, asym: bool, seed: int,
                  slots: int = 500) -> ScenarioSpec:
    """The Fig 15/16 testbed: 3 leaves x 16 NICs, 4 planes of 200G ports
    (access 0.25 x line), leaf uplinks 2 spines x 8 parallel x 0.25;
    planes 2/3 trimmed to 25% uplinks when `asym`.  'main' is the first
    8 NICs of every leaf, 'noise' the second 8."""
    mains = tuple(h for leaf in range(3)
                  for h in range(leaf * 16, leaf * 16 + 8))
    noises = tuple(h for leaf in range(3)
                   for h in range(leaf * 16 + 8, leaf * 16 + 16))
    faults = ((FaultSpec("leaf_trim", start_slot=0, plane=2, leaf=1,
                         frac=0.25),
               FaultSpec("leaf_trim", start_slot=0, plane=3, leaf=2,
                         frac=0.25)) if asym else ())
    main_wl = (WorkloadSpec("one2many", tenant="main", srcs=8)
               if kind == "one2many"
               else WorkloadSpec("all2all", tenant="main"))
    return ScenarioSpec(
        name=f"fig15_{kind}_{'asym' if asym else 'base'}",
        description="Fig 15 testbed: main+noise bursts under "
                    "noise-induced plane asymmetry.",
        topo=TopologySpec(n_leaves=3, n_spines=2, hosts_per_leaf=16,
                          n_planes=4, parallel_links=8, link_cap=0.25,
                          access_cap=0.25),
        tenants=(TenantSpec("main", placement="explicit", hosts=mains),
                 TenantSpec("noise", placement="explicit", hosts=noises)),
        workloads=(main_wl, WorkloadSpec("all2all", tenant="noise")),
        faults=faults,
        sim=SimSpec(slots=slots, seed=seed))


# ---------------------------------------------------------------------------
# registered experiments
# ---------------------------------------------------------------------------

@register_experiment
def fig8_bisection_stacks() -> Experiment:
    return Experiment(
        name="fig8_bisection_stacks",
        base="fig8_bisection", axes=ETH_SPX, derive=fig8_metrics,
        description="Fig 8: RDMA bisection per stack — p01/median bw "
                    "and p99 latency.")


@register_experiment
def fig9_isolation() -> Experiment:
    return Experiment(
        name="fig9_isolation",
        axes=product(Axis("scenario", ("fig9_single_all2all",
                                       "fig9_victim_noise")),
                     ETH_SPX),
        derive=fig9_metrics,
        description="Fig 9: single All2All capacity ceiling + "
                    "victim/noise isolation per stack.")


@register_experiment
def fig10_step_time() -> Experiment:
    return Experiment(
        name="fig10_step_time",
        axes=product(Axis("scenario", ("fig10_victim_alone",
                                       "fig10_victim_noise")),
                     ETH_SPX),
        derive=fig10_metrics,
        description="Fig 10: victim training-collective bandwidth with "
                    "and without bisection noise (step-time input).")


@register_experiment
def fig11_static_resiliency() -> Experiment:
    keeps = (1.0, 0.75, 0.5, 0.25)
    base = replace(fig11_partial_uplink(1.0), name="fig11_partial_uplink")
    return Experiment(
        name="fig11_static_resiliency",
        base=base,
        axes=product(
            Axis("faults",
                 tuple(fig11_partial_uplink(k).faults for k in keeps),
                 labels=tuple(int(k * 100) for k in keeps)),
            ETH_SPX_WAR),
        derive=fig11_metrics,
        description="Fig 11 / §6.4: All2All bw vs surviving leaf-uplink "
                    "fraction, SPX (weighted-AR) vs ETH.")


@register_experiment
def fig12_flap_recovery() -> Experiment:
    return Experiment(
        name="fig12_flap_recovery",
        base="fig12_plane_flap",
        axes=zip_axes(Axis("sim.nic", ("spx", "swlb")),
                      Axis("sim.slots", (600, 12000)),
                      Axis("sim.sw_lb_delay_ms", (0.0, 1000.0))),
        derive=fig12_metrics,
        description="Fig 12: hardware PLB vs software LB plane-flap "
                    "recovery time.")


@register_experiment
def fig14a_fabric_flaps() -> Experiment:
    ks = tuple(range(11))
    return Experiment(
        name="fig14a_fabric_flaps",
        base=fig14a_spec(),
        axes=product(Axis("faults", tuple(fig14a_faults(k) for k in ks),
                          labels=ks),
                     Axis("seed", (0, 1))),
        derive=fig14a_metrics,
        description="Fig 14a: P99 ring CCT vs k concurrent fabric link "
                    "failures (expectation-weighted by the caller).")


@register_experiment
def fig15_lb_asymmetry() -> Experiment:
    specs = tuple(fig15_testbed(kind, asym, seed=8)
                  for kind in ("one2many", "all2all")
                  for asym in (False, True))
    return Experiment(
        name="fig15_lb_asymmetry",
        axes=product(Axis("scenario", specs),
                     Axis("sim.nic", ("spx", "global"))),
        derive=fig15_per_nic,
        description="Fig 15: per-plane CC (SPX PLB) vs a single global "
                    "CC context under plane asymmetry.")


@register_experiment
def fig15_msg_convergence() -> Experiment:
    sizes = (5, 20, 80, 320)
    warm = 150          # noise saturates the degraded planes first
    base = fig15_testbed("one2many", True, seed=9)
    base = replace(
        base,
        workloads=(replace(base.workloads[0], start_slot=warm),
                   base.workloads[1]),
        sim=replace(base.sim, warmup_frac=0.0))
    return Experiment(
        name="fig15_msg_convergence",
        base=base,
        axes=zip_axes(
            # ideal per-flow rate = NIC line / 16 destinations
            Axis("workloads[0].bytes_total",
                 tuple(ms / 16 for ms in sizes), labels=sizes),
            Axis("sim.slots", tuple(8 * ms + 2 * warm for ms in sizes))),
        derive=fig15_convergence,
        description="Fig 15c: message-size convergence — short bursts "
                    "end before the PLB accumulates per-plane state.")


@register_experiment
def fig15_esr_oscillation() -> Experiment:
    return Experiment(
        name="fig15_esr_oscillation",
        base=fig15_testbed("all2all", True, seed=10, slots=600),
        axes=Axis("sim.nic", ("spx", "esr")),
        derive=fig15_oscillation,
        description="Fig 15d: entangled CC+LB loops (ESR) oscillate; "
                    "SPX stays stable.")


def topo_kind_metrics(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    """Post-failure bisection throughput per endpoint (the §3.1
    multiplane-vs-hierarchy comparison metric: the scenario's warmup
    window ends after the fault, so `mean_goodput` is already the
    post-failure steady state) plus the straggler tail that gates
    collectives."""
    gp = res.mean_goodput
    return {"post_failure_bw": float(gp.mean()),
            "post_failure_p01": float(np.quantile(gp, 0.01))}


@register_experiment
def topo_kind_resiliency() -> Experiment:
    """The paper's headline architecture argument as ONE sweep: topology
    kind x routing x failure fraction on the equal-bisection pair.  The
    whole grid rides the megabatch path (one captured slot loop per
    (topology-kind shape bucket, routing, NIC))."""
    return Experiment(
        name="topo_kind_resiliency",
        axes=(Axis("scenario", ("bisection_multiplane",
                                "bisection_fat_tree")),
              Axis("sim.routing", ("war", "ecmp")),
              Axis("faults[0].frac", (0.05, 0.15, 0.25))),
        derive=topo_kind_metrics,
        description="§3.1/§6.4: flat multiplane vs 3-tier fat-tree "
                    "post-failure bisection throughput, kind x routing "
                    "x fault-frac.")


@register_experiment
def train_comms_resiliency() -> Experiment:
    """Training co-simulation: collective schedules compiled from real
    `ModelConfig`s (dense llama3-8b and MoE phi3.5, reduced) run through
    the fabric, with a plane flap pinned to step 1's gradient-sync
    window.  Expected signature (both backends, exact): the flapped
    step's time inflates >= 1.2x the in-run baseline step and the final
    step recovers to <= 1.1x after the heal."""
    return Experiment(
        name="train_comms_resiliency",
        axes=Axis("scenario", ("train_step_baseline", "train_step_flap",
                               "train_step_flap_moe")),
        derive=train_comms_metrics,
        description="Collective-schedule co-simulation: plane flap "
                    "during DP sync -> step-time inflation -> recovery "
                    "(dense + MoE schedules, both backends).")


def reroute_metrics(spec: ScenarioSpec, c, res) -> Dict[str, float]:
    """Reaction-policy comparison columns: the p50 completion slot (for
    the §6.4 '7% at 10% failures' inflation check against the frac=0.0
    rows) — blackholed bytes and worst reaction window are standard
    `ScenarioMetrics` columns already."""
    comp = res.completion_slot[res.completion_slot >= 0]
    return {"p50_completion": (float(np.median(comp)) if comp.size
                               else float("nan"))}


@register_experiment
def reroute_reaction() -> Experiment:
    """The failure-reaction policy sweep: precomputed backup failover
    (hardware PLB-style) vs post-detection ECMP re-randomization
    (software LB-style) across topology kind, failure fraction, and
    detection latency.  Expected signatures: backup's blackhole window
    closes within detect_slots of the fault while rehash stays dark for
    detect+converge (>= 10x longer at the registry defaults), and
    backup's p50 completion at 10% failures inflates <= 1.10x over the
    frac=0 rows."""
    return Experiment(
        name="reroute_reaction",
        axes=(Axis("scenario", ("reroute_random_failures",
                                "reroute_random_failures_ft")),
              Axis("reaction.mode", ("backup", "rehash")),
              Axis("faults[0].frac", (0.0, 0.10)),
              Axis("reaction.detect_slots", (1, 4))),
        derive=reroute_metrics,
        description="§6.4: reroute-policy grid — mode x topology kind x "
                    "fault-frac x detection latency; blackhole windows "
                    "and completion inflation per policy.")


@register_experiment
def resiliency_fault_planes() -> Experiment:
    return Experiment(
        name="resiliency_fault_planes",
        base="allreduce_under_random_failures",
        axes=product(Axis("faults[0].frac", (0.05, 0.1, 0.2)),
                     Axis("topo.n_planes", (1, 2))),
        description="Showcase multi-axis grid: random-failure fraction "
                    "x plane count on the ring-allreduce scenario "
                    "(README's worked example).")
