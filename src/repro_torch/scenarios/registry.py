"""Named scenario library: the paper-figure experiments (fig8-fig12)
and the multi-tenant / failure-compound / giga-scale scenarios as
declarative specs.  Every entry is a zero-argument factory so specs stay
immutable and cheap to parameterize via `.with_sim(...)`.

A copy of the reference registry, entry for entry, so a name resolves to
the same spec in both packages (`tests/test_torch_prep.py` checks it).
Scenarios outside this package's slice still resolve; compiling or
running them raises `NotImplementedError`.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from .spec import (FaultSpec, ReactionSpec, ScenarioSpec, ScheduleSpec,
                   SimSpec, TenantSpec, TopologySpec, WorkloadSpec)

SCENARIOS: Dict[str, Callable[[], ScenarioSpec]] = {}

_TESTBED = TopologySpec(n_leaves=8, n_spines=8, hosts_per_leaf=8,
                        n_planes=1)


def register(fn: Callable[[], ScenarioSpec]) -> Callable[[], ScenarioSpec]:
    spec = fn()
    spec.validate()
    SCENARIOS[spec.name] = fn
    return fn


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}"
        ) from None


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


# ---------------------------------------------------------------------------
# paper-figure ports
# ---------------------------------------------------------------------------

@register
def fig8_bisection() -> ScenarioSpec:
    return ScenarioSpec(
        name="fig8_bisection",
        description="Fig 8 / §6.2: RDMA bisection at maximum load, "
                    "64 endpoints, worst-case cross-spine pairing.",
        topo=_TESTBED,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("bisection"),),
        sim=SimSpec(slots=600, seed=1),
        workload_seed=0)


@register
def fig9_single_all2all() -> ScenarioSpec:
    return ScenarioSpec(
        name="fig9_single_all2all",
        description="Fig 9 (left) / §6.3: one 32-rank All2All, capacity "
                    "ceiling per stack.",
        topo=_TESTBED,
        tenants=(TenantSpec("main", placement="block", n_hosts=32),),
        workloads=(WorkloadSpec("all2all"),),
        sim=SimSpec(slots=400, seed=2))


@register
def fig9_victim_noise() -> ScenarioSpec:
    return ScenarioSpec(
        name="fig9_victim_noise",
        description="Fig 9 (right) / §6.3: 16-rank victim All2All "
                    "interleaved with a 48-rank noise All2All.",
        topo=_TESTBED,
        tenants=(TenantSpec("victim", placement="interleave", stride=4,
                            n_hosts=16),
                 TenantSpec("noise", placement="remainder")),
        workloads=(WorkloadSpec("all2all", tenant="victim"),
                   WorkloadSpec("all2all", tenant="noise")),
        sim=SimSpec(slots=400, seed=2))


@register
def fig10_victim_alone() -> ScenarioSpec:
    return ScenarioSpec(
        name="fig10_victim_alone",
        description="Fig 10 baseline: 16-rank training All2All with the "
                    "fabric otherwise idle.",
        topo=_TESTBED,
        tenants=(TenantSpec("victim", placement="interleave", stride=4,
                            n_hosts=16),),
        workloads=(WorkloadSpec("all2all", tenant="victim"),),
        sim=SimSpec(slots=400, seed=4),
        workload_seed=3)


@register
def fig10_victim_noise() -> ScenarioSpec:
    return ScenarioSpec(
        name="fig10_victim_noise",
        description="Fig 10: training All2All next to RDMA-bisection "
                    "noise; step-time dilation per stack.",
        topo=_TESTBED,
        tenants=(TenantSpec("victim", placement="interleave", stride=4,
                            n_hosts=16),
                 TenantSpec("noise", placement="remainder")),
        workloads=(WorkloadSpec("all2all", tenant="victim"),
                   WorkloadSpec("bisection", tenant="noise")),
        sim=SimSpec(slots=400, seed=4),
        workload_seed=3)


def fig11_partial_uplink(keep: float) -> ScenarioSpec:
    """Fig 1d / Fig 11 / §6.4 port, parameterized by surviving-uplink
    fraction on leaf 0 (whole discrete links are disabled)."""
    t = _TESTBED
    n_keep = max(1, round(t.n_spines * keep))
    faults = tuple(FaultSpec("link_kill", start_slot=0, plane=0, leaf=0,
                             spine=s)
                   for s in range(n_keep, t.n_spines))
    return ScenarioSpec(
        name=f"fig11_keep{int(keep * 100)}pct",
        description="Fig 11 / §6.4: All2All with leaf-0 uplinks reduced "
                    f"to {int(keep * 100)}% capacity.",
        topo=t,
        tenants=(TenantSpec("main", placement="block", n_hosts=48),),
        workloads=(WorkloadSpec("all2all"),),
        faults=faults,
        sim=SimSpec(slots=400, seed=5, routing="war"))


@register
def fig11_degraded_leaf() -> ScenarioSpec:
    from dataclasses import replace
    return replace(fig11_partial_uplink(0.5), name="fig11_degraded_leaf")


@register
def fig12_plane_flap() -> ScenarioSpec:
    return ScenarioSpec(
        name="fig12_plane_flap",
        description="Fig 12 / §6.4: one host-plane link dies at slot 50; "
                    "hardware PLB vs software LB recovery "
                    "(swlb via .with_sim(nic='swlb', slots=12000)).",
        topo=TopologySpec(n_leaves=2, n_spines=2, hosts_per_leaf=4,
                          n_planes=4, access_cap=0.25),
        tenants=(TenantSpec("main", placement="explicit", hosts=(0, 4)),),
        workloads=(WorkloadSpec("pairs", pairs=((0, 4),)),),
        faults=(FaultSpec("access_kill", start_slot=50, plane=1, host=0),),
        sim=SimSpec(slots=600, slot_us=100.0, seed=6))


# ---------------------------------------------------------------------------
# new scenarios
# ---------------------------------------------------------------------------

@register
def multi_tenant_50_50() -> ScenarioSpec:
    return ScenarioSpec(
        name="multi_tenant_50_50",
        description="Two equal 32-rank All2All tenants interleaved on "
                    "every leaf — symmetric-contention isolation probe.",
        topo=_TESTBED,
        tenants=(TenantSpec("a", placement="interleave", stride=2,
                            n_hosts=32),
                 TenantSpec("b", placement="remainder")),
        workloads=(WorkloadSpec("all2all", tenant="a"),
                   WorkloadSpec("all2all", tenant="b")),
        sim=SimSpec(slots=400, seed=7))


@register
def multi_tenant_75_25() -> ScenarioSpec:
    return ScenarioSpec(
        name="multi_tenant_75_25",
        description="Asymmetric split: a 16-rank tenant shares leaves "
                    "with a 48-rank tenant (small-tenant starvation "
                    "probe).",
        topo=_TESTBED,
        tenants=(TenantSpec("small", placement="interleave", stride=4,
                            n_hosts=16),
                 TenantSpec("large", placement="remainder")),
        workloads=(WorkloadSpec("all2all", tenant="small"),
                   WorkloadSpec("all2all", tenant="large")),
        sim=SimSpec(slots=400, seed=8))


@register
def flap_during_incast() -> ScenarioSpec:
    return ScenarioSpec(
        name="flap_during_incast",
        description="30-source incast onto 2 sinks while a sink-leaf "
                    "uplink flaps every 60 slots — reaction time under "
                    "sustained congestion.",
        topo=_TESTBED,
        tenants=(TenantSpec("main", placement="block", n_hosts=32),),
        workloads=(WorkloadSpec("incast", sinks=2, demand=0.5),),
        faults=(FaultSpec("link_flap", start_slot=100, period=60,
                          duty=0.34, plane=0, leaf=0, spine=0),),
        sim=SimSpec(slots=400, seed=9))


@register
def cascading_spine_loss() -> ScenarioSpec:
    return ScenarioSpec(
        name="cascading_spine_loss",
        description="Rolling cascade: spines 7, 6, 5 die 80 slots apart "
                    "under a 48-rank All2All (weighted-AR re-balance "
                    "after each loss).",
        topo=_TESTBED,
        tenants=(TenantSpec("main", placement="block", n_hosts=48),),
        workloads=(WorkloadSpec("all2all"),),
        faults=(FaultSpec("cascade", start_slot=100, period=80,
                          spines=(7, 6, 5)),),
        sim=SimSpec(slots=400, seed=10, routing="war"))


@register
def straggler_failure_compound() -> ScenarioSpec:
    return ScenarioSpec(
        name="straggler_failure_compound",
        description="Compound fault: host 5 slows to 30% for slots "
                    "80-280 while an unrelated uplink dies at slot 150 "
                    "(§5.2 telemetry signatures under overlap).",
        topo=_TESTBED,
        tenants=(TenantSpec("main", placement="block", n_hosts=32),),
        workloads=(WorkloadSpec("all2all"),),
        faults=(FaultSpec("straggler", start_slot=80, stop_slot=280,
                          host=5, frac=0.3, plane=-1),
                FaultSpec("link_kill", start_slot=150, plane=0, leaf=1,
                          spine=2)),
        sim=SimSpec(slots=400, seed=11))


@register
def storage_background_mix() -> ScenarioSpec:
    return ScenarioSpec(
        name="storage_background_mix",
        description="32-rank training All2All sharing the fabric with "
                    "low-rate storage/checkpoint background traffic from "
                    "the other 32 hosts.",
        topo=_TESTBED,
        tenants=(TenantSpec("train", placement="interleave", stride=2,
                            n_hosts=32),
                 TenantSpec("storage", placement="remainder")),
        workloads=(WorkloadSpec("all2all", tenant="train"),
                   WorkloadSpec("storage", tenant="storage", demand=0.25,
                                fanout=3)),
        sim=SimSpec(slots=400, seed=12))


@register
def permutation_stress() -> ScenarioSpec:
    return ScenarioSpec(
        name="permutation_stress",
        description="Random permutation at line rate over all 64 hosts — "
                    "ECMP's classic collision workload "
                    "(.with_sim(routing='ecmp', nic='dcqcn') for the ETH "
                    "baseline).",
        topo=_TESTBED,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("permutation"),),
        sim=SimSpec(slots=400, seed=13))


@register
def staggered_incast_bursts() -> ScenarioSpec:
    return ScenarioSpec(
        name="staggered_incast_bursts",
        description="Two 15-source incasts on disjoint tenants, the "
                    "second admitted 150 slots late — burst-on-busy "
                    "admission dynamics.",
        topo=_TESTBED,
        tenants=(TenantSpec("early", placement="block", n_hosts=16),
                 TenantSpec("late", placement="block", offset=16,
                            n_hosts=16)),
        workloads=(WorkloadSpec("incast", tenant="early", demand=0.8),
                   WorkloadSpec("incast", tenant="late", demand=0.8,
                                start_slot=150)),
        sim=SimSpec(slots=400, seed=14))


# ---------------------------------------------------------------------------
# topology-kind scenarios: flat multiplane vs 3-tier fat-tree (§3.1)
# ---------------------------------------------------------------------------
#
# The comparison pair is equal-*bisection*: both fabrics deliver 1:1
# host bandwidth pre-failure, with the same per-leaf fabric-link count
# granularity — which already costs the fat-tree ~2x the link budget
# (two stages instead of one), the paper's first argument for replacing
# hierarchical depth with topological parallelism.  The resiliency
# scenario then shows the second: under the same uniform link-failure
# fraction the multiplane degrades capacity-proportionally while the
# fat-tree's four-hop cross-pod paths (min-cut across stages) strand
# surviving capacity — see `topo_kind_resiliency` in
# `repro.experiments.library`.

# multiplane: 2 planes x 8 spines -> per-leaf fabric capacity 4.32 for
# 4 hosts at line rate.  The slightly over-provisioned non-dyadic cap
# (0.27, not 0.25) keeps queue integrators off exact quantization-bin
# edges, where the two backends' different (mathematically equal)
# summation orders would fork the trajectory.
_BISECT_LS = TopologySpec(n_leaves=4, n_spines=8, hosts_per_leaf=4,
                          n_planes=2, link_cap=0.27)
# fat-tree: 2 pods x 2 leaves, 8 aggs/pod (0.54-cap leaf links), 8
# cores on 1.08-cap pod links -> same per-leaf fabric capacity 4.32
_BISECT_FT = TopologySpec(kind="fat_tree", n_leaves=4, hosts_per_leaf=4,
                          n_pods=2, n_aggs=8, n_cores=8, link_cap=0.54,
                          core_link_cap=1.08)


def _bisection_resiliency(name: str, topo: TopologySpec,
                          which: str) -> ScenarioSpec:
    return ScenarioSpec(
        name=name,
        description=f"Equal-bisection {which} under 25% uniform random "
                    "fabric link failures at slot 150 — the §3.1/§6.4 "
                    "multiplane-vs-hierarchy resiliency probe "
                    "(post-warmup mean goodput = post-failure bisection "
                    "throughput; at this failure rate the fat-tree's "
                    "4-hop cross-pod min-cuts strand surviving capacity "
                    "and the multiplane wins by ~30%+ on any seed).",
        topo=topo,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("bisection"),),
        faults=(FaultSpec("random_fail", start_slot=150, frac=0.25,
                          plane=-1),),
        sim=SimSpec(slots=400, seed=16, routing="war",
                    warmup_frac=0.45),
        workload_seed=4)


@register
def bisection_multiplane() -> ScenarioSpec:
    return _bisection_resiliency("bisection_multiplane", _BISECT_LS,
                                 "2-plane leaf-spine")


@register
def bisection_fat_tree() -> ScenarioSpec:
    return _bisection_resiliency("bisection_fat_tree", _BISECT_FT,
                                 "3-tier fat-tree")


# the 64-host fat-tree testbed: 2 pods x 4 leaves x 8 hosts, 4 aggs/pod
# (2.0-cap leaf links), 8 cores on 4.0-cap pod links — non-blocking at
# both stages, mirroring _TESTBED's scale
_FT_TESTBED = TopologySpec(kind="fat_tree", n_leaves=8, hosts_per_leaf=8,
                           n_pods=2, n_aggs=4, n_cores=8, link_cap=2.0,
                           core_link_cap=4.0)


@register
def ft_cross_pod_all2all() -> ScenarioSpec:
    return ScenarioSpec(
        name="ft_cross_pod_all2all",
        description="64-rank All2All on the fat-tree testbed — half the "
                    "pairs cross pods and ride leaf-agg-core-agg-leaf "
                    "paths (4 bottleneck stages vs the multiplane's 2).",
        topo=_FT_TESTBED,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("all2all"),),
        sim=SimSpec(slots=400, seed=17))


@register
def ft_core_failure_resiliency() -> ScenarioSpec:
    return ScenarioSpec(
        name="ft_core_failure_resiliency",
        description="Fat-tree core-tier faults under a cross-pod "
                    "bisection load: two of pod 0's core links die at "
                    "slot 100 (one heals at slot 260) — the tier the "
                    "multiplane design deletes, weighted-AR steering "
                    "around the stranded agg paths (Fig 1c / §6.4).",
        topo=_FT_TESTBED,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("bisection"),),
        faults=(FaultSpec("core_kill", start_slot=100, pod=0, core=0),
                FaultSpec("core_kill", start_slot=100, stop_slot=260,
                          pod=0, core=2),),
        sim=SimSpec(slots=400, seed=18, routing="war"))


@register
def allreduce_under_random_failures() -> ScenarioSpec:
    return ScenarioSpec(
        name="allreduce_under_random_failures",
        description="Ring allreduce over 64 hosts with 10% uniform "
                    "random fabric link failures at slot 100 "
                    "(Fig 1c / §6.4 operating point).",
        topo=_TESTBED,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("allreduce", bytes_total=220.0),),
        faults=(FaultSpec("random_fail", start_slot=100, frac=0.10),),
        sim=SimSpec(slots=400, seed=15, routing="war"))


# ---------------------------------------------------------------------------
# failure-reaction scenarios: detection latency + reroute policy (§6.4/§6.6)
# ---------------------------------------------------------------------------
#
# Same 10%-failure operating point as `allreduce_under_random_failures`,
# but routing no longer reacts instantly: for `detect_slots` after a
# fault the dead paths keep attracting traffic (blackholed bytes), then
# either the precomputed backup table kicks in (hardware PLB-style, §6.4
# "<3 ms failover") or ECMP re-randomizes after a further
# `converge_slots` (software LB-style, ~1 s).  ECMP routing so the
# policies differ maximally — adaptive modes steer around residual
# capacity and mask the contrast.

_REROUTE_REACTION = ReactionSpec(detect_slots=2, mode="backup",
                                 converge_slots=60)


@register
def reroute_random_failures() -> ScenarioSpec:
    return ScenarioSpec(
        name="reroute_random_failures",
        description="Ring allreduce over 64 hosts, 10% random fabric "
                    "link failures at slot 100 under delayed detection "
                    "(2 slots) with precomputed backup-path failover; "
                    "sweep reaction.mode='rehash' for the software-LB "
                    "contrast (§6.4).",
        topo=_TESTBED,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("allreduce", bytes_total=220.0),),
        faults=(FaultSpec("random_fail", start_slot=100, frac=0.10),),
        reaction=_REROUTE_REACTION,
        sim=SimSpec(slots=400, seed=15, routing="ecmp"))


@register
def reroute_random_failures_ft() -> ScenarioSpec:
    return ScenarioSpec(
        name="reroute_random_failures_ft",
        description="Fat-tree variant of reroute_random_failures: the "
                    "backup table chains agg-then-core alternates, so "
                    "failover shifts traffic across both stages.",
        topo=_FT_TESTBED,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("allreduce", bytes_total=220.0),),
        faults=(FaultSpec("random_fail", start_slot=100, frac=0.10),),
        reaction=_REROUTE_REACTION,
        sim=SimSpec(slots=400, seed=15, routing="ecmp"))


@register
def poisson_flap_storm() -> ScenarioSpec:
    return ScenarioSpec(
        name="poisson_flap_storm",
        description="Fleet-MTBF flap storm (§6.6): every fabric link "
                    "flaps by Poisson arrival (the giga-fleet rate "
                    "time-compressed into the 35 ms window — ~15 flaps, "
                    "12-slot outages) under a 48-rank All2All with "
                    "delayed detection and backup failover — survival "
                    "means blackhole windows stay bounded by "
                    "detect_slots per flap.",
        topo=_TESTBED,
        tenants=(TenantSpec("main", placement="block", n_hosts=48),),
        workloads=(WorkloadSpec("all2all"),),
        faults=(FaultSpec("poisson_flap", start_slot=50,
                          flaps_per_min=24000.0, down_slots=12,
                          frac=1.0),),
        reaction=_REROUTE_REACTION,
        sim=SimSpec(slots=400, slot_us=100.0, seed=19, routing="ecmp"))


# ---------------------------------------------------------------------------
# training-step co-simulation (repro.comms): real collective schedules
# compiled into the fabric
# ---------------------------------------------------------------------------
#
# 8 ranks on a fig12-style 4-plane fabric (access 0.25 x line per
# plane).  Two hosts per leaf puts every other DP ring hop and every PP
# edge on the fabric, so both access-plane and fabric events shape the
# schedule.  line_rate_gbps calibrates the reduced() model's byte
# volumes so one DP sync stream spans tens of slots — wide enough that
# a mid-sync plane flap visibly inflates derived step time.
_TRAIN_TOPO = TopologySpec(n_leaves=4, n_spines=2, hosts_per_leaf=2,
                           n_planes=4, access_cap=0.25)

# dense: llama3-8b (reduced), dp=4 x pp=2.  Compiled windows are
# deterministic: w_fwd=11, w_bwd=22, w_sync=28, period 63, steps at
# slots 0/63/126 — step 1's gradient-sync window is [96, 124).
_TRAIN_DENSE = ScheduleSpec(model="llama3-8b", dp=4, tp=1, pp=2, steps=3,
                            microbatches=4, tokens_per_rank=1024,
                            line_rate_gbps=1.0, ckpt_every=2)

# MoE: phi3.5-moe (reduced), dp=4 x tp=2 — adds per-step EP all2all
# dispatch (capacity math) and TP streams.  Windows: w_fwd=27, w_bwd=54,
# w_sync=40, period 123, steps at 0/123/246 — step 1 sync = [204, 244).
_TRAIN_MOE = ScheduleSpec(model="phi3.5-moe-42b-a6.6b", dp=4, tp=2, pp=1,
                          steps=3, microbatches=4, tokens_per_rank=512,
                          line_rate_gbps=1.0)


@register
def train_step_baseline() -> ScenarioSpec:
    return ScenarioSpec(
        name="train_step_baseline",
        description="Training co-simulation baseline: 3 steps of a dense "
                    "llama3-8b (reduced) dp=4 x pp=2 schedule — DP ring "
                    "sync + pipeline edges phased by the demand-"
                    "multiplier timeline, checkpoint write after step 2.",
        topo=_TRAIN_TOPO,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("schedule", schedule=_TRAIN_DENSE),),
        sim=SimSpec(slots=260, slot_us=100.0, seed=22))


@register
def train_step_flap() -> ScenarioSpec:
    return ScenarioSpec(
        name="train_step_flap",
        description="Plane flap during training: rank 0 loses NIC plane "
                    "1 for exactly step 1's gradient-sync window "
                    "(slots 96-126) — fabric slowdown -> step-time "
                    "inflation -> recovery by step 2.",
        topo=_TRAIN_TOPO,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("schedule", schedule=_TRAIN_DENSE),),
        faults=(FaultSpec("access_kill", start_slot=96, stop_slot=126,
                          plane=1, host=0),),
        sim=SimSpec(slots=260, slot_us=100.0, seed=22))


@register
def train_step_flap_moe() -> ScenarioSpec:
    return ScenarioSpec(
        name="train_step_flap_moe",
        description="MoE variant: phi3.5-moe (reduced) dp=4 x tp=2 "
                    "schedule with per-step EP all2all dispatch; the "
                    "same plane flap covers step 1's sync window "
                    "(slots 204-246).",
        topo=_TRAIN_TOPO,
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("schedule", schedule=_TRAIN_MOE),),
        faults=(FaultSpec("access_kill", start_slot=204, stop_slot=246,
                          plane=1, host=0),),
        sim=SimSpec(slots=420, slot_us=100.0, seed=23))


@register
def giga_fabric_storage() -> ScenarioSpec:
    """The large-scale acceptance shape for the kernelized engine: a
    4096-host / 102,400-flow multiplane leaf-spine point in the style of
    Fig 14's giga-scale resiliency sweeps.  At this size the dense
    (leaves x leaves x paths x planes) load matrices are the memory
    bottleneck, so `agg_mode_default` flips the JAX engine to the
    sparse segment-summed path — `benchmarks/backend_bench.py --large`
    and `benchmarks/fig14_large_scale.py --giga` both time it."""
    return ScenarioSpec(
        name="giga_fabric_storage",
        description="Giga-scale point: 256 leaves x 16 hosts, 2 planes, "
                    "102,400 storage flows (fanout 25), 8 random fabric "
                    "link kills mid-run (Fig 14a-style concurrent "
                    "failures at scale).",
        topo=TopologySpec(n_leaves=256, n_spines=16, hosts_per_leaf=16,
                          n_planes=2),
        tenants=(TenantSpec("main"),),
        workloads=(WorkloadSpec("storage", demand=0.3, fanout=25),),
        faults=(FaultSpec("random_fail", start_slot=30, count=8,
                          frac=1.0, plane=-1),),
        # numpy default keeps the golden snapshot f64-deterministic;
        # the benchmarks dispatch it through backend="jax" explicitly
        sim=SimSpec(slots=60, seed=21, routing="ecmp", nic="spx"))
