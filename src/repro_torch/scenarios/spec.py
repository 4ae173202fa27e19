"""Declarative scenario DSL: tenants, workloads, faults, and simulation
parameters composed into a single picklable `ScenarioSpec`.

A scenario is data, not code: the spec layer carries *what* to simulate
(topology shape, which hosts belong to which tenant, which collective each
tenant runs, which links fail when), `compile.py` lowers it to topology,
flows and fault metadata for the slot engine, and `runner.py` distills
metrics.  Everything here is a frozen dataclass so specs hash, compare,
and cross process boundaries.

The schema is a field-for-field copy of the JAX package's scenario spec,
so the same registry names resolve to the same specs in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from repro_torch.trace import TraceSpec

WORKLOAD_KINDS = ("bisection", "all2all", "allreduce", "incast",
                  "permutation", "storage", "pairs", "one2many",
                  "schedule")
FAULT_KINDS = ("link_kill", "link_flap", "access_kill", "access_flap",
               "cascade", "straggler", "leaf_trim", "random_fail",
               "core_kill", "poisson_flap")
PLACEMENTS = ("block", "interleave", "random", "remainder", "explicit")
ROUTINGS = ("ar", "war", "ecmp")
NICS = ("spx", "dcqcn", "global", "esr", "swlb")
BACKENDS = ("numpy", "jax")
TOPOLOGY_KINDS = ("leaf_spine", "fat_tree")


class FaultBoundsError(ValueError):
    """A `FaultSpec` addresses a plane/leaf/spine/agg/pod/core/host
    outside the scenario's topology shape."""


@dataclass(frozen=True)
class TopologySpec:
    """Shape of the fabric.

    kind:
      'leaf_spine' — flat multiplane leaf–spine (mirrors `LeafSpine`):
                     one switching stage, `n_spines` paths per plane.
      'fat_tree'   — 3-tier leaf–agg–core baseline (mirrors `FatTree`):
                     `n_pods` pods of `n_leaves / n_pods` leaves and
                     `n_aggs` agg switches each, `n_cores` core switches
                     (a multiple of `n_aggs`; core `j` serves agg
                     `j // (n_cores // n_aggs)` in every pod).  `n_spines`
                     is unused.  `core_link_cap` <= 0 inherits
                     `uplink_cap`; oversubscription = host capacity
                     per leaf vs `n_aggs * uplink_cap` (stage A) and
                     agg ingress vs its core bundle (stage B).

    The fat-tree fields elide from content hashes at their defaults
    (`HASH_ELIDE_DEFAULTS`), so pre-existing leaf-spine specs keep their
    cache keys across this schema extension.
    """
    n_leaves: int = 8
    n_spines: int = 8
    hosts_per_leaf: int = 8
    n_planes: int = 1
    parallel_links: int = 1
    link_cap: float = 1.0
    access_cap: float = 1.0
    kind: str = "leaf_spine"
    n_pods: int = 1
    n_aggs: int = 1
    n_cores: int = 1
    core_link_cap: float = 0.0

    HASH_ELIDE_DEFAULTS = ("kind", "n_pods", "n_aggs", "n_cores",
                           "core_link_cap")

    @property
    def n_hosts(self) -> int:
        return self.n_leaves * self.hosts_per_leaf

    @property
    def uplink_cap(self) -> float:
        return self.link_cap * self.parallel_links

    @property
    def leaves_per_pod(self) -> int:
        return self.n_leaves // self.n_pods

    @property
    def core_cap(self) -> float:
        return (self.core_link_cap if self.core_link_cap > 0
                else self.uplink_cap)

    @property
    def n_paths(self) -> int:
        """Per-(leaf pair, plane) routing-choice axis: spines for
        leaf_spine, cores for fat_tree."""
        return self.n_spines if self.kind == "leaf_spine" else self.n_cores

    def validate(self, name: str = "topo") -> "TopologySpec":
        if self.kind not in TOPOLOGY_KINDS:
            raise ValueError(f"{name}: unknown topology kind "
                             f"{self.kind!r}; known: {TOPOLOGY_KINDS}")
        if self.kind == "fat_tree":
            if self.n_pods < 2:
                raise ValueError(
                    f"{name}: fat_tree requires n_pods >= 2 "
                    f"(got {self.n_pods}); use kind='leaf_spine' for a "
                    "single-stage fabric")
            if self.n_leaves % self.n_pods != 0:
                raise ValueError(
                    f"{name}: n_leaves ({self.n_leaves}) must be "
                    f"divisible by n_pods ({self.n_pods})")
            if self.n_aggs < 1 or self.n_cores % self.n_aggs != 0 \
                    or self.n_cores < self.n_aggs:
                raise ValueError(
                    f"{name}: n_cores ({self.n_cores}) must be a "
                    f"positive multiple of n_aggs ({self.n_aggs})")
        return self


@dataclass(frozen=True)
class TenantSpec:
    """A named set of hosts.  Tenants are resolved in declaration order and
    never overlap; each workload targets one tenant by name.

    placement:
      'explicit'   — use `hosts` verbatim.
      'block'      — `n_hosts` consecutive hosts starting at `offset`.
      'interleave' — every `stride`-th host starting at `offset`
                     (the paper's random-uniform placement proxy).
      'random'     — `n_hosts` drawn without replacement from the
                     still-unassigned pool (consumes workload rng).
      'remainder'  — every host not claimed by an earlier tenant.
    """
    name: str
    placement: str = "remainder"
    hosts: Tuple[int, ...] = ()
    n_hosts: Optional[int] = None
    offset: int = 0
    stride: int = 1


@dataclass(frozen=True)
class ScheduleSpec:
    """A training-step collective schedule to co-simulate (kind='schedule').

    Pure data: `model` names an entry in `repro_torch.configs.ARCHS`;
    byte volumes are derived at compile time by `repro_torch.comms` from
    the model's parameter layout (dtype-aware micro-chunk streams), MoE
    capacity math, and pipeline activation sizes — nothing heavy happens
    at spec time.

    Rank layout over the tenant's hosts is tp-fastest:
    ``rank = t + tp * (d + dp * p)`` for tp-coordinate `t`, dp-coordinate
    `d`, pp-stage `p`; the tenant must own at least ``dp * tp * pp`` hosts.

    `reduced` swaps in `ModelConfig.reduced()` (same family, tiny dims) so
    registry scenarios stay numpy-fast for golden snapshots; production
    sweeps set it False.  `line_rate_gbps` calibrates real bytes to
    simulator units: 1.0 capacity = one slot at line rate, i.e.
    ``sim_bytes = real_bytes / (line_rate_gbps * 125 * slot_us)``.
    `ckpt_every` > 0 adds background checkpoint-write flows after every
    k-th step (group 'ckpt').
    """
    model: str = "llama3-8b"
    dp: int = 2
    tp: int = 1
    pp: int = 1
    steps: int = 2
    microbatches: int = 4
    tokens_per_rank: int = 2048
    line_rate_gbps: float = 400.0
    ckpt_every: int = 0
    reduced: bool = True

    @property
    def n_ranks(self) -> int:
        return self.dp * self.tp * self.pp

    def validate(self, name: str) -> "ScheduleSpec":
        for f in ("dp", "tp", "pp", "steps", "microbatches",
                  "tokens_per_rank"):
            if getattr(self, f) < 1:
                raise ValueError(
                    f"{name}: schedule.{f} must be >= 1, got "
                    f"{getattr(self, f)}")
        if self.line_rate_gbps <= 0:
            raise ValueError(
                f"{name}: schedule.line_rate_gbps must be > 0, got "
                f"{self.line_rate_gbps}")
        if self.ckpt_every < 0:
            raise ValueError(
                f"{name}: schedule.ckpt_every must be >= 0, got "
                f"{self.ckpt_every}")
        if self.dp < 2:
            raise ValueError(
                f"{name}: schedule requires dp >= 2 (got {self.dp}) — "
                "the per-step DP gradient sync is what defines step "
                "completion")
        return self


@dataclass(frozen=True)
class WorkloadSpec:
    """One traffic pattern bound to a tenant.

    kind:
      'bisection'   — worst-case cross-spine pairing at line rate (Fig 8).
      'all2all'     — full-mesh, per-flow demand 1/(n-1) (Fig 9).
      'allreduce'   — ring neighbor streams (AllGather/ReduceScatter).
      'incast'      — every non-sink tenant host sends to `sinks` sinks.
      'permutation' — random ring over a shuffled host order.
      'storage'     — low-rate background: each host to `fanout` random
                      peers (checkpoint/dataset traffic proxy).
      'pairs'       — explicit (src, dst) list.
      'one2many'    — the tenant's first `srcs` hosts each stream to
                      every remaining host, per-flow demand
                      `demand / n_dsts` (Fig 15's burst pattern).
      'schedule'    — a compiled training-step collective schedule
                      (`schedule` field): DP ring allreduce streams, MoE
                      all2all dispatch, PP send/recv edges, and optional
                      checkpoint writes, phased over time via the
                      demand-multiplier timeline (`repro_torch.comms`).

    `demand` scales the builder's native per-flow rate ('incast',
    'permutation', 'storage', 'pairs' use it directly as the per-flow
    offered rate).  `bytes_total` turns an open-loop stream into a
    finite transfer (enables completion-tail metrics); `start_slot`
    delays admission (staggered bursts).
    """
    kind: str
    tenant: str = "main"
    demand: float = 1.0
    bytes_total: float = float("inf")
    start_slot: int = 0
    sinks: int = 1                       # incast
    fanout: int = 2                      # storage
    srcs: int = 1                        # one2many
    pairs: Tuple[Tuple[int, int], ...] = ()
    group: Optional[str] = None          # metric group; default = tenant
    schedule: Optional[ScheduleSpec] = None   # kind='schedule' only

    # `schedule` elides from content hashes at its default so every
    # pre-existing spec keeps its cache key across this schema extension.
    HASH_ELIDE_DEFAULTS = ("schedule",)


@dataclass(frozen=True)
class FaultSpec:
    """One failure/degradation schedule applied to the topology.

    kind:
      'link_kill'   — remove `frac` of (plane, leaf, spine) uplink at
                      `start_slot`; restore at `stop_slot` if set.
      'link_flap'   — periodic kill/restore of one uplink: down for
                      `duty`×`period` slots of every `period`, between
                      `start_slot` and `stop_slot`.
      'access_kill' — host NIC-plane port down at `start_slot`
                      (restored at `stop_slot` if set).
      'access_flap' — periodic version of access_kill.
      'cascade'     — rolling switch loss: spine `spines[i]` dies (all
                      leaves) at `start_slot + i*period`.  On fat_tree
                      the indices address agg switches of pod `pod`,
                      and the whole switch dies: its leaf links AND its
                      core links.
      'straggler'   — host access capacity scaled to `frac` between
                      `start_slot` and `stop_slot` (slow-rank injection).
      'leaf_trim'   — leaf uplink capacity scaled to `frac` at
                      `start_slot` (Fig 16 consolidation).
      'random_fail' — random fabric link failures at `start_slot`:
                      `count` = 0 fails each link independently with
                      probability `frac` (Fig 1c / §6.4); `count` > 0
                      draws exactly `count` fabric links per selected
                      plane and multiplies each by `1 - frac` — `frac=1`
                      kills the link outright (Fig 14a's k-concurrent-
                      failure sweeps).  On fat_tree both stages (leaf–agg
                      and pod–core links) are in the draw population.
      'core_kill'   — fat_tree only: remove `frac` of the (plane, pod,
                      core) stage-B link pair at `start_slot`; restore at
                      `stop_slot` if set (the tier the multiplane design
                      deletes — §3.1).
      'poisson_flap'— fleet-MTBF flap storm (§6.6): every fabric link on
                      the selected plane(s) flaps independently with
                      exponential inter-arrivals so the *fleet-wide* rate
                      is `flaps_per_min`; each flap multiplies the link
                      by `1 - frac` for `down_slots` slots.  Arrival
                      times come from `core.fault_tolerance.poisson_flaps`
                      seeded by (workload_seed, fault index), so both
                      backends replay the identical schedule.

    `plane` = -1 applies to every plane.  On fat_tree topologies `spine`
    addresses the pod-local agg index for link faults.  `validate()`
    bound-checks every index a fault uses against the topology shape and
    raises `FaultBoundsError` otherwise.

    New tier fields (`pod`, `core`) elide from content hashes at their
    defaults so pre-existing specs keep their cache keys.
    """
    kind: str
    start_slot: int = 0
    stop_slot: Optional[int] = None
    period: int = 0
    duty: float = 0.5
    plane: int = 0
    leaf: int = 0
    spine: int = 0
    spines: Tuple[int, ...] = ()
    host: int = 0
    frac: float = 1.0
    count: int = 0                       # random_fail: exact-k mode
    pod: int = 0                         # core_kill / fat_tree cascade
    core: int = 0                        # core_kill
    flaps_per_min: float = 0.0           # poisson_flap: fleet-wide rate
    down_slots: int = 0                  # poisson_flap: outage length

    HASH_ELIDE_DEFAULTS = ("pod", "core", "flaps_per_min", "down_slots")


REACTION_MODES = ("instant", "rehash", "backup")


@dataclass(frozen=True)
class ReactionSpec:
    """How routing *reacts* to fabric faults — the paper's <3 ms
    hardware failover vs ~1 s software LB distinction (§6.4, and the
    MRC/SRv6 precomputed-backup design point).

    Without a reaction spec (the default), routing sees every capacity
    change the same slot it happens — instantaneous, perfect detection.
    With one, routing steers against a *visible* copy of the fabric that
    lags physical state by `detect_slots`: a failed link keeps
    attracting traffic (black-holed bytes) until detection fires.

    mode:
      'instant' — reproduce the no-reaction behavior bit-identically
                  (requires both delays zero; useful as a sweep axis
                  baseline).
      'rehash'  — software-LB analog: after detection, the control
                  plane takes a further `converge_slots` to push new
                  state; ECMP flows on dead paths then re-hash onto
                  survivors (the usual seeded draw).  Total lag =
                  `detect_slots + converge_slots`.
      'backup'  — hardware fast-reroute analog (MRC/SRv6): the slot
                  detection fires, affected (flow, plane) entries switch
                  to the next alive path in a backup table precomputed
                  per fabric kind at compile time — no RNG, no extra
                  convergence.  Total lag = `detect_slots`.

    `converge_slots` is read by 'rehash' only; 'backup' ignores it (so a
    sweep can hold it fixed while toggling the mode axis)."""
    detect_slots: int = 0
    mode: str = "instant"
    converge_slots: int = 0

    @property
    def enabled(self) -> bool:
        """True when the reaction layer changes behavior at all."""
        return self.mode != "instant"


def reaction_lag(reaction: Optional[ReactionSpec], routing: str) -> int:
    """Slots by which the routing-visible fabric lags physical state.
    One number per run — shared by both backends so the lowering cannot
    drift.  `routing` is accepted for future mode/routing interplay;
    today the lag is routing-independent."""
    if reaction is None or not reaction.enabled:
        return 0
    lag = reaction.detect_slots
    if reaction.mode == "rehash":
        lag += reaction.converge_slots
    return lag


@dataclass(frozen=True)
class SimSpec:
    """Simulation parameters (mirrors `netsim.sim.SimConfig`)."""
    slots: int = 400
    slot_us: float = 10.0
    routing: str = "ar"          # 'ar' | 'war' | 'ecmp'
    nic: str = "spx"             # 'spx' | 'dcqcn' | 'global' | 'esr' | 'swlb'
    base_rtt_us: float = 4.0
    warmup_frac: float = 0.25
    sw_lb_delay_ms: float = 1000.0
    seed: int = 0
    record_every: int = 1
    backend: str = "numpy"       # 'numpy' | 'jax'
    trace: TraceSpec = TraceSpec()

    # Tracing never changes simulated physics, and the default spec is
    # elided from the canonical hash, so pre-trace cache entries and
    # spec keys stay valid.
    HASH_ELIDE_DEFAULTS = ("trace",)


@dataclass(frozen=True)
class ScenarioSpec:
    """A complete, self-describing experiment."""
    name: str
    topo: TopologySpec = field(default_factory=TopologySpec)
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("main"),)
    workloads: Tuple[WorkloadSpec, ...] = ()
    faults: Tuple[FaultSpec, ...] = ()
    sim: SimSpec = field(default_factory=SimSpec)
    workload_seed: int = 0
    description: str = ""
    reaction: Optional[ReactionSpec] = None

    # `reaction` elides from content hashes at its default so every
    # pre-existing spec keeps its cache key across this schema extension.
    HASH_ELIDE_DEFAULTS = ("reaction",)

    # ---- ergonomic copies -------------------------------------------------
    def with_sim(self, **kw) -> "ScenarioSpec":
        """Copy with SimSpec fields replaced (nic/routing/slots/seed/...)."""
        return replace(self, sim=replace(self.sim, **kw))

    def with_workload_seed(self, seed: int) -> "ScenarioSpec":
        return replace(self, workload_seed=seed)

    def validate(self) -> "ScenarioSpec":
        self.topo.validate(f"{self.name}: topo")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"{self.name}: duplicate tenant names {names}")
        for t in self.tenants:
            if t.placement not in PLACEMENTS:
                raise ValueError(
                    f"{self.name}: unknown placement {t.placement!r}")
            if t.placement == "explicit" and not t.hosts:
                raise ValueError(
                    f"{self.name}: tenant {t.name} explicit but no hosts")
        for w in self.workloads:
            if w.kind not in WORKLOAD_KINDS:
                raise ValueError(f"{self.name}: unknown workload {w.kind!r}")
            if w.tenant not in names:
                raise ValueError(
                    f"{self.name}: workload targets unknown tenant "
                    f"{w.tenant!r}")
            if w.kind == "one2many" and w.srcs < 1:
                raise ValueError(
                    f"{self.name}: one2many requires srcs >= 1, got "
                    f"{w.srcs}")
            if w.kind == "pairs":
                bad = [p for p in w.pairs
                       for h in p if not 0 <= h < self.topo.n_hosts]
                if bad:
                    raise ValueError(
                        f"{self.name}: pairs endpoints outside "
                        f"[0, {self.topo.n_hosts}): {bad}")
            if w.kind == "schedule":
                if w.schedule is None:
                    raise ValueError(
                        f"{self.name}: schedule workload requires the "
                        "schedule field")
                w.schedule.validate(self.name)
                if w.schedule.n_ranks > self.topo.n_hosts:
                    raise ValueError(
                        f"{self.name}: schedule needs "
                        f"{w.schedule.n_ranks} ranks but the topology "
                        f"has only {self.topo.n_hosts} hosts")
            elif w.schedule is not None:
                raise ValueError(
                    f"{self.name}: schedule field set on a "
                    f"{w.kind!r} workload (only kind='schedule' uses it)")
        for f in self.faults:
            if f.kind not in FAULT_KINDS:
                raise ValueError(f"{self.name}: unknown fault {f.kind!r}")
            if f.kind in ("link_flap", "access_flap", "cascade") \
                    and f.period <= 0:
                raise ValueError(
                    f"{self.name}: {f.kind} requires period > 0, got "
                    f"{f.period}")
            if f.kind == "cascade" and not f.spines:
                raise ValueError(f"{self.name}: cascade requires spines")
            if f.kind == "poisson_flap":
                if f.flaps_per_min <= 0:
                    raise ValueError(
                        f"{self.name}: poisson_flap requires "
                        f"flaps_per_min > 0, got {f.flaps_per_min}")
                if f.down_slots <= 0:
                    raise ValueError(
                        f"{self.name}: poisson_flap requires "
                        f"down_slots >= 1, got {f.down_slots}")
            else:
                if f.flaps_per_min or f.down_slots:
                    raise ValueError(
                        f"{self.name}: flaps_per_min/down_slots apply "
                        f"only to poisson_flap, not {f.kind!r}")
            if f.count < 0:
                raise ValueError(
                    f"{self.name}: fault count must be >= 0, got "
                    f"{f.count}")
            if f.count and f.kind != "random_fail":
                raise ValueError(
                    f"{self.name}: count applies only to random_fail, "
                    f"not {f.kind!r}")
            _check_fault_bounds(self.name, f, self.topo)
        if self.reaction is not None:
            r = self.reaction
            if r.mode not in REACTION_MODES:
                raise ValueError(
                    f"{self.name}: unknown reaction mode {r.mode!r}; "
                    f"known: {REACTION_MODES}")
            if r.detect_slots < 0 or r.converge_slots < 0:
                raise ValueError(
                    f"{self.name}: reaction delays must be >= 0, got "
                    f"detect_slots={r.detect_slots} "
                    f"converge_slots={r.converge_slots}")
            if r.mode == "instant" and (r.detect_slots or
                                        r.converge_slots):
                raise ValueError(
                    f"{self.name}: reaction mode 'instant' requires "
                    "zero detect_slots/converge_slots (got "
                    f"detect_slots={r.detect_slots} "
                    f"converge_slots={r.converge_slots}); pick 'rehash' "
                    "or 'backup' for a delayed reaction")
            bad_kinds = sorted({f.kind for f in self.faults
                                if f.kind == "straggler"})
            if r.enabled and bad_kinds:
                raise ValueError(
                    f"{self.name}: reaction mode {r.mode!r} is "
                    f"incompatible with fault kinds {bad_kinds} — a "
                    "straggler degrades host access capacity, which NIC "
                    "probes observe directly; fabric reroute reaction "
                    "does not apply")
        if self.sim.routing not in ROUTINGS:
            raise ValueError(
                f"{self.name}: unknown routing {self.sim.routing!r}")
        if self.sim.nic not in NICS:
            raise ValueError(f"{self.name}: unknown nic {self.sim.nic!r}")
        if self.sim.backend not in BACKENDS:
            raise ValueError(
                f"{self.name}: unknown backend {self.sim.backend!r}")
        try:
            self.sim.trace.validate()
        except ValueError as e:
            raise ValueError(f"{self.name}: {e}") from None
        return self


def _check_fault_bounds(name: str, f: FaultSpec,
                        topo: TopologySpec) -> None:
    """Bound-check every index a fault actually uses against the
    topology shape, so an out-of-range index fails validation instead of
    dying — or silently wrapping via negative indexing — deep inside the
    timeline compiler."""
    def bad(field: str, value: int, n: int, axis: str) -> None:
        raise FaultBoundsError(
            f"{name}: fault {f.kind!r} {field}={value} outside "
            f"[0, {n}) ({axis})")

    if not (f.plane == -1 or 0 <= f.plane < topo.n_planes):
        raise FaultBoundsError(
            f"{name}: fault {f.kind!r} plane={f.plane} outside "
            f"[0, {topo.n_planes}) (and not -1 = all planes)")
    n_up = topo.n_spines if topo.kind == "leaf_spine" else topo.n_aggs
    up_axis = "spines" if topo.kind == "leaf_spine" else "aggs per pod"
    if f.kind in ("link_kill", "link_flap"):
        if not 0 <= f.leaf < topo.n_leaves:
            bad("leaf", f.leaf, topo.n_leaves, "leaves")
        if not 0 <= f.spine < n_up:
            bad("spine", f.spine, n_up, up_axis)
    elif f.kind == "leaf_trim":
        if not 0 <= f.leaf < topo.n_leaves:
            bad("leaf", f.leaf, topo.n_leaves, "leaves")
    elif f.kind == "cascade":
        for s in f.spines:
            if not 0 <= s < n_up:
                bad("spines[...]", s, n_up, up_axis)
        if topo.kind == "fat_tree" and not 0 <= f.pod < topo.n_pods:
            bad("pod", f.pod, topo.n_pods, "pods")
    elif f.kind in ("access_kill", "access_flap", "straggler"):
        if not 0 <= f.host < topo.n_hosts:
            bad("host", f.host, topo.n_hosts, "hosts")
    elif f.kind == "core_kill":
        if topo.kind != "fat_tree":
            raise FaultBoundsError(
                f"{name}: fault 'core_kill' requires a fat_tree "
                f"topology (got kind={topo.kind!r})")
        if not 0 <= f.pod < topo.n_pods:
            bad("pod", f.pod, topo.n_pods, "pods")
        if not 0 <= f.core < topo.n_cores:
            bad("core", f.core, topo.n_cores, "cores")


def fault_planes(f: FaultSpec, n_planes: int) -> Tuple[int, ...]:
    """Planes a fault applies to (`plane=-1` means every plane)."""
    return tuple(range(n_planes)) if f.plane < 0 else (f.plane,)


def flap_phase(t: int, f: FaultSpec) -> str:
    """'fail' | 'restore' | '' for a periodic *_flap fault at slot `t`.
    Single source of truth for the duty/period/stop arithmetic — the
    event-callback path (`compile.make_events`) and the JAX timeline
    compiler (`netsim.jx.events`) must agree bit-for-bit."""
    stop = float("inf") if f.stop_slot is None else f.stop_slot
    if f.start_slot <= t < stop:
        ph = (t - f.start_slot) % f.period
        down = max(1, int(f.period * f.duty))
        if ph == 0:
            return "fail"
        if ph == down:
            return "restore"
    elif f.stop_slot is not None and t == f.stop_slot:
        return "restore"
    return ""


def fault_transition_slots(f: FaultSpec, horizon: int, sched=None
                           ) -> Tuple[Tuple[int, str], ...]:
    """Slots (< horizon) at which this fault *degrades* the fabric —
    the instants the runner measures recovery from.  Restores are not
    transitions.  `sched` is the precomputed per-link slot schedule for
    kind='poisson_flap' (see `scenarios.compile.poisson_flap_schedule`)
    — arrival times are seeded draws, so the schedule must be computed
    once and shared with the event/timeline lowering."""
    out = []
    if f.kind == "poisson_flap":
        return tuple(sorted({(int(t), "poisson_flap")
                             for t, _, _, _ in (sched or ())
                             if t < horizon}))
    if f.kind in ("link_kill", "access_kill", "straggler", "leaf_trim",
                  "random_fail", "core_kill"):
        if f.start_slot < horizon:
            out.append((f.start_slot, f.kind))
    elif f.kind in ("link_flap", "access_flap"):
        stop = horizon if f.stop_slot is None else min(f.stop_slot, horizon)
        t = f.start_slot
        while t < stop:
            out.append((t, f.kind))
            t += f.period
    elif f.kind == "cascade":
        for i, _ in enumerate(f.spines):
            t = f.start_slot + i * f.period
            if t < horizon:
                out.append((t, f"cascade[{i}]"))
    return tuple(out)
