"""Compile `FaultSpec` schedules to dense per-slot capacity timelines.

The slot engine consumes faults as data: for every slot `t` the timeline
holds the capacity *multiplier* (relative to the pristine capacity) of
every stage-A uplink `(T, P, L, S|A)` and downlink `(T, P, S|A, L)`, of
every fat-tree pod↔core link `(T, P, pods, C)` in each direction, and
of every access port `(T, P, H)`.  Multipliers compose the way in-place
topology mutations do (kills multiply, restores reset to 1), and every
random draw uses the same derived seed as the reference timeline
compiler, so the arrays are equal to the reference's element for
element.

`lagged_timeline` is the routing-visible view under failure reaction,
and `ecmp_assign_segments` replays ECMP's initial hash and dead-path
re-hash (or the fast-reroute walk) against such a timeline, once per
capacity segment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.netsim.sim import backup_reassign, rehash_dead_assign
from repro_torch.scenarios.spec import (FAULT_KINDS, FaultSpec,
                                        ScenarioSpec, fault_planes,
                                        flap_phase)


@dataclass(frozen=True)
class FaultTimeline:
    """Per-slot capacity multipliers, 1.0 = pristine.  All arrays are
    float64 and non-negative.  Stage A (`up`/`down`) is leaf↔spine on
    leaf_spine and leaf↔agg on fat_tree; `up2`/`down2` carry the
    fat-tree pod↔core tier and are None on leaf_spine."""
    up: np.ndarray         # (T, P, L, S|A)
    down: np.ndarray       # (T, P, S|A, L)
    access: np.ndarray     # (T, P, H)
    up2: Optional[np.ndarray] = None     # (T, P, pods, C)
    down2: Optional[np.ndarray] = None   # (T, P, pods, C)

    @property
    def slots(self) -> int:
        return self.up.shape[0]

    def change_slots(self) -> List[int]:
        """Slots (always including 0) at which any fabric multiplier —
        either stage, or access — differs from the previous slot: the
        only instants the ECMP re-hash or routing weights can see a
        different fabric."""
        stages = [self.up, self.down, self.access]
        if self.up2 is not None:
            stages += [self.up2, self.down2]
        out = [0]
        for t in range(1, self.slots):
            if any(not np.array_equal(s[t], s[t - 1]) for s in stages):
                out.append(t)
        return out


def check_timeline_faults(spec: ScenarioSpec) -> None:
    """Raise unless every fault is a `FaultSpec` kind this package
    lowers."""
    for f in spec.faults:
        if not isinstance(f, FaultSpec) or f.kind not in FAULT_KINDS:
            raise ValueError(
                f"{spec.name}: fault {f!r} is not a static FaultSpec")


# ---------------------------------------------------------------------------
# compiler
# ---------------------------------------------------------------------------

def _apply_fault(t: int, i: int, f: FaultSpec, up: np.ndarray,
                 down: np.ndarray, access: np.ndarray,
                 unit_rel: float, workload_seed: int,
                 up2: Optional[np.ndarray] = None,
                 down2: Optional[np.ndarray] = None,
                 sched: Sequence = ()) -> None:
    """Mutate multiplier arrays in place with fault `f`'s slot-`t` effect.
    `unit_rel` is one discrete stage-A link as a multiplier
    (link_cap/uplink_cap); stage-B core links are whole (unit 1.0).
    `up2`/`down2` are the fat-tree pod↔core multipliers (None on
    leaf_spine), and `spine` indices address pod-local aggs there.
    `sched` is a `poisson_flap` fault's (down, up, plane, link) table
    (`scenarios.compile.poisson_flap_schedule`)."""
    P = up.shape[0]
    if f.kind == "link_kill":
        if t == f.start_slot:
            for p in fault_planes(f, P):
                up[p, f.leaf, f.spine] *= (1.0 - f.frac)
                down[p, f.spine, f.leaf] *= (1.0 - f.frac)
        elif f.stop_slot is not None and t == f.stop_slot:
            for p in fault_planes(f, P):
                up[p, f.leaf, f.spine] = 1.0
                down[p, f.spine, f.leaf] = 1.0
    elif f.kind == "link_flap":
        ph = flap_phase(t, f)
        for p in fault_planes(f, P):
            if ph == "fail":
                up[p, f.leaf, f.spine] *= (1.0 - f.frac)
                down[p, f.spine, f.leaf] *= (1.0 - f.frac)
            elif ph == "restore":
                up[p, f.leaf, f.spine] = 1.0
                down[p, f.spine, f.leaf] = 1.0
    elif f.kind == "access_kill":
        if t == f.start_slot:
            for p in fault_planes(f, P):
                access[p, f.host] = 0.0
        elif f.stop_slot is not None and t == f.stop_slot:
            for p in fault_planes(f, P):
                access[p, f.host] = 1.0
    elif f.kind == "access_flap":
        ph = flap_phase(t, f)
        for p in fault_planes(f, P):
            if ph == "fail":
                access[p, f.host] = 0.0
            elif ph == "restore":
                access[p, f.host] = 1.0
    elif f.kind == "cascade":
        for j, s in enumerate(f.spines):
            if t == f.start_slot + j * f.period:
                for p in fault_planes(f, P):
                    if up2 is not None:
                        # fat_tree: whole agg-switch loss in pod f.pod —
                        # its leaf links AND its core links die
                        lpp = up.shape[1] // up2.shape[1]
                        lo, hi = f.pod * lpp, (f.pod + 1) * lpp
                        up[p, lo:hi, s] = 0.0
                        down[p, s, lo:hi] = 0.0
                        cpa = up2.shape[2] // up.shape[2]
                        up2[p, f.pod, s * cpa:(s + 1) * cpa] = 0.0
                        down2[p, f.pod, s * cpa:(s + 1) * cpa] = 0.0
                    else:
                        up[p, :, s] = 0.0
                        down[p, s, :] = 0.0
    elif f.kind == "straggler":
        if t == f.start_slot:
            for p in fault_planes(f, P):
                access[p, f.host] = f.frac
        elif f.stop_slot is not None and t == f.stop_slot:
            for p in fault_planes(f, P):
                access[p, f.host] = 1.0
    elif f.kind == "leaf_trim":
        if t == f.start_slot:
            for p in fault_planes(f, P):
                up[p, f.leaf, :] *= f.frac
                down[p, :, f.leaf] *= f.frac
    elif f.kind == "random_fail":
        if t == f.start_slot:
            # same derived stream as make_events: independent of other
            # faults' existence and firing order
            rng = np.random.default_rng((workload_seed, 7919, i))
            L, S = up.shape[1], up.shape[2]
            if f.count:
                # exact-k mode mirrors fail_uplink's multiplicative
                # degradation, draw for draw (fat_tree draws one index
                # over stage-A then stage-B links, like
                # `scenarios.compile._fail_random_link`)
                pods, C = ((up2.shape[1], up2.shape[2])
                           if up2 is not None else (0, 0))
                for p in fault_planes(f, P):
                    for _ in range(f.count):
                        if up2 is None:
                            leaf = int(rng.integers(L))
                            spine = int(rng.integers(S))
                            up[p, leaf, spine] *= (1.0 - f.frac)
                            down[p, spine, leaf] *= (1.0 - f.frac)
                            continue
                        idx = int(rng.integers(L * S + pods * C))
                        if idx < L * S:
                            up[p, idx // S, idx % S] *= (1.0 - f.frac)
                            down[p, idx % S, idx // S] *= (1.0 - f.frac)
                        else:
                            rem = idx - L * S
                            up2[p, rem // C, rem % C] *= (1.0 - f.frac)
                            down2[p, rem // C, rem % C] *= (1.0 - f.frac)
            else:
                for p in range(P):
                    mask = rng.random((L, S)) < f.frac
                    up[p] = np.maximum(up[p] - mask * unit_rel, 0.0)
                    down[p] = np.maximum(down[p] - mask.T * unit_rel, 0.0)
                    if up2 is not None:
                        mask2 = rng.random(up2.shape[1:]) < f.frac
                        up2[p] = np.maximum(up2[p] - mask2 * 1.0, 0.0)
                        down2[p] = np.maximum(down2[p] - mask2 * 1.0, 0.0)
    elif f.kind == "core_kill":
        if t == f.start_slot:
            for p in fault_planes(f, P):
                up2[p, f.pod, f.core] *= (1.0 - f.frac)
                down2[p, f.pod, f.core] *= (1.0 - f.frac)
        elif f.stop_slot is not None and t == f.stop_slot:
            for p in fault_planes(f, P):
                up2[p, f.pod, f.core] = 1.0
                down2[p, f.pod, f.core] = 1.0
    elif f.kind == "poisson_flap":
        # restores first (full-capacity reset), then kills multiply, so
        # a back-to-back flap re-kills; `link` indexes stage-A links
        # row-major, then (fat_tree) the pod-core links
        L, A = up.shape[1], up.shape[2]
        n_stage_a = L * A
        C = up2.shape[2] if up2 is not None else 0

        def place(link):
            if up2 is None or link < n_stage_a:
                return "a", link // A, link % A
            rem = link - n_stage_a
            return "b", rem // C, rem % C

        for dn, upslot, p, link in sched:
            if t != upslot:
                continue
            stage, x, y = place(link)
            if stage == "a":
                up[p, x, y] = 1.0
                down[p, y, x] = 1.0
            else:
                up2[p, x, y] = 1.0
                down2[p, x, y] = 1.0
        for dn, upslot, p, link in sched:
            if t != dn:
                continue
            stage, x, y = place(link)
            if stage == "a":
                up[p, x, y] *= (1.0 - f.frac)
                down[p, y, x] *= (1.0 - f.frac)
            else:
                up2[p, x, y] *= (1.0 - f.frac)
                down2[p, x, y] *= (1.0 - f.frac)
    else:                                            # pragma: no cover
        raise ValueError(f"unknown fault kind {f.kind!r}")


def compile_fault_timeline(spec: ScenarioSpec) -> FaultTimeline:
    """Lower `spec.faults` to dense multiplier timelines over
    `spec.sim.slots` slots.  Timeline[t] equals the fabric state *after*
    the slot-`t` events fired (mirroring `run_sim`, which applies events
    at the top of each slot)."""
    check_timeline_faults(spec)
    topo, T = spec.topo, spec.sim.slots
    fat = topo.kind == "fat_tree"
    P, L = topo.n_planes, topo.n_leaves
    S = topo.n_aggs if fat else topo.n_spines
    H = topo.n_hosts
    up = np.ones((P, L, S))
    down = np.ones((P, S, L))
    access = np.ones((P, H))
    up2 = np.ones((P, topo.n_pods, topo.n_cores)) if fat else None
    down2 = np.ones((P, topo.n_pods, topo.n_cores)) if fat else None
    unit_rel = topo.link_cap / topo.uplink_cap    # one discrete link
    scheds = {}
    if any(f.kind == "poisson_flap" for f in spec.faults):
        from repro_torch.scenarios.compile import poisson_flap_schedule
        scheds = {i: poisson_flap_schedule(spec, i)
                  for i, f in enumerate(spec.faults)
                  if f.kind == "poisson_flap"}
    out_up = np.empty((T, P, L, S))
    out_down = np.empty((T, P, S, L))
    out_access = np.empty((T, P, H))
    out_up2 = np.empty((T,) + up2.shape) if fat else None
    out_down2 = np.empty((T,) + down2.shape) if fat else None
    for t in range(T):
        for i, f in enumerate(spec.faults):
            _apply_fault(t, i, f, up, down, access, unit_rel,
                         spec.workload_seed, up2=up2, down2=down2,
                         sched=scheds.get(i, ()))
        out_up[t] = up
        out_down[t] = down
        out_access[t] = access
        if fat:
            out_up2[t] = up2
            out_down2[t] = down2
    return FaultTimeline(up=out_up, down=out_down, access=out_access,
                         up2=out_up2, down2=out_down2)


def lagged_timeline(tl: FaultTimeline, lag: int) -> FaultTimeline:
    """The routing-*visible* twin of a physical timeline under a failure
    reaction with `lag` slots of detection (and convergence) delay: the
    fabric stages shift right by `lag` (pristine 1.0 for t < lag); access
    stays all ones, since NIC probes see host access directly and an
    all-ones access lane keeps `change_slots()` fabric-driven."""

    def shift(a):
        if a is None:
            return None
        out = np.ones_like(a)
        out[lag:] = a[:a.shape[0] - lag]
        return out

    return FaultTimeline(up=shift(tl.up), down=shift(tl.down),
                         access=np.ones_like(tl.access),
                         up2=shift(tl.up2), down2=shift(tl.down2))


# ---------------------------------------------------------------------------
# ECMP assignment replay
# ---------------------------------------------------------------------------

def timeline_path_capacity(timeline: FaultTimeline, b: int,
                           src_leaf: np.ndarray, dst_leaf: np.ndarray,
                           uplink_cap: float = 1.0,
                           core_cap: float = 1.0,
                           cores_per_agg: int = 1,
                           leaves_per_pod: int = 0) -> np.ndarray:
    """(F, P, J) per-path capacity at boundary slot `b`.  Leaf-spine:
    the narrower of the flow's uplink and downlink through each spine.
    Fat tree (`up2` present): stage A through the path→agg map, composed
    with the pod↔core hops for cross-pod pairs."""
    if timeline.up2 is None:
        cap = np.minimum(
            timeline.up[b][:, src_leaf, :],
            np.swapaxes(timeline.down[b], 1, 2)[:, dst_leaf, :])  # (P, F, S)
        return cap.transpose(1, 0, 2) * uplink_cap                # (F, P, S)
    C = timeline.up2.shape[3]
    aj = np.arange(C) // cores_per_agg
    capA = np.minimum(
        timeline.up[b][:, src_leaf, :][:, :, aj],
        timeline.down[b][:, aj, :][:, :, dst_leaf].transpose(0, 2, 1))
    pod_s = src_leaf // leaves_per_pod
    pod_d = dst_leaf // leaves_per_pod
    capB = np.minimum(timeline.up2[b][:, pod_s, :],
                      timeline.down2[b][:, pod_d, :])             # (P, F, C)
    cross = (pod_s != pod_d)[None, :, None]
    cap = np.where(cross,
                   np.minimum(capA * uplink_cap, capB * core_cap),
                   capA * uplink_cap)
    return cap.transpose(1, 0, 2)                                 # (F, P, C)


def ecmp_assign_segments(src_leaf: np.ndarray, dst_leaf: np.ndarray,
                         timeline: FaultTimeline, seed: int,
                         n_paths: int, boundaries: Sequence[int],
                         uplink_cap: float = 1.0,
                         core_cap: float = 1.0,
                         cores_per_agg: int = 1,
                         leaves_per_pod: int = 0,
                         vis_timeline: Optional[FaultTimeline] = None,
                         mode: str = "instant",
                         backup: Optional[np.ndarray] = None
                         ) -> np.ndarray:
    """Replay the per-slot ECMP path assignment (initial hash + dead-path
    re-hash) against the static capacity timeline: (n_seg, F, P) int32,
    one assignment per capacity segment.

    A per-slot check draws from its RNG only on slots where an assigned
    path died with an alive alternative, which can only happen when
    capacity changed; replaying the check at each change boundary
    therefore consumes `np.random.default_rng(seed)` identically.

    Failure reaction: `vis_timeline` (the `lagged_timeline` view) makes
    the dead-path check steer against what routing has detected, not the
    physical fabric; `mode="backup"` replaces the re-hash by the RNG-free
    walk down the `backup` table (the initial hash is still drawn)."""
    check_tl = timeline if vis_timeline is None else vis_timeline
    F = src_leaf.shape[0]
    P = timeline.up.shape[1]
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n_paths, size=(F, P))
    segments = []
    for b in boundaries:
        cap = timeline_path_capacity(
            check_tl, b, src_leaf, dst_leaf, uplink_cap=uplink_cap,
            core_cap=core_cap, cores_per_agg=cores_per_agg,
            leaves_per_pod=leaves_per_pod)
        if mode == "backup":
            assign = backup_reassign(cap > 1e-12, assign, backup)
        else:
            assign = rehash_dead_assign(cap > 1e-12, assign, rng, n_paths)
        segments.append(np.asarray(assign).copy())
    return np.stack(segments).astype(np.int32)
