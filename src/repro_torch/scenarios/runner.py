"""Metric distillation: one run -> one `ScenarioMetrics` record.

  * per-tenant goodput mean / p01 / p99 across the tenant's flows
    (post-warmup, normalized to line rate);
  * isolation index — Jain fairness across tenants' demand-normalized
    goodput;
  * recovery slots after each fault transition — first slot at which
    total goodput re-attains 90% of the post-fault steady state;
  * completion-tail ratio — p99 / median completion slot over finite
    transfers;
  * §5.1 symmetry check on final uplink utilization;
  * under failure reaction, the blackholed bytes and the longest
    blackhole window after a fault transition;
  * with a captured trace, the §5 columns of `trace.trace_summary`
    (transient drops, straggler ranks, bi-modal port share).

The record and the distillation are copies of the reference runner's, so
rows from the two packages compare field by field.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.trace import trace_summary

from .compile import CompiledScenario, compile_scenario
from .spec import ScenarioSpec

# Trace- and reaction-derived columns, at the values that mean "not
# captured / not modeled" (the `ScenarioMetrics` defaults below).
TRACE_METRIC_DEFAULTS: Dict[str, object] = {
    "hft_transient_drops": -1,
    "bimodal_frac": float("nan"),
    "straggler_ranks": (),
    "blackholed_bytes": -1.0,
    "reaction_slots": -1,
}


# ---------------------------------------------------------------------------
# symmetry groups (§5.1)
# ---------------------------------------------------------------------------

@dataclass
class SymmetryReport:
    group: str
    uniform: bool
    cv: float                 # coefficient of variation
    outliers: List[int]


def symmetry_check(group: str, port_bw: np.ndarray,
                   cv_tol: float = 0.05, z_tol: float = 3.0
                   ) -> SymmetryReport:
    """AR produces structurally uniform load across a symmetry group (leaf
    uplinks, rails, planes); deviations indicate faults/misconfig."""
    bw = np.asarray(port_bw, np.float64)
    mu = bw.mean()
    sd = bw.std()
    cv = sd / mu if mu > 0 else 0.0
    z = np.abs(bw - mu) / max(sd, 1e-12)
    outliers = [int(i) for i in np.nonzero((z > z_tol) & (sd > 1e-9))[0]]
    return SymmetryReport(group=group, uniform=cv <= cv_tol, cv=float(cv),
                          outliers=outliers)


# ---------------------------------------------------------------------------
# metrics record
# ---------------------------------------------------------------------------

@dataclass
class ScenarioMetrics:
    scenario: str
    seed: int
    routing: str
    nic: str
    mean_goodput: float
    tenant_mean: Dict[str, float]
    tenant_p01: Dict[str, float]     # straggler tail — gates collectives
    tenant_p99: Dict[str, float]     # best-flow upper tail
    isolation_index: float
    recovery_slots: Tuple[Tuple[int, str, int], ...]  # (slot, label, rec)
    completion_tail: float
    symmetry_cv: float
    symmetry_uniform: bool
    symmetry_outliers: Tuple[Tuple[int, int], ...]    # (plane, spine)
    extra: Dict[str, float] = field(default_factory=dict)
    # §5 trace-derived columns — meaningful only when the point ran with
    # `sim.trace` enabled; the defaults mark "no trace captured"
    hft_transient_drops: int = -1
    bimodal_frac: float = float("nan")
    straggler_ranks: Tuple[int, ...] = ()
    # failure-reaction columns — meaningful only when the spec carries an
    # enabled `ReactionSpec`; the defaults mark "no reaction modeled"
    blackholed_bytes: float = -1.0
    reaction_slots: int = -1

    # ---- plain-dict form, field for field the reference record's ---------
    def to_dict(self) -> Dict:
        return {
            "scenario": self.scenario, "seed": int(self.seed),
            "routing": self.routing, "nic": self.nic,
            "mean_goodput": float(self.mean_goodput),
            "tenant_mean": dict(self.tenant_mean),
            "tenant_p01": dict(self.tenant_p01),
            "tenant_p99": dict(self.tenant_p99),
            "isolation_index": float(self.isolation_index),
            "recovery_slots": [list(r) for r in self.recovery_slots],
            "completion_tail": float(self.completion_tail),
            "symmetry_cv": float(self.symmetry_cv),
            "symmetry_uniform": bool(self.symmetry_uniform),
            "symmetry_outliers": [list(o) for o in self.symmetry_outliers],
            "extra": dict(self.extra),
            "hft_transient_drops": int(self.hft_transient_drops),
            "bimodal_frac": float(self.bimodal_frac),
            "straggler_ranks": [int(r) for r in self.straggler_ranks],
            "blackholed_bytes": float(self.blackholed_bytes),
            "reaction_slots": int(self.reaction_slots),
        }


# ---------------------------------------------------------------------------
# single run -> metrics
# ---------------------------------------------------------------------------

def _jain(x: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    if x.size == 0 or (x <= 0).all():
        return 1.0
    return float(x.sum() ** 2 / (x.size * (x ** 2).sum() + 1e-30))


def _reaction_slots(bh: np.ndarray, fault_slots) -> int:
    """Worst-case slots from a fault transition until its blackhole window
    closes: from the transition to the first slot at or after it where
    blackholed bytes go positive, then back to zero.  A window still open
    at the horizon counts to the horizon; transitions that never
    blackhole contribute 0."""
    worst = 0
    for slot, _label in fault_slots:
        seg = bh[slot:]
        pos = np.flatnonzero(seg > 1e-12)
        if pos.size == 0:
            continue
        closed = np.flatnonzero(seg[pos[0]:] <= 1e-12)
        worst = max(worst, int(pos[0] + closed[0]) if closed.size
                    else int(seg.size))
    return worst


def _recovery(total: np.ndarray, fault_slots, record_every: int,
              horizon: int) -> Tuple[Tuple[int, str, int], ...]:
    """Slots until total goodput re-attains 90% of the steady state that
    establishes itself before the next fault (or the run end).  -1 = never
    recovered inside the window."""
    out = []
    bounds = [s for s, _ in fault_slots] + [horizon]
    for i, (slot, label) in enumerate(fault_slots):
        lo = slot // record_every + 1
        hi = min(bounds[i + 1] // record_every, total.shape[0])
        post = total[lo:hi]
        if post.size == 0:
            out.append((slot, label, -1))
            continue
        tail = post[-max(1, post.size // 4):]
        steady = float(np.median(tail))
        ok = np.flatnonzero(post >= 0.9 * steady)
        rec = int((ok[0] + 1) * record_every) if ok.size else -1
        out.append((slot, label, rec))
    return tuple(out)


def run_point(spec: ScenarioSpec, device=None,
              dtype=None) -> ScenarioMetrics:
    """Compile + simulate one grid point and distill its metrics.
    `device` defaults to CUDA; `device="cpu"` runs the plain path."""
    c = compile_scenario(spec)
    return distill_metrics(spec, c, c.run(device=device, dtype=dtype))


def distill_metrics(spec: ScenarioSpec, c: CompiledScenario,
                    res) -> ScenarioMetrics:
    """Metric distillation of one run (the reference runner's, field for
    field).  `res` exposes mean_goodput / completion_slot /
    total_goodput / util_up_last / groups / group_of, as `EngineResult`
    and the reference engines' results do, under failure reaction
    `blackhole_timeline`, and with a trace enabled `trace`."""
    demand = np.array([f.demand for f in c.flows])
    tenant_mean: Dict[str, float] = {}
    tenant_p01: Dict[str, float] = {}
    tenant_p99: Dict[str, float] = {}
    norm: List[float] = []
    for gi, gname in enumerate(res.groups):
        sel = res.group_of == gi
        gp = res.mean_goodput[sel]
        tenant_mean[gname] = float(gp.mean())
        tenant_p01[gname] = float(np.quantile(gp, 0.01))
        tenant_p99[gname] = float(np.quantile(gp, 0.99))
        d = max(float(demand[sel].mean()), 1e-12)
        norm.append(float(gp.mean()) / d)

    total = np.asarray(res.total_goodput)
    denom = max(float(demand.sum()), 1e-12)
    recovery = _recovery(total / denom, c.fault_slots,
                         spec.sim.record_every, spec.sim.slots)

    finite = res.completion_slot[res.completion_slot >= 0]
    if finite.size >= 2 and np.median(finite) > 0:
        tail = float(np.quantile(finite, 0.99) / np.median(finite))
    else:
        tail = float("nan")

    # §5.1: per-plane spine-aggregate utilization should be uniform under
    # AR; outliers flag faults (expected when the scenario injects them).
    worst_cv, uniform, outliers = 0.0, True, []
    for p in range(res.util_up_last.shape[0]):
        rep = symmetry_check(f"plane{p}.spines",
                             res.util_up_last[p].sum(0))
        worst_cv = max(worst_cv, rep.cv)
        uniform &= rep.uniform
        outliers += [(p, s) for s in rep.outliers]

    # failure-reaction columns, present only when the run modeled
    # detection latency (spec.reaction enabled)
    bh = getattr(res, "blackhole_timeline", None)
    if bh is not None:
        bh = np.asarray(bh, np.float64)
        blackholed = float(bh.sum())
        react_slots = _reaction_slots(bh, c.fault_slots)
    else:
        blackholed, react_slots = -1.0, -1

    # §5.2/§5.3: trace-derived columns when the point captured one
    trace = getattr(res, "trace", None)
    extra: Dict = {}
    summ = {k: TRACE_METRIC_DEFAULTS[k] for k in
            ("hft_transient_drops", "bimodal_frac", "straggler_ranks")}
    if trace is not None:
        summ = trace_summary(trace, spec.topo.access_cap,
                             spec.topo.n_planes)
        if "port_classes" in summ:
            extra["port_classes"] = summ["port_classes"]

    return ScenarioMetrics(
        scenario=spec.name, seed=spec.sim.seed, routing=spec.sim.routing,
        nic=spec.sim.nic,
        mean_goodput=float(res.mean_goodput.mean()),
        tenant_mean=tenant_mean, tenant_p01=tenant_p01,
        tenant_p99=tenant_p99,
        isolation_index=_jain(np.asarray(norm)),
        recovery_slots=recovery, completion_tail=tail,
        symmetry_cv=float(worst_cv), symmetry_uniform=bool(uniform),
        symmetry_outliers=tuple(outliers), extra=extra,
        hft_transient_drops=int(summ["hft_transient_drops"]),
        bimodal_frac=float(summ["bimodal_frac"]),
        straggler_ranks=tuple(summ["straggler_ranks"]),
        blackholed_bytes=blackholed, reaction_slots=react_slots)
