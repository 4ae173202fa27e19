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

Batched execution lives in `repro_torch.experiments`: the `Experiment`
API sweeps arbitrary spec axes into a columnar `ResultSet` with an
on-disk run cache.  The (seed × routing × nic) `sweep`/`sweep_many`
entry points kept here are thin shims over its executor, as the
reference's are; they take `device`/`dtype` where the reference's take
`processes`/`backend`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.telemetry import SymmetryReport, symmetry_check
from repro_torch.trace import trace_summary

from .compile import CompiledScenario, compile_scenario
from .registry import get_scenario
from .spec import NICS, ROUTINGS, ScenarioSpec


@dataclass(frozen=True)
class SweepGrid:
    """The cartesian run grid.  Each seed perturbs both the sim seed and
    the workload seed (placement / pairing / ECMP hashes all re-draw).
    `routings`/`nics` of None inherit the spec's own setting; unknown or
    empty values raise immediately rather than silently falling back."""
    seeds: Tuple[int, ...] = (0,)
    routings: Optional[Tuple[str, ...]] = None
    nics: Optional[Tuple[str, ...]] = None
    slots: Optional[int] = None          # override spec.sim.slots

    def points(self, spec: ScenarioSpec) -> List[ScenarioSpec]:
        routings = (self.routings if self.routings is not None
                    else (spec.sim.routing,))
        nics = self.nics if self.nics is not None else (spec.sim.nic,)
        if not routings or not nics:
            raise ValueError(
                f"{spec.name}: sweep grid has an empty "
                f"{'routings' if not routings else 'nics'} tuple — pass "
                "None to inherit the spec's setting")
        for r in routings:
            if r not in ROUTINGS:
                raise ValueError(
                    f"{spec.name}: unknown routing {r!r} in sweep grid; "
                    f"known: {ROUTINGS}")
        for n in nics:
            if n not in NICS:
                raise ValueError(
                    f"{spec.name}: unknown nic {n!r} in sweep grid; "
                    f"known: {NICS}")
        out = []
        for seed in self.seeds:
            for routing in routings:
                for nic in nics:
                    s = spec.with_sim(seed=spec.sim.seed + seed,
                                      routing=routing, nic=nic,
                                      **({"slots": self.slots}
                                         if self.slots else {}))
                    out.append(s.with_workload_seed(
                        spec.workload_seed + seed))
        return out


# ---------------------------------------------------------------------------
# metric field table — the single source of truth for every serialization
# of a ScenarioMetrics record.  `kind` drives typed (de)serialization in
# `repro_torch.experiments.resultset`; `value` extracts the column value.
# Names double as the legacy CSV header and the ResultSet column names.
# ---------------------------------------------------------------------------

METRIC_FIELDS: Tuple[Tuple[str, str, Callable], ...] = (
    ("scenario",             "str",   lambda m: m.scenario),
    ("seed",                 "int",   lambda m: m.seed),
    ("routing",              "str",   lambda m: m.routing),
    ("nic",                  "str",   lambda m: m.nic),
    ("mean_goodput",         "float", lambda m: m.mean_goodput),
    ("isolation_index",      "float", lambda m: m.isolation_index),
    ("completion_tail",      "float", lambda m: m.completion_tail),
    ("symmetry_cv",          "float", lambda m: m.symmetry_cv),
    ("worst_recovery_slots", "int",   lambda m: m.worst_recovery()),
    ("symmetry_uniform",     "bool",  lambda m: m.symmetry_uniform),
    ("hft_transient_drops",  "int",   lambda m: m.hft_transient_drops),
    ("bimodal_frac",         "float", lambda m: m.bimodal_frac),
    ("blackholed_bytes",     "float", lambda m: m.blackholed_bytes),
    ("reaction_slots",       "int",   lambda m: m.reaction_slots),
    ("tenant_mean",          "json",  lambda m: m.tenant_mean),
    ("tenant_p01",           "json",  lambda m: m.tenant_p01),
    ("tenant_p99",           "json",  lambda m: m.tenant_p99),
    ("recovery_slots",       "json",  lambda m: m.recovery_slots),
    ("symmetry_outliers",    "json",  lambda m: m.symmetry_outliers),
    ("straggler_ranks",      "json",  lambda m: m.straggler_ranks),
    ("extra",                "json",  lambda m: m.extra),
)

METRIC_KINDS: Dict[str, str] = {n: k for n, k, _ in METRIC_FIELDS}
_METRIC_VALUE: Dict[str, Callable] = {n: v for n, _, v in METRIC_FIELDS}

# Trace- and reaction-derived columns, at the values that mean "not
# captured / not modeled" (the `ScenarioMetrics` defaults below).
# Serializations written before these columns existed get them filled
# with these when absent, so older ResultSet JSON/CSV and cache entries
# keep loading (see `resultset.from_json` / `ScenarioMetrics.from_dict`).
TRACE_METRIC_DEFAULTS: Dict[str, object] = {
    "hft_transient_drops": -1,
    "bimodal_frac": float("nan"),
    "straggler_ranks": (),
    "blackholed_bytes": -1.0,
    "reaction_slots": -1,
}


def metric_value(m: "ScenarioMetrics", name: str):
    """Column value of one metric field (see `METRIC_FIELDS`)."""
    return _METRIC_VALUE[name](m)


def _fmt_tenants(m: "ScenarioMetrics") -> str:
    return ";".join(f"{k}={v:.3f}" for k, v in sorted(m.tenant_mean.items()))


def _fmt_tail(m: "ScenarioMetrics") -> str:
    return ("nan" if np.isnan(m.completion_tail)
            else f"{m.completion_tail:.2f}")


# legacy flat-CSV view (`metrics_csv`): column -> cell formatter.  Header
# and rows both derive from this one table.
_CSV_COLUMNS: Tuple[Tuple[str, Callable[["ScenarioMetrics"], str]], ...] = (
    ("scenario",             lambda m: m.scenario),
    ("seed",                 lambda m: str(m.seed)),
    ("routing",              lambda m: m.routing),
    ("nic",                  lambda m: m.nic),
    ("mean_goodput",         lambda m: f"{m.mean_goodput:.4f}"),
    ("isolation_index",      lambda m: f"{m.isolation_index:.4f}"),
    ("completion_tail",      _fmt_tail),
    ("symmetry_cv",          lambda m: f"{m.symmetry_cv:.4f}"),
    ("worst_recovery_slots", lambda m: str(m.worst_recovery())),
    ("tenants",              _fmt_tenants),
)


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

    CSV_FIELDS = tuple(name for name, _ in _CSV_COLUMNS)

    @staticmethod
    def csv_header() -> str:
        return ",".join(ScenarioMetrics.CSV_FIELDS)

    def worst_recovery(self) -> int:
        recs = [r for _, _, r in self.recovery_slots]
        return max(recs) if recs else 0

    def to_row(self) -> str:
        return ",".join(fmt(self) for _, fmt in _CSV_COLUMNS)

    # ---- lossless dict round-trip (run cache / ResultSet JSON), field for
    # field the reference record's, so either package loads the other's
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

    @classmethod
    def from_dict(cls, d: Dict) -> "ScenarioMetrics":
        return cls(
            scenario=str(d["scenario"]), seed=int(d["seed"]),
            routing=str(d["routing"]), nic=str(d["nic"]),
            mean_goodput=float(d["mean_goodput"]),
            tenant_mean={str(k): float(v)
                         for k, v in d["tenant_mean"].items()},
            tenant_p01={str(k): float(v)
                        for k, v in d["tenant_p01"].items()},
            tenant_p99={str(k): float(v)
                        for k, v in d["tenant_p99"].items()},
            isolation_index=float(d["isolation_index"]),
            recovery_slots=tuple((int(s), str(l), int(r))
                                 for s, l, r in d["recovery_slots"]),
            completion_tail=float(d["completion_tail"]),
            symmetry_cv=float(d["symmetry_cv"]),
            symmetry_uniform=bool(d["symmetry_uniform"]),
            symmetry_outliers=tuple((int(p), int(s))
                                    for p, s in d["symmetry_outliers"]),
            extra={str(k): v for k, v in d.get("extra", {}).items()},
            hft_transient_drops=int(d.get("hft_transient_drops", -1)),
            bimodal_frac=float(d.get("bimodal_frac", float("nan"))),
            straggler_ranks=tuple(
                int(r) for r in d.get("straggler_ranks", ())),
            blackholed_bytes=float(d.get("blackholed_bytes", -1.0)),
            reaction_slots=int(d.get("reaction_slots", -1)))


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


def run_point(spec: ScenarioSpec, device=None, dtype=None,
              derive: Optional[Callable] = None) -> ScenarioMetrics:
    """Compile + simulate one grid point and distill its metrics.
    `device` defaults to CUDA; `device="cpu"` runs the plain path.
    `derive(spec, compiled, result) -> dict` computes per-run `extra`
    metrics from the raw simulation result."""
    c = compile_scenario(spec)
    res = c.run(device=device, dtype=dtype)
    m = distill_metrics(spec, c, res)
    if derive is not None:
        m.extra.update(derive(spec, c, res))
    return m


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


# ---------------------------------------------------------------------------
# sweeps — deprecated shims over repro_torch.experiments.execute
# ---------------------------------------------------------------------------

def _resolve(spec_or_name) -> ScenarioSpec:
    if isinstance(spec_or_name, str):
        return get_scenario(spec_or_name)
    return spec_or_name


def sweep(spec_or_name, grid: Optional[SweepGrid] = None, device=None,
          dtype=None) -> List[ScenarioMetrics]:
    """Run one scenario over a (seed × routing × nic) grid.

    Deprecated shim: lowers onto `repro_torch.experiments.execute_points`
    (the `Experiment` API's executor, megabatch dispatch), same row
    order.  `device` defaults to CUDA, `dtype` to float64.  Prefer
    `repro_torch.experiments.Experiment`, which also sweeps arbitrary
    spec axes, caches, and resumes."""
    from repro_torch.experiments.execute import execute_points
    spec = _resolve(spec_or_name)
    points = (grid or SweepGrid()).points(spec)
    return execute_points(points, device=device, dtype=dtype)


def sweep_many(names: Sequence, grid: Optional[SweepGrid] = None,
               device=None, dtype=None) -> List[ScenarioMetrics]:
    """Run several scenarios over one shared grid.

    Deprecated shim over `repro_torch.experiments.execute_points` (use an
    `Experiment` with a `scenario` axis instead); the grid runs as one
    megabatch either way."""
    from repro_torch.experiments.execute import execute_points
    points: List[ScenarioSpec] = []
    g = grid or SweepGrid()
    for n in names:
        points += g.points(_resolve(n))
    return execute_points(points, device=device, dtype=dtype)


def metrics_csv(rows: Iterable[ScenarioMetrics]) -> str:
    """Legacy flat CSV (see `_CSV_COLUMNS`).  `ResultSet.to_csv` is the
    lossless replacement."""
    return "\n".join([ScenarioMetrics.csv_header()] +
                     [m.to_row() for m in rows])
