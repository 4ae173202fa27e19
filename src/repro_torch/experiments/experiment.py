"""The `Experiment` spec: a named grid over arbitrary `ScenarioSpec`
override paths, executed into a columnar `ResultSet` through an on-disk
run cache.

    exp = Experiment(
        name="fault_fraction_x_planes",
        base="allreduce_under_random_failures",
        axes=product(Axis("faults[0].frac", (0.05, 0.1, 0.2)),
                     Axis("topo.n_planes", (1, 2, 4))),
    )
    rs = run_experiment(exp, cache=".expcache")     # on the GPU
    rs.pivot("axis.faults[0].frac", "axis.topo.n_planes",
             "mean_goodput")

Each grid point is the base spec with that point's coordinate values
applied in axis order ("scenario" replaces the base, "seed" perturbs
both `sim.seed` and `workload_seed`, everything else is an override
path), then validated.  Re-running with the same cache directory skips
every point whose fully-resolved spec hashes to a cached entry, so an
interrupted sweep resumes where it died.

A copy of the reference's `repro.experiments.experiment`, but for
`run_experiment`: every point runs on the port's slot engine, on
`device` (CUDA unless the caller passes `device="cpu"`) in `dtype`
(float64 unless float32 is asked for), through `execute_points`'
`dispatch` mode.  A spec's `sim.backend` is data here: it stays in the
spec (and its cache key) and selects nothing.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.netsim.engine import resolve_device
from repro_torch.scenarios.registry import get_scenario
from repro_torch.scenarios.spec import ScenarioSpec

from .axes import Axis, Chain, Product, Zip, product
from .cache import RunCache, spec_key
from .execute import execute_points
from .overrides import apply_override
from .resultset import ResultSet

GridExpr = Union[Axis, Product, Zip, Chain]


@dataclass(frozen=True)
class ExperimentPoint:
    """One fully-resolved grid point: its ordinal, its coordinate labels
    (axis path -> label), and the spec to run."""
    index: int
    coords: Dict[str, Any]
    spec: ScenarioSpec


@dataclass(frozen=True)
class Experiment:
    """A named parameter study.  `base` is a registry scenario name or an
    inline `ScenarioSpec` (optional when a "scenario" axis supplies it).
    `axes` is a grid expression — a single `Axis`, a combinator
    (`product`/`zip_axes`/`chain`), or a plain sequence of those, which
    is treated as an implicit product.  `derive(spec, compiled, result)
    -> dict` adds per-run `extra` metrics; it is folded into the cache
    key by qualified name, so it should be a module-level function."""
    name: str
    axes: Union[GridExpr, Sequence[GridExpr]]
    base: Union[str, ScenarioSpec, None] = None
    derive: Optional[Callable] = None
    description: str = ""

    def grid(self) -> GridExpr:
        if isinstance(self.axes, (Axis, Product, Zip, Chain)):
            return self.axes
        return product(*self.axes)

    def coord_names(self) -> List[str]:
        return list(self.grid().paths())

    def _base_spec(self) -> Optional[ScenarioSpec]:
        if self.base is None:
            return None
        if isinstance(self.base, str):
            return get_scenario(self.base)
        return self.base

    def points(self) -> List[ExperimentPoint]:
        base = self._base_spec()
        out: List[ExperimentPoint] = []
        for i, pt in enumerate(self.grid().points()):
            spec = base
            coords: Dict[str, Any] = {}
            overridden = False
            for path, value, label in pt:
                coords[path] = label
                if path == "scenario":
                    if overridden:
                        # replacing the spec now would silently discard
                        # the overrides already applied (while their
                        # coordinates still label the row) — refuse
                        raise ValueError(
                            f"experiment {self.name!r}: 'scenario' axis "
                            "must come before override axes — it "
                            "replaces the spec and would drop "
                            f"{[p for p, _, _ in pt if p != 'scenario']}")
                    spec = (get_scenario(value) if isinstance(value, str)
                            else value)
                    continue
                overridden = True
                if spec is None:
                    raise ValueError(
                        f"experiment {self.name!r}: no base scenario — "
                        "pass base= or lead with a 'scenario' axis")
                if path == "seed":
                    spec = spec.with_sim(
                        seed=spec.sim.seed + value).with_workload_seed(
                        spec.workload_seed + value)
                else:
                    spec = apply_override(spec, path, value)
            if spec is None:
                raise ValueError(
                    f"experiment {self.name!r}: no base scenario — "
                    "pass base= or lead with a 'scenario' axis")
            spec.validate()
            out.append(ExperimentPoint(index=i, coords=coords, spec=spec))
        return out

    def cache_salt(self) -> str:
        """Folds the derive hook's identity into cache keys: different
        extra-metric logic must not alias plain runs.  `functools.partial`
        of a module-level function is accepted (its bound arguments join
        the salt — e.g. a trace export directory)."""
        if self.derive is None:
            return ""
        d = self.derive
        if isinstance(d, functools.partial):
            inner = f"{d.func.__module__}.{d.func.__qualname__}"
            return f"{inner}{d.args!r}{sorted(d.keywords.items())!r}"
        return f"{d.__module__}.{d.__qualname__}"


def engine_salt(device, dtype) -> str:
    """The part of a cache salt that names what computed a row: the
    port's engine, the device type and the dtype, so a port row never
    aliases a reference row of the same spec, a CUDA row never a CPU
    row, and a float32 row never a float64 row."""
    return f"repro_torch.engine:{device.type}:{dtype}"


def run_experiment(exp: Experiment, device=None, dtype=None,
                   dispatch: Optional[str] = None,
                   cache: Union[RunCache, str, None] = None
                   ) -> ResultSet:
    """Execute the experiment grid into a `ResultSet`.

    `cache` is a `RunCache` or a directory path; cached points are
    served without running, fresh points stream into both the cache and
    the `ResultSet` as they complete (so an interrupt loses at most the
    in-flight points, and the next call resumes from the survivors).
    `device` defaults to CUDA (and raises without a GPU; `device="cpu"`
    runs the plain path), `dtype` to float64; `dispatch` is
    `execute_points`' ('megabatch', the default: one captured slot loop
    per (structure, routing, NIC) sub-batch; 'group'; 'serial').  Unlike
    the reference's there is no process pool and no compile cache, and
    `device`/`dtype`/`dispatch` replace `processes`/`backend`/
    `jx_dispatch`.  A `sim.backend` axis does not split the grid: every
    point runs on the port's engine.  The cache salt is `engine_salt`
    followed by `exp.cache_salt()`.  Rows come back in grid order;
    `rs.cache_hits` / `rs.cache_misses` report how the run was served."""
    if isinstance(cache, str):
        cache = RunCache(cache)
    device = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    pts = exp.points()
    salt = engine_salt(device, dtype) + exp.cache_salt()
    rs = ResultSet(exp.coord_names())
    pending: List[ExperimentPoint] = []
    for p in pts:
        hit = cache.get(spec_key(p.spec, salt)) if cache else None
        if hit is not None:
            rs.cache_hits += 1
            rs.append(hit, p.coords, order=p.index)
        else:
            pending.append(p)
    rs.cache_misses = len(pending)

    def on_result(j: int, m) -> None:
        p = pending[j]
        if cache is not None:
            cache.put(spec_key(p.spec, salt), p.spec, m)
        rs.append(m, p.coords, order=p.index)

    executions: List[Dict] = []
    if pending:
        fl: Dict = {}
        execute_points([p.spec for p in pending], device=device,
                       dtype=dtype, dispatch=dispatch, derive=exp.derive,
                       on_result=on_result, flight=fl)
        # executor point indices are pending-local; lift to grid order
        for pw in fl.get("points", ()):
            pw["index"] = pending[pw["index"]].index
        executions.append(fl)
    rs.flight = {"experiment": exp.name,
                 "cache_hits": rs.cache_hits,
                 "cache_misses": rs.cache_misses,
                 "executions": executions}
    rs.sort_to_grid_order()
    return rs


# ---------------------------------------------------------------------------
# experiment registry (mirrors the scenario registry)
# ---------------------------------------------------------------------------

EXPERIMENTS: Dict[str, Callable[[], Experiment]] = {}


def register_experiment(fn: Callable[[], Experiment]
                        ) -> Callable[[], Experiment]:
    exp = fn()
    exp.points()                      # fail at import, not first run
    EXPERIMENTS[exp.name] = fn
    return fn


def get_experiment(name: str) -> Experiment:
    try:
        return EXPERIMENTS[name]()
    except KeyError:
        raise KeyError(
            f"unknown experiment {name!r}; known: {sorted(EXPERIMENTS)}"
        ) from None


def list_experiments() -> List[str]:
    return sorted(EXPERIMENTS)
