"""The port's Experiment API and sweep executor on the CPU, held to the
JAX package's `repro.experiments` and `repro.scenarios.runner`.

The pure-NumPy copies (override paths, grid axes, `ResultSet`, the run
cache's `canonicalize`/`spec_key`, the sweep grid and the flat CSV) must
behave as the reference's on the same inputs: equal error messages,
equal point lists, equal cache keys for every registry scenario and
every point of every library experiment, and `ResultSet` JSON and CSV
that either package reads from the other.

Rows: `fig9_isolation`, `topo_kind_resiliency` and `reroute_reaction`
run through the port's `run_experiment(..., device="cpu")`, cut to 80
slots through their base or scenario specs' `sim.slots` (the registered
sizes run on the card in `chip_smoke.py`'s sweep phase).  They are held,
under `_assert_rows_equal` (floats within 1e-5, `extra` included), to
rows built from the reference through `compile_scenario(spec).run(
backend="jax")` under `jax.enable_x64(True)` and the reference's derive
hook (not the reference's executor, whose megabatch path needs
`jax.experimental.enable_x64`).  The three dispatch modes give equal
rows; the cache serves hits, recomputes misses and corrupt entries,
resumes an interrupted run, keeps float32 and float64 rows apart and is
never served a reference-written entry.
"""
import dataclasses
import json
import math
import warnings

import jax
import pytest
import torch

from repro.experiments import Axis as JxAxis
from repro.experiments import OverridePathError as JxOverridePathError
from repro.experiments import ResultSet as JxResultSet
from repro.experiments import RunCache as JxRunCache
from repro.experiments import apply_override as jx_apply_override
from repro.experiments import canonicalize as jx_canonicalize
from repro.experiments import chain as jx_chain
from repro.experiments import get_experiment as jx_get_experiment
from repro.experiments import get_path as jx_get_path
from repro.experiments import list_experiments as jx_list_experiments
from repro.experiments import product as jx_product
from repro.experiments import run_experiment as jx_run_experiment
from repro.experiments import spec_key as jx_spec_key
from repro.experiments import zip_axes as jx_zip_axes
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import distill_metrics as jx_distill
from repro.scenarios import get_scenario as jx_get
from repro.scenarios import list_scenarios as jx_list
from repro.scenarios.runner import ScenarioMetrics as JxScenarioMetrics
from repro.scenarios.runner import SweepGrid as JxSweepGrid
from repro.scenarios.runner import metric_value as jx_metric_value
from repro.scenarios.runner import metrics_csv as jx_metrics_csv
from repro.scenarios.runner import sweep as jx_sweep
from repro.scenarios.runner import sweep_many as jx_sweep_many
from repro_torch.experiments import (EXPERIMENTS, Axis, OverridePathError,
                                     ResultSet, RunCache, apply_override,
                                     chain,
                                     canonicalize, engine_salt,
                                     execute_points, get_experiment,
                                     get_path, list_experiments, product,
                                     run_experiment, spec_key, zip_axes)
from repro_torch.netsim import engine
from repro_torch.scenarios import get_scenario, list_scenarios
from repro_torch.scenarios.runner import (METRIC_FIELDS, ScenarioMetrics,
                                          SweepGrid, metric_value,
                                          metrics_csv, sweep, sweep_many)


SLOTS = 80
ROW_EXPERIMENTS = ("fig9_isolation", "topo_kind_resiliency",
                   "reroute_reaction")


def _cut_grid(g, get, slots):
    """`g` with every spec a "scenario" axis names cut to `slots` (its
    labels kept, so the coordinates stay the registry names)."""
    if isinstance(g, (Axis, JxAxis)):
        if g.path != "scenario":
            return g
        specs = tuple((get(v) if isinstance(v, str) else v)
                      .with_sim(slots=slots) for v in g.values)
        labels = g.labels if g.labels is not None else tuple(
            v if isinstance(v, str) else v.name for v in g.values)
        return type(g)("scenario", specs, labels)
    if isinstance(g, (tuple, list)):
        return tuple(_cut_grid(x, get, slots) for x in g)
    return type(g)(tuple(_cut_grid(x, get, slots) for x in g.grids))


def _cut(exp, get=get_scenario, slots=SLOTS):
    """A library experiment at `slots` slots, through its base spec's (or
    its scenario axis' specs') `sim.slots`; `slots=None` leaves it at its
    registered size."""
    if slots is None:
        return exp
    base = exp.base
    if base is not None:
        base = (get(base) if isinstance(base, str) else base) \
            .with_sim(slots=slots)
    return dataclasses.replace(exp, base=base,
                               axes=_cut_grid(exp.axes, get, slots))


def _reference_rows(name, slots=SLOTS):
    """The reference's rows of a library experiment at `slots` slots:
    its JAX engine under x64 and its derive hook, point by point."""
    exp = _cut(jx_get_experiment(name), jx_get, slots)
    rows = []
    with jax.enable_x64(True):
        for p in exp.points():
            c = jx_compile(p.spec)
            r = c.run(backend="jax")
            m = jx_distill(p.spec, c, r)
            if exp.derive is not None:
                m.extra.update(exp.derive(p.spec, c, r))
            rows.append((p, m))
    return rows


def _assert_close(g, w, path, tol):
    """Floats within `tol` (absolute or relative, NaN equal to NaN),
    dicts and sequences item by item, everything else exactly."""
    if isinstance(w, float):
        assert (math.isnan(g) and math.isnan(w)) or \
            math.isclose(g, w, rel_tol=tol, abs_tol=tol), (path, g, w)
    elif isinstance(w, dict):
        assert g.keys() == w.keys(), path
        for k in w:
            _assert_close(g[k], w[k], f"{path}.{k}", tol)
    elif isinstance(w, (list, tuple)):
        assert len(g) == len(w), path
        for i, (a, b) in enumerate(zip(g, w)):
            _assert_close(a, b, f"{path}[{i}]", tol)
    else:
        assert g == w, (path, g, w)


def _assert_rows_equal(got, want, tol=1e-5):
    """Distilled rows field by field, `extra` included: the contract of
    `test_torch_engine.py::_assert_rows_equal` (floats within 1e-5)."""
    _assert_close(got.to_dict(), want.to_dict(), got.scenario, tol)


def _assert_same_rows(got, want, tol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_rows_equal(g, w, tol)


# ---------------------------------------------------------------------------
# the pure copies, against the reference on the same inputs
# ---------------------------------------------------------------------------

OVERRIDE_CASES = [
    ("", 1),                                  # empty path
    ("sim..routing", "ar"),                   # malformed segment
    ("sim.routng", "ar"),                     # unknown field
    ("faults[9].frac", 0.1),                  # index out of range
    ("sim[0]", 1),                            # index into a dataclass
    ("sim.routing.x", 1),                     # field on a str
    ("topo.n_planes", 2.5),                   # int expected
    ("topo.n_planes", True),                  # bool is not an int
    ("faults[0].frac", "x"),                  # float expected
    ("sim.routing", 3),                       # str expected
    ("faults", 1),                            # tuple expected
    ("sim", 1),                               # dataclass expected
]


@pytest.mark.parametrize("path,value", OVERRIDE_CASES)
def test_override_errors_match_the_reference(path, value):
    name = "allreduce_under_random_failures"
    with pytest.raises(OverridePathError) as got:
        apply_override(get_scenario(name), path, value)
    with pytest.raises(JxOverridePathError) as want:
        jx_apply_override(jx_get(name), path, value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("path,value", [
    ("faults[0].frac", 0.25), ("topo.n_planes", 1), ("sim.routing", "ecmp"),
    ("workloads[0].demand", 1), ("faults", ()), ("sim.slots", 40)])
def test_overrides_and_paths_match_the_reference(path, value):
    name = "allreduce_under_random_failures"
    got = apply_override(get_scenario(name), path, value)
    want = jx_apply_override(jx_get(name), path, value)
    assert canonicalize(got) == jx_canonicalize(want)
    assert spec_key(got) == jx_spec_key(want)
    assert canonicalize(get_path(got, path)) == \
        jx_canonicalize(jx_get_path(want, path))
    for bad in ("faults[3]", "sim.nope"):
        with pytest.raises(OverridePathError) as e1:
            get_path(got, bad)
        with pytest.raises(JxOverridePathError) as e2:
            jx_get_path(want, bad)
        assert str(e1.value) == str(e2.value)


def _grids(ax, prod, zp, ch, get):
    a = ax("sim.routing", ("ar", "ecmp"))
    b = ax("faults[0].frac", (0.05, 0.1, 0.2), labels=(5, 10, 20))
    c = ax("seed", (0, 1, 2))
    s = ax("scenario", (get("fig9_victim_noise"), "fig11_degraded_leaf"))
    return {"product": prod(a, b), "zip": zp(b, c),
            "chain": ch(prod(a, c), zp(b, c)),
            "scenario": prod(s, a, c)}


@pytest.mark.parametrize("kind", ["product", "zip", "chain", "scenario"])
def test_axes_points_match_the_reference(kind):
    got = _grids(Axis, product, zip_axes, chain, get_scenario)[kind]
    want = _grids(JxAxis, jx_product, jx_zip_axes, jx_chain, jx_get)[kind]
    assert got.paths() == want.paths()
    assert canonicalize(got.points()) == jx_canonicalize(want.points())


def test_axes_reject_what_the_reference_rejects():
    for make, err in ((lambda A: A("x", ()), ValueError),
                      (lambda A: A("x", (1, 2), labels=(1,)), ValueError),
                      (lambda A: A("x", (1,), labels=([1],)), ValueError)):
        with pytest.raises(err) as e1:
            make(Axis)
        with pytest.raises(err) as e2:
            make(JxAxis)
        assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError, match="more than once"):
        product(Axis("seed", (0,)), Axis("seed", (1,))).points()
    with pytest.raises(ValueError, match="equal-length"):
        zip_axes(Axis("seed", (0,)), Axis("sim.slots", (1, 2))).points()
    with pytest.raises(TypeError):
        product("seed")


def test_spec_key_matches_the_reference_for_every_scenario():
    assert list_scenarios() == jx_list()
    for name in list_scenarios():
        assert spec_key(get_scenario(name)) == jx_spec_key(jx_get(name)), \
            name
        assert spec_key(get_scenario(name), "salt") == \
            jx_spec_key(jx_get(name), "salt"), name


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_spec_key_matches_the_reference_for_every_point(name):
    assert list_experiments() == jx_list_experiments()
    got, want = get_experiment(name), jx_get_experiment(name)
    assert got.coord_names() == want.coord_names()
    pg, pw = got.points(), want.points()
    assert len(pg) == len(pw)
    for a, b in zip(pg, pw):
        assert a.index == b.index and a.coords == b.coords
        assert spec_key(a.spec) == jx_spec_key(b.spec)
    # the derive hook's identity is the reference's but for the package
    assert got.cache_salt().replace("repro_torch.", "repro.") == \
        want.cache_salt()


def _row(seed):
    """A port row with every column kind populated (NaN tail included)."""
    return ScenarioMetrics(
        scenario="s", seed=seed, routing="ar", nic="spx",
        mean_goodput=0.5 + seed, tenant_mean={"a": 0.25, "b": 1 / 3},
        tenant_p01={"a": 0.125, "b": 0.1}, tenant_p99={"a": 0.5, "b": 0.7},
        isolation_index=0.9, recovery_slots=((10, "kill", 4),
                                             (20, "heal", -1)),
        completion_tail=float("nan"), symmetry_cv=0.01,
        symmetry_uniform=bool(seed % 2), symmetry_outliers=((0, 3),),
        extra={"x": 1.5, "series": [1.0, 2.0]}, hft_transient_drops=2,
        bimodal_frac=0.25, straggler_ranks=(0, 5), blackholed_bytes=0.0,
        reaction_slots=3)


def _rs(cls, rows):
    rs = cls(["sim.routing", "faults[0].frac"])
    for i, m in enumerate(rows):
        rs.append(m, {"sim.routing": "ar", "faults[0].frac": 0.1 * i})
    return rs


def test_metric_fields_match_the_reference():
    from repro.scenarios.runner import METRIC_FIELDS as JX_FIELDS
    assert [(n, k) for n, k, _ in METRIC_FIELDS] == \
        [(n, k) for n, k, _ in JX_FIELDS]
    m = _row(1)
    jm = JxScenarioMetrics.from_dict(m.to_dict())
    for n, _, _ in METRIC_FIELDS:
        a, b = metric_value(m, n), jx_metric_value(jm, n)
        assert canonicalize(a) == jx_canonicalize(b) or (
            isinstance(a, float) and math.isnan(a) and math.isnan(b)), n
    assert json.dumps(ScenarioMetrics.from_dict(jm.to_dict()).to_dict(),
                      sort_keys=True) == json.dumps(m.to_dict(),
                                                    sort_keys=True)
    assert ScenarioMetrics.CSV_FIELDS == JxScenarioMetrics.CSV_FIELDS
    assert ScenarioMetrics.csv_header() == JxScenarioMetrics.csv_header()
    assert m.to_row() == jm.to_row()
    assert m.worst_recovery() == jm.worst_recovery() == 4


@pytest.mark.parametrize("fmt", ["json", "csv"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_resultset_crosses_between_packages(fmt, writer):
    rows = [_row(s) for s in range(3)]
    cls_w, cls_r = (ResultSet, JxResultSet) if writer == "port" else \
        (JxResultSet, ResultSet)
    src = _rs(cls_w, rows if writer == "port" else
              [JxScenarioMetrics.from_dict(m.to_dict()) for m in rows])
    text = src.to_json() if fmt == "json" else src.to_csv()
    back = cls_r.from_json(text) if fmt == "json" else cls_r.from_csv(text)
    assert back.coord_names == src.coord_names
    assert json.dumps([m.to_dict() for m in back.to_metrics()],
                      sort_keys=True) == \
        json.dumps([m.to_dict() for m in src.to_metrics()], sort_keys=True)
    assert back.column("axis.faults[0].frac") == \
        src.column("axis.faults[0].frac")


def test_resultset_backfills_what_the_reference_backfills():
    text = _rs(ResultSet, [_row(0)]).to_json()
    doc = json.loads(text)
    for col in ("blackholed_bytes", "reaction_slots", "straggler_ranks"):
        del doc["columns"][col]
    got = ResultSet.from_json(json.dumps(doc)).to_metrics()[0]
    want = JxResultSet.from_json(json.dumps(doc)).to_metrics()[0]
    assert got.to_dict() == want.to_dict()
    assert got.blackholed_bytes == -1.0 and got.reaction_slots == -1


# ---------------------------------------------------------------------------
# rows against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ROW_EXPERIMENTS)
def test_run_experiment_rows_match_the_reference(name):
    exp = _cut(get_experiment(name))
    rs = run_experiment(exp, device="cpu")
    want = _reference_rows(name)
    assert rs.cache_hits == 0 and rs.cache_misses == len(want)
    got = rs.to_metrics()
    assert len(got) == len(want)
    for row, g, (p, w) in zip(rs.rows(), got, want):
        for path, label in p.coords.items():
            assert row[f"axis.{path}"] == label
        assert g.extra.keys() == w.extra.keys() and g.extra
        _assert_rows_equal(g, w)


def test_dispatch_modes_give_equal_rows():
    exp = _cut(get_experiment("topo_kind_resiliency"), slots=60)
    rows = {}
    for mode in ("megabatch", "group", "serial"):
        rs = run_experiment(exp, device="cpu", dispatch=mode)
        (fl,) = rs.flight["executions"]
        assert fl["mode"] == mode and fl["n_points"] == 12
        assert sorted(p["index"] for p in fl["points"]) == list(range(12))
        rows[mode] = rs.to_metrics()
        loops = fl["dispatch_stats"]["loops"]
        # megabatch: one loop a (topology kind, routing) sub-batch
        assert loops == (4 if mode == "megabatch" else 12)
    # per-flow outputs are bit-equal; a lane's totals may take another
    # reduction tree (1e-12, as in tests/test_torch_batch.py)
    _assert_same_rows(rows["megabatch"], rows["serial"], 1e-12)
    _assert_same_rows(rows["group"], rows["serial"], 1e-12)


def test_megabatch_rows_come_back_in_grid_order_with_a_pipeline():
    """topo_kind_resiliency's grid is kind x routing x frac; megabatch
    finishes it by kind, then routing, so rows arrive out of order."""
    exp = _cut(get_experiment("topo_kind_resiliency"), slots=40)
    seen = []
    fl = {}
    specs = [p.spec for p in exp.points()]
    execute_points(specs, device="cpu", on_result=lambda i, m: seen.append(i),
                   flight=fl)
    assert sorted(seen) == list(range(len(specs)))
    rs = run_experiment(exp, device="cpu")
    assert [r["axis.faults[0].frac"] for r in rs.rows()] == \
        [p.coords["faults[0].frac"] for p in exp.points()]
    assert [(r["scenario"], r["routing"]) for r in rs.rows()] == \
        [(s.name, s.sim.routing) for s in specs]
    pipe = fl["pipeline"]
    assert pipe["groups"] == 2 and pipe["launches"] == 4 and \
        pipe["pipelined"]
    assert len(pipe["loops"]) == 4 and \
        sum(lp["points"] for lp in pipe["loops"]) == len(specs)
    assert fl["walls"]["loop_s"] > 0 and fl["walls"]["prep_s"] > 0
    assert fl["walls"]["overlap_s"] == 0.0           # the CPU loop is eager
    assert fl["dispatch_stats"] == {"loops": 4, "graphs": 0}
    assert fl["device"] == "cpu" and fl["dtype"] == "torch.float64"


def test_train_comms_resiliency_raises_not_implemented():
    """The schedule study, which raised until the port had schedule
    workloads, now runs: its rows equal the reference's (JAX engine
    under x64 and its derive hook, at the registry's sizes: a schedule
    does not fit in fewer slots) and carry the study's signature."""
    rs = run_experiment(get_experiment("train_comms_resiliency"),
                        device="cpu")
    want = _reference_rows("train_comms_resiliency", slots=None)
    got = rs.to_metrics()
    assert len(got) == len(want) == 3
    for g, (p, w) in zip(got, want):
        assert g.extra.keys() == w.extra.keys() and g.extra
        _assert_rows_equal(g, w)
    for g in got[1:]:
        assert g.extra["step_inflation"] >= 1.2
        assert g.extra["last_step_ratio"] <= 1.1


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = _cut(get_experiment("fig9_isolation"), slots=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment(exp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        execute_points([p.spec for p in exp.points()])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep("fig9_victim_noise", SweepGrid(slots=8))
    with pytest.raises(ValueError, match="unknown dispatch"):
        execute_points([], device="cpu", dispatch="pool")


# ---------------------------------------------------------------------------
# the run cache
# ---------------------------------------------------------------------------

class _Interrupt(Exception):
    pass


class _DyingCache(RunCache):
    """A cache whose process dies after `n` rows were written."""

    def __init__(self, root, n):
        super().__init__(root)
        self.n = n

    def put(self, key, spec, metrics):
        if self.n == 0:
            raise _Interrupt
        self.n -= 1
        super().put(key, spec, metrics)


def test_cache_hits_misses_corruption_and_resume(tmp_path):
    exp = _cut(get_experiment("fig9_isolation"), slots=30)
    d = str(tmp_path / "cache")
    with pytest.raises(_Interrupt):
        run_experiment(exp, device="cpu", cache=_DyingCache(d, 2))
    assert len(RunCache(d)) == 2
    engine.reset_dispatch_stats()
    first = run_experiment(exp, device="cpu", cache=d)
    assert (first.cache_hits, first.cache_misses) == (2, 2)
    engine.reset_dispatch_stats()
    again = run_experiment(exp, device="cpu", cache=d)
    assert (again.cache_hits, again.cache_misses) == (4, 0)
    assert engine.dispatch_stats()["loops"] == 0
    assert again.flight["executions"] == []
    assert again.to_json() != "" and json.dumps(
        [m.to_dict() for m in again.to_metrics()], sort_keys=True) == \
        json.dumps([m.to_dict() for m in first.to_metrics()],
                   sort_keys=True)
    # a corrupt entry costs one re-run, never a crash or a wrong row
    salt = engine_salt(torch.device("cpu"), torch.float64) + \
        exp.cache_salt()
    victim = exp.points()[1]
    with open(RunCache(d).path_for(spec_key(victim.spec, salt)), "w") as f:
        f.write("{not json")
    engine.reset_dispatch_stats()
    fixed = run_experiment(exp, device="cpu", cache=d)
    assert (fixed.cache_hits, fixed.cache_misses) == (3, 1)
    assert engine.dispatch_stats()["loops"] == 1
    _assert_same_rows(fixed.to_metrics(), first.to_metrics())
    # float32 rows are keyed apart from float64 rows
    f32 = run_experiment(exp, device="cpu", dtype=torch.float32, cache=d)
    assert (f32.cache_hits, f32.cache_misses) == (0, 4)
    assert len(RunCache(d)) == 8
    f32 = run_experiment(exp, device="cpu", dtype=torch.float32, cache=d)
    assert (f32.cache_hits, f32.cache_misses) == (4, 0)


def test_cache_never_serves_a_reference_entry(tmp_path):
    d = str(tmp_path / "cache")
    name = "resiliency_fault_planes"
    ref = _cut(jx_get_experiment(name), jx_get, 30)
    jx_run_experiment(ref, processes=1, cache=d)
    assert len(RunCache(d)) == 6
    exp = _cut(get_experiment(name), slots=30)
    for p, q in zip(exp.points(), ref.points()):
        assert spec_key(p.spec) == jx_spec_key(q.spec)
        assert RunCache(d).get(jx_spec_key(q.spec, ref.cache_salt())) \
            is not None
    rs = run_experiment(exp, device="cpu", cache=d)
    assert (rs.cache_hits, rs.cache_misses) == (0, 6)
    assert len(JxRunCache(d)) == 12


# ---------------------------------------------------------------------------
# the float32 overflow guard
# ---------------------------------------------------------------------------

def test_f32_bytes_overflow_warns_and_is_logged_once():
    spec = dataclasses.replace(
        apply_override(get_scenario("fig9_victim_noise").with_sim(slots=6),
                       "workloads[0].bytes_total", 3e7),
        name="f32_overflow_probe")
    fl = {}
    with pytest.warns(UserWarning, match="2\\^24"):
        execute_points([spec], device="cpu", dtype=torch.float32,
                       flight=fl)
    assert fl["f32_overflows"] == [{"spec": "f32_overflow_probe",
                                    "max_bytes": 3e7}]
    fl = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        execute_points([spec], device="cpu", dtype=torch.float64,
                       flight=fl)
    assert fl["f32_overflows"] == []
    # a second float32 run logs again, but warns no more for this spec
    fl = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        execute_points([spec], device="cpu", dtype=torch.float32,
                       flight=fl)
    assert len(fl["f32_overflows"]) == 1


# ---------------------------------------------------------------------------
# the deprecated sweep shims
# ---------------------------------------------------------------------------

GRID_ARGS = dict(seeds=(0, 1), routings=("ar", "ecmp"), nics=("spx",),
                 slots=40)


def test_sweep_grid_points_match_the_reference():
    for kw in (GRID_ARGS, {}, dict(nics=("dcqcn", "esr"))):
        got = SweepGrid(**kw).points(get_scenario("fig11_degraded_leaf"))
        want = JxSweepGrid(**kw).points(jx_get("fig11_degraded_leaf"))
        assert [spec_key(s) for s in got] == [jx_spec_key(s) for s in want]
    for kw in (dict(routings=()), dict(nics=("rdma",)),
               dict(routings=("ospf",))):
        with pytest.raises(ValueError) as e1:
            SweepGrid(**kw).points(get_scenario("fig11_degraded_leaf"))
        with pytest.raises(ValueError) as e2:
            JxSweepGrid(**kw).points(jx_get("fig11_degraded_leaf"))
        assert str(e1.value) == str(e2.value)


def test_sweep_and_metrics_csv_match_the_reference():
    grid = SweepGrid(**GRID_ARGS)
    got = sweep("fig11_degraded_leaf", grid, device="cpu")
    want = jx_sweep("fig11_degraded_leaf", JxSweepGrid(**GRID_ARGS),
                    processes=1, backend="numpy")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_rows_equal(g, w)
    # the flat CSV formats the same rows the same way
    assert metrics_csv(got) == jx_metrics_csv(
        [JxScenarioMetrics.from_dict(m.to_dict()) for m in got])
    assert metrics_csv(got).splitlines()[0] == \
        jx_metrics_csv(want).splitlines()[0]


def test_sweep_many_matches_the_reference():
    names = ("fig9_victim_noise", "fig12_plane_flap")
    grid = SweepGrid(seeds=(0, 1), slots=40)
    got = sweep_many(names, grid, device="cpu")
    want = jx_sweep_many(names, JxSweepGrid(seeds=(0, 1), slots=40),
                         processes=1, backend="numpy")
    assert [m.scenario for m in got] == [m.scenario for m in want] == \
        ["fig9_victim_noise"] * 2 + ["fig12_plane_flap"] * 2
    for g, w in zip(got, want):
        _assert_rows_equal(g, w)
