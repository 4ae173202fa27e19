"""The PyTorch port's host preparation, held to the JAX package's by array
equality.

The port keeps its own copies of the scenario schema and registry, the
scenario compiler, the fault-timeline compiler, the ECMP assignment
replay and the slot engine's operand builders.  For every leaf-spine
AR/WAR/ECMP registry scenario without failure reaction (among them the
giga-scale point under its own ECMP and the three training-step
schedules), the giga point under AR and three registry scenarios under
ECMP, the copies must produce exactly the reference's flows, tenants,
fault transitions, `FlowArrays`, demand timelines, capacity timelines,
segment maps, ECMP assignment segments and aggregation plans (each
package's config in its own aggregation mode; the dense gather plans
with dense forced in both, and the sparse CSR plans against the
reference's `segment_load` keys) — so both engines start every run from
the same operands.  The copies of the §5 telemetry analyses and the
trace summary and exporters must give the reference's results on the
same traces.  The last tests pin the import boundary (the port imports
neither `jax` nor `repro`) and that the schedule scenarios, the last
registry entries to arrive, compile as the reference compiles them.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.netsim.fabric import FlowArrays as JxFlowArrays
from repro.netsim.jx import engine as jx_engine
from repro.netsim.jx.events import compile_fault_timeline as jx_timeline
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import get_scenario as jx_get
from repro.scenarios import list_scenarios as jx_list
from repro_torch.netsim import engine
from repro_torch.netsim.carry import operands_from_numpy
from repro_torch.netsim.events import compile_fault_timeline
from repro_torch.netsim.fabric import FlowArrays
from repro_torch.scenarios import compile_scenario, get_scenario, \
    list_scenarios
from repro_torch.trace import TraceSpec

ROOT = Path(__file__).resolve().parents[1]


def _in_slice(name: str) -> bool:
    s = jx_get(name)
    return (s.topo.kind == "leaf_spine"
            and s.sim.routing in ("ar", "war", "ecmp")
            and s.reaction is None)


SLICE = sorted(n for n in jx_list() if _in_slice(n))
GIGA_AR = "giga_fabric_storage[ar]"
# registry scenarios under ECMP: a link-kill set from slot 0, an access
# kill mid-run (a segment without re-hash draws) and a spine cascade
# (re-hash draws at every kill)
ECMP = ["fig11_degraded_leaf[ecmp]", "fig12_plane_flap[ecmp]",
        "cascading_spine_loss[ecmp]"]


def _pair(name):
    """(reference spec, port spec) for a slice scenario name; a
    `name[routing]` suffix overrides the scenario's routing."""
    if name.endswith("]"):
        base, routing = name[:-1].split("[")
        return (jx_get(base).with_sim(routing=routing),
                get_scenario(base).with_sim(routing=routing))
    return jx_get(name), get_scenario(name)


def _flow_rows(flows):
    return [(f.src, f.dst, f.demand, f.bytes_total, f.group, f.start_slot,
             f.phase) for f in flows]


def test_slice_covers_the_leaf_spine_ar_war_registry():
    assert len(SLICE) == 21
    assert {"fig9_victim_noise", "fig11_degraded_leaf",
            "fig12_plane_flap", "giga_fabric_storage",
            "train_step_baseline", "train_step_flap",
            "train_step_flap_moe"} <= set(SLICE)


def test_registry_specs_equal_the_reference():
    assert list_scenarios() == jx_list()
    for name in jx_list():
        assert dataclasses.asdict(get_scenario(name)) == \
            dataclasses.asdict(jx_get(name)), name


@pytest.mark.parametrize("name", SLICE + [GIGA_AR] + ECMP)
def test_host_prep_equals_reference(name):
    ref_spec, spec = _pair(name)
    rc, c = jx_compile(ref_spec), compile_scenario(spec)
    assert _flow_rows(c.flows) == _flow_rows(rc.flows)
    assert c.tenants == rc.tenants
    assert c.fault_slots == rc.fault_slots
    assert (c.phase_mult is None) == (rc.phase_mult is None)
    if rc.phase_mult is not None:
        np.testing.assert_array_equal(c.phase_mult, rc.phase_mult)
        assert [dataclasses.asdict(x) for x in c.schedules] == \
            [dataclasses.asdict(x) for x in rc.schedules]

    rfa = JxFlowArrays.build(rc.flows, rc.topo)
    fa = FlowArrays.build(c.flows, c.topo)
    for field in ("src", "dst", "src_leaf", "dst_leaf", "demand",
                  "bytes_total", "group", "start_slot", "phase"):
        np.testing.assert_array_equal(getattr(fa, field),
                                      getattr(rfa, field), err_msg=field)
    assert fa.groups == rfa.groups

    rtl, tl = jx_timeline(ref_spec), compile_fault_timeline(spec)
    for field in ("up", "down", "access"):
        np.testing.assert_array_equal(getattr(tl, field),
                                      getattr(rtl, field), err_msg=field)
    assert tl.up2 is None and rtl.up2 is None
    boundaries = tuple(tl.change_slots())
    assert boundaries == tuple(rtl.change_slots())
    slots = spec.sim.slots
    np.testing.assert_array_equal(engine._seg_id(boundaries, slots),
                                  jx_engine._seg_id(boundaries, slots))
    for got, want in zip(engine._seg_caps(tl, boundaries),
                         jx_engine._seg_caps(rtl, boundaries)):
        np.testing.assert_array_equal(got, want)

    # each package picks its aggregation mode itself (sparse at giga)
    rcfg = jx_engine.JxConfig.from_sim(rc.cfg, ref_spec.topo)
    cfg = engine.EngineConfig.from_sim(c.cfg, spec.topo)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
    assert cfg.agg_mode == ("sparse" if spec.topo.n_hosts >= 4096
                            else "dense")
    sparse = dataclasses.replace(cfg, agg_mode="sparse")
    # the dense gather plans, with dense aggregation forced in both
    rcfg = dataclasses.replace(rcfg, agg_mode="dense")
    cfg = dataclasses.replace(cfg, agg_mode="dense")
    rsegs = jx_engine._assign_for(rcfg, rfa, rtl, rc.cfg.seed, boundaries)
    segs = engine._assign_for(cfg, fa, tl, c.cfg.seed, boundaries)
    assert segs.dtype == np.int32
    np.testing.assert_array_equal(segs, rsegs)
    widths = engine._agg_widths(cfg, fa, segs)
    assert widths == jx_engine._agg_widths(rcfg, rfa, rsegs)
    raggs = jx_engine._aggs_for(rcfg, rfa, rsegs, widths)
    aggs = engine._aggs_for(cfg, fa, segs, widths)
    for field in ("src", "dst", "pair", "ecmp_load"):
        got, want = getattr(aggs, field), getattr(raggs, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)

    # the sparse CSR plans: each bucket of the reference's segment_load
    # keys lists its flows in flow order
    plans = engine._sparse_plans(sparse, fa, segs, len(fa), 1)
    P, L, S = cfg.n_planes, cfg.n_leaves, cfg.n_spines
    pk = np.arange(P)[None, :]
    _assert_lists_keys(plans.src, [fa.src[:, None] * P + pk], cfg.n_hosts * P)
    _assert_lists_keys(plans.dst, [fa.dst[:, None] * P + pk], cfg.n_hosts * P)
    if cfg.routing == "ecmp":
        assert plans.pair is None
        assert plans.link.offsets.shape[0] == segs.shape[0]
        for g, a in enumerate(segs):
            k_up = pk * (L * S) + fa.src_leaf[:, None] * S + a
            k_dn = pk * (S * L) + a * L + fa.dst_leaf[:, None]
            _assert_lists_keys(
                engine.SegmentPlan(plans.link.offsets[g],
                                   plans.link.entries[g]),
                [k_up, P * L * S + k_dn], 2 * P * L * S)
    else:
        assert plans.link is None
        _assert_lists_keys(
            plans.pair, [pk * (L * L) + (fa.src_leaf * L + fa.dst_leaf)[:, None]],
            P * L * L)


def _assert_lists_keys(plan, keys, n_buckets):
    """`plan` (one chunk) lists, bucket by bucket, the flat (flow, plane)
    entries of the row-major (F, P) `keys` arrays (families that share
    no bucket) in flow order."""
    flat = np.concatenate([k.ravel() for k in keys])
    idx = np.concatenate([np.arange(k.size) for k in keys])
    order = np.argsort(flat, kind="stable")
    assert plan.entries.dtype == plan.offsets.dtype == np.int32
    np.testing.assert_array_equal(plan.entries, idx[order])
    np.testing.assert_array_equal(plan.offsets, np.concatenate(
        [[0], np.cumsum(np.bincount(flat, minlength=n_buckets))]))


def test_operands_carry_the_numpy_arrays():
    c = compile_scenario(get_scenario("fig11_degraded_leaf"))
    cfg, fa, ops = engine.prepare(c, "cpu", torch.float64)
    tl = compile_fault_timeline(c.spec)
    b = list(tl.change_slots())
    np.testing.assert_array_equal(ops.up.numpy(), tl.up[b] * cfg.uplink_cap)
    np.testing.assert_array_equal(
        ops.acc.numpy(), np.swapaxes(tl.access[b], 1, 2) * cfg.access_cap)
    np.testing.assert_array_equal(ops.fb.src.numpy(), fa.src)
    np.testing.assert_array_equal(ops.pair_idx.numpy(),
                                  fa.src_leaf * cfg.n_leaves + fa.dst_leaf)
    assert ops.agg_pair.dtype == torch.int64
    assert all(t.is_contiguous() for t in (ops.up, ops.down, ops.acc))
    assign = engine._assign_for(cfg, fa, tl, c.cfg.seed, b)
    f32 = operands_from_numpy(cfg, fa, engine._aggs_for(
        cfg, fa, assign, engine._agg_widths(cfg, fa, assign)), tl.up[b],
        tl.down[b], tl.access[b], engine._seg_id(b, cfg.slots),
        device="cpu", dtype=torch.float32)
    assert f32.up.dtype == f32.fb.demand.dtype == torch.float32
    # AR/WAR carry the reference's inert ECMP placeholders
    assert f32.assign.shape == (1, len(fa), cfg.n_planes)
    assert f32.ecmp_load.shape == (1, cfg.n_planes, 1, 1)
    assert bool((f32.ecmp_load == len(fa)).all())


def test_ecmp_operands_index_the_reference_layout():
    """The ECMP operands: int32 assignment and plans, the stacked link
    capacities in the plans' row order, and each flow's up/down link as
    a flat index."""
    c = compile_scenario(get_scenario("cascading_spine_loss")
                         .with_sim(routing="ecmp"))
    cfg, fa, ops = engine.prepare(c, "cpu", torch.float64)
    P, L, S = cfg.n_planes, cfg.n_leaves, cfg.n_spines
    assert ops.assign.dtype == ops.ecmp_load.dtype == torch.int32
    n_seg = ops.assign.shape[0]
    assert n_seg == len(compile_fault_timeline(c.spec).change_slots()) == 4
    assert ops.ecmp_load.shape[:3] == (n_seg, P, 2 * L * S)
    np.testing.assert_array_equal(
        ops.link_cap.numpy(),
        np.concatenate([ops.up.reshape(n_seg, P, -1).numpy(),
                        ops.down.reshape(n_seg, P, -1).numpy()], -1))
    a = ops.assign.long()
    p = torch.arange(P)[None, None, :]
    src, dst = ops.fb.src_leaf[None, :, None], ops.fb.dst_leaf[None, :, None]
    assert torch.equal(ops.ecmp_up, (p * L + src) * S + a)
    assert torch.equal(ops.ecmp_down, (p * S + a) * L + dst)
    with pytest.raises(ValueError, match="assignment"):
        operands_from_numpy(cfg, fa, engine._aggs_for(
            cfg, fa, a.numpy(), engine._agg_widths(cfg, fa, a.numpy())),
            np.ones((1, P, L, S)), np.ones((1, P, S, L)),
            np.ones((1, P, cfg.n_hosts)), np.zeros(cfg.slots, np.int32),
            device="cpu", dtype=torch.float64)


# ---------------------------------------------------------------------------
# import boundary and scope
# ---------------------------------------------------------------------------

def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    banned = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        banned += [n for n in names
                   if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not banned, f"{path} imports {banned}"


@pytest.mark.parametrize("name,stage", [
    ("train_step_baseline", "compile"),      # schedule workload
    ("train_step_flap", "compile"),
    ("train_step_flap_moe", "compile"),
])
def test_later_slices_raise_not_implemented(name, stage):
    """The schedule scenarios, once left to a later slice, now compile
    as the reference compiles them: the same flows, demand timeline,
    `TrainSchedule`s and segment starts (capacity and phase changes)."""
    ref_spec, spec = _pair(name)
    assert stage == "compile"
    rc, c = jx_compile(ref_spec), compile_scenario(spec)
    assert _flow_rows(c.flows) == _flow_rows(rc.flows)
    np.testing.assert_array_equal(c.phase_mult, rc.phase_mult)
    assert [dataclasses.asdict(x) for x in c.schedules] == \
        [dataclasses.asdict(x) for x in rc.schedules]
    assert len(c.schedules) == 1
    lane = engine._lane(c)
    rcfg, _, rtl, rpm, _ = jx_engine._prepared(rc)
    assert lane.cfg.n_phases == rcfg.n_phases == rc.phase_mult.shape[1]
    assert lane.boundaries == tuple(sorted(
        set(rtl.change_slots()) | set(jx_engine.phase_boundaries(rpm))))
    np.testing.assert_array_equal(
        engine._seg_dem(c.phase_mult, lane.boundaries),
        jx_engine._seg_dem(rpm, lane.boundaries))


def test_ecmp_replay_raises_outside_the_slice():
    """The ECMP assignment replay equals the reference's draw for draw:
    on a leaf-spine spine cascade (re-hash draws at each kill), on a fat
    tree (path capacity through the agg map and the pod-core hops), and
    under failure reaction with the lagged visible timeline in each mode
    (`backup`: the fast-reroute walk, `rehash`: the seeded re-hash,
    `instant`: no lag)."""
    from repro.netsim.jx.events import ecmp_assign_segments as jx_assign
    from repro.netsim.jx.events import lagged_timeline as jx_lagged
    from repro.netsim.topology import backup_path_table as jx_backup
    from repro_torch.netsim.events import ecmp_assign_segments, \
        lagged_timeline
    from repro_torch.netsim.topology import backup_path_table
    spec = get_scenario("cascading_spine_loss").with_sim(routing="ecmp")
    tl = compile_fault_timeline(spec)
    fa = FlowArrays.build(compile_scenario(spec).flows, spec.topo)
    b = tl.change_slots()
    args = (fa.src_leaf, fa.dst_leaf, tl, 5, spec.topo.n_spines, b)
    np.testing.assert_array_equal(ecmp_assign_segments(*args),
                                  jx_assign(*args))
    for name, seed in (("ft_core_failure_resiliency", 3),
                       ("reroute_random_failures_ft", 15),
                       ("reroute_random_failures", 15)):
        s = get_scenario(name)
        t = s.topo
        ftl = compile_fault_timeline(s)
        ffa = FlowArrays.build(compile_scenario(s).flows, t)
        cpa = t.n_cores // t.n_aggs if t.kind == "fat_tree" else 1
        kw = dict(uplink_cap=t.uplink_cap, core_cap=t.core_cap,
                  cores_per_agg=cpa, leaves_per_pod=t.leaves_per_pod)
        for mode, lag in (("instant", 0), ("backup", 2), ("rehash", 7)):
            vtl = lagged_timeline(ftl, lag) if lag else None
            rvtl = jx_lagged(ftl, lag) if lag else None
            bounds = sorted(set(ftl.change_slots())
                            | set(vtl.change_slots() if lag else ()))
            got = ecmp_assign_segments(
                ffa.src_leaf, ffa.dst_leaf, ftl, seed, t.n_paths, bounds,
                vis_timeline=vtl, mode=mode,
                backup=backup_path_table(t.kind, t.n_paths, cpa), **kw)
            want = jx_assign(
                ffa.src_leaf, ffa.dst_leaf, ftl, seed, t.n_paths, bounds,
                vis_timeline=rvtl, mode=mode,
                backup=jx_backup(t.kind, t.n_paths, cpa), **kw)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=(name, mode))
            assert len(got) == len(bounds) > 1


def test_poisson_flap_and_trace_raise_not_implemented():
    """A `poisson_flap` fault now lowers to the reference's timeline and
    transition slots (with or without a reaction), and a trace spec no
    longer raises: the run records it (its values are held to the
    reference in `test_torch_trace.py`)."""
    from repro.scenarios.compile import poisson_flap_schedule as jx_sched
    from repro_torch.scenarios.compile import poisson_flap_schedule
    for reaction in (None, get_scenario("poisson_flap_storm").reaction):
        spec = dataclasses.replace(get_scenario("poisson_flap_storm"),
                                   reaction=reaction).with_sim(routing="ar")
        ref_spec = dataclasses.replace(jx_get("poisson_flap_storm"),
                                       reaction=reaction) \
            .with_sim(routing="ar")
        c = compile_scenario(spec)
        assert c.fault_slots == jx_compile(ref_spec).fault_slots
        assert poisson_flap_schedule(spec, 0) == jx_sched(ref_spec, 0)
        tl, rtl = compile_fault_timeline(spec), jx_timeline(ref_spec)
        for field in ("up", "down", "access"):
            np.testing.assert_array_equal(getattr(tl, field),
                                          getattr(rtl, field))
    traced = get_scenario("fig12_plane_flap").with_sim(
        slots=4, trace=TraceSpec(enabled=True, every=3))
    res = compile_scenario(traced).run(device="cpu")
    assert set(res.trace) == {"slot", "host_bw", "util", "queue", "ecn",
                              "eligible"}
    np.testing.assert_array_equal(res.trace["slot"], [0, 3])


# ---------------------------------------------------------------------------
# §5 analyses and trace exporters
# ---------------------------------------------------------------------------

def _traces(seed: int):
    """Random traces in the reference's layout: a few hosts, planes and
    flows, goodput near line rate, idle and in between."""
    rng = np.random.default_rng(seed)
    T, H, P, L, U, F = 40, 6, 3, 2, 2, 7
    hb = rng.choice([0.0, 0.5, 1.0], (T, H, P)) * rng.uniform(
        0.9, 1.0, (T, H, P))
    hb[:, 0] = rng.uniform(0.3, 0.7, (T, P))           # a straggler
    hb[:, 1, 0] = 0.0                                   # an idle port
    return {"slot": np.arange(0, 3 * T, 3), "host_bw": hb,
            "util": rng.uniform(0, 1.2, (T, P, L, U)),
            "queue": rng.uniform(0, 4, (T, P, L, U)),
            "ecn": rng.uniform(0, 1, (T, F, P)) * (rng.random((T, F, P))
                                                  < 0.3),
            "eligible": rng.random((T, F, P)) < 0.9}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_telemetry_and_trace_summary_equal_the_reference(seed):
    """`core.telemetry` and `trace.trace_summary` are copies: the same
    histograms, classes, stragglers and summary columns as the
    reference's on the same traces (every class reached across the
    histograms, edge windows of 1-20 bins)."""
    from repro.core import telemetry as jx_tel
    from repro.trace import trace_summary as jx_summary
    from repro_torch.core import telemetry
    from repro_torch.trace import trace_summary
    tr = _traces(seed)
    rng = np.random.default_rng(seed + 10)
    classes = set()
    for nbins in (1, 2, 5, 20):
        for _ in range(30):
            x = rng.choice([rng.uniform(0, 1, 50), rng.uniform(0.4, 0.6, 50),
                            rng.choice([0.0, 1.0], 50), np.ones(50),
                            np.zeros(50)])
            h = telemetry.bw_histogram(x, nbins)
            np.testing.assert_array_equal(h, jx_tel.bw_histogram(x, nbins))
            got = telemetry.classify_histogram(h)
            assert got == jx_tel.classify_histogram(h)
            classes.add(got)
    assert classes == {"idle", "line-rate", "healthy-blocked", "straggler"}
    host = tr["host_bw"].sum(2).T
    assert telemetry.find_stragglers(host) == jx_tel.find_stragglers(host)
    for args in ((tr, 1.0, 3), (tr, 2.0, 3), ({}, 1.0, 3), (None, 1.0, 3),
                 ({"host_bw": tr["host_bw"][:1]}, 1.0, 3)):
        got, want = trace_summary(*args), jx_summary(*args)
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], float) and np.isnan(want[k]):
                assert np.isnan(got[k]), k
            else:
                assert got[k] == want[k], k


def test_trace_exporters_equal_the_reference(tmp_path):
    """`trace_to_npz` and `trace_to_perfetto` write what the reference's
    write for the same trace: the same arrays, the same JSON document."""
    import json
    from repro.trace import trace_to_npz as jx_npz
    from repro.trace import trace_to_perfetto as jx_perfetto
    from repro_torch.trace import trace_to_npz, trace_to_perfetto
    tr = _traces(3)
    for fn, ref_fn, ext in ((trace_to_npz, jx_npz, "npz"),
                            (trace_to_perfetto, jx_perfetto, "json")):
        fn(str(tmp_path / f"port.{ext}"), tr, slot_us=2.5, label="x")
        ref_fn(str(tmp_path / f"ref.{ext}"), tr, slot_us=2.5, label="x")
    got, want = (np.load(str(tmp_path / f"{k}.npz")) for k in ("port", "ref"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())


def test_trace_spec_equals_the_reference():
    """The port's `TraceSpec` validates, orders its fields and lists its
    recorded slots as the reference's does, and the module constants
    are the reference's."""
    from repro import trace as jx_trace
    from repro_torch import trace
    assert trace.TRACE_FIELDS == jx_trace.TRACE_FIELDS
    assert trace.FLOW_AXIS_FIELDS == jx_trace.FLOW_AXIS_FIELDS
    assert trace.ACTIVE_PORT_THRESH == jx_trace.ACTIVE_PORT_THRESH
    for kw in (dict(), dict(every=7, fields=("queue", "host_bw")),
               dict(enabled=True, every=3)):
        got, want = trace.TraceSpec(**kw), jx_trace.TraceSpec(**kw)
        assert got.active_fields() == want.active_fields()
        for n in (0, 1, 7, 137, 600):
            np.testing.assert_array_equal(got.recorded_slots(n),
                                          want.recorded_slots(n))
    for kw in (dict(enabled=True, every=0), dict(fields=("host_bw", "x")),
               dict(enabled=True, fields=())):
        with pytest.raises(ValueError):
            jx_trace.TraceSpec(**kw).validate()
        with pytest.raises(ValueError):
            trace.TraceSpec(**kw).validate()
