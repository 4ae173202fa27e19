"""The PyTorch port's batched and megabatch paths, held to its own single
points and to the JAX package's batched paths.

`engine.run_compiled_batch` runs points of one structure as one slot
loop over a lane axis, on the union of their capacity segments;
`megabatch.run_megabatch` groups a grid by structure and pow2 flow
bucket and runs one such loop per (routing, NIC) sub-batch, its lanes
padded with inert flows.  On the CPU, every lane must equal the same
point run alone through the port: `mean_goodput`, `completion_slot`,
`util_up_last` and the trace bit for bit, and the per-slot series
within 1e-12 relative (one sum of the lane's flows a slot, whose
reduction tree may change with the batch's shape); and every lane must
stay within `_assert_parity` of the reference's `run_compiled_batch` or
`run_megabatch` (under `jax.enable_x64(True)`).  The lanes here differ
in seed and in fault timeline (so their segments differ, failure
reaction's lagged ones included), and the megabatch grid mixes
routing × NIC, two flow buckets and traced points.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.netsim.jx import megabatch as jx_megabatch
from repro.netsim.jx.engine import run_compiled_batch as jx_run_batch
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import get_scenario as jx_get
from repro.trace import TraceSpec as JxTraceSpec
from repro_torch.netsim import engine, megabatch
from repro_torch.scenarios import compile_scenario, get_scenario
from repro_torch.trace import FLOW_AXIS_FIELDS, TraceSpec

from test_torch_engine import _assert_parity, _split
from test_torch_trace import _assert_traces_close

SERIES_RTOL = 1e-12


def _spec(get, name, fault_start=None, **sim):
    """A registry spec (`name[routing]`), its first fault moved to
    `fault_start`."""
    base, routing = _split(name)
    spec = get(base).with_sim(**dict(sim, **routing))
    if fault_start is not None:
        f0 = dataclasses.replace(spec.faults[0], start_slot=fault_start)
        spec = dataclasses.replace(spec, faults=(f0,) + spec.faults[1:])
    return spec


def _pair(name, fault_start=None, trace=False, **sim):
    """(reference spec, port spec) of one grid point."""
    rt = dict(trace=JxTraceSpec(enabled=True, every=2)) if trace else {}
    pt = dict(trace=TraceSpec(enabled=True, every=2)) if trace else {}
    return (_spec(jx_get, name, fault_start, **sim, **rt),
            _spec(get_scenario, name, fault_start, **sim, **pt))


def assert_lane_equals_single(got, want):
    """A batch lane against the same point run alone: per-flow outputs,
    the last utilization and the trace bit for bit, the series within
    `SERIES_RTOL`."""
    for f in ("mean_goodput", "completion_slot", "util_up_last",
              "group_of"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.groups == want.groups
    np.testing.assert_allclose(got.total_goodput, want.total_goodput,
                               rtol=SERIES_RTOL, atol=0)
    if want.blackhole_timeline is None:
        assert got.blackhole_timeline is None
    else:
        np.testing.assert_allclose(got.blackhole_timeline,
                                   want.blackhole_timeline,
                                   rtol=SERIES_RTOL, atol=1e-300)
    if want.trace is None:
        assert got.trace is None
    else:
        assert list(got.trace) == list(want.trace)
        for k in want.trace:
            assert got.trace[k].dtype == want.trace[k].dtype, k
            np.testing.assert_array_equal(got.trace[k], want.trace[k], k)


# (scenario, lanes as (fault start, sim overrides), slots): seeds that
# hash ECMP differently, fault timelines that start at other slots
BATCHES = {
    "fig11_ecmp_seeds": ("fig11_degraded_leaf[ecmp]",
                         [(None, dict(seed=s)) for s in range(4)], 60),
    "reaction_timelines": ("reroute_random_failures",
                           [(40, dict(seed=0)), (70, dict(seed=1)),
                            (100, dict(seed=2))], 130),
    "fat_tree_timelines": ("ft_core_failure_resiliency",
                           [(30, {}), (60, {}), (61, {})], 90),
    "fig12_traced": ("fig12_plane_flap",
                     [(20, {}), (50, {}), (77, {})], 110),
    "cascade_ecmp_dcqcn": ("cascading_spine_loss[ecmp]",
                           [(None, dict(seed=3, nic="dcqcn")),
                            (150, dict(seed=4, nic="dcqcn"))], 200),
    "fat_tree_ecmp_reaction": ("reroute_random_failures_ft",
                               [(40, dict(seed=0)), (90, dict(seed=5))],
                               120),
    "fat_tree_ecmp_seeds": ("ft_cross_pod_all2all[ecmp]",
                            [(None, dict(seed=s)) for s in range(3)], 40),
}


def _batch(key):
    name, lanes, slots = BATCHES[key]
    trace = key.endswith("traced")
    return [_pair(name, start, trace=trace, slots=slots, **sim)
            for start, sim in lanes]


@pytest.mark.parametrize("key", list(BATCHES))
def test_batched_lanes_equal_single_runs(key):
    """Each lane of `run_compiled_batch` equals its point run alone."""
    points = [compile_scenario(p) for _, p in _batch(key)]
    got = engine.run_compiled_batch(points, device="cpu")
    assert len(got) == len(points)
    for c, g in zip(points, got):
        assert_lane_equals_single(g, c.run(device="cpu"))


@pytest.mark.parametrize("key", ["reaction_timelines", "fig12_traced",
                                 "fat_tree_timelines"])
def test_batched_lanes_match_the_reference_batch(key):
    """Each lane within `_assert_parity` of the reference's
    `run_compiled_batch` on the same points (and its trace within
    1e-5)."""
    pairs = _batch(key)
    points = [compile_scenario(p) for _, p in pairs]
    got = engine.run_compiled_batch(points, device="cpu")
    with jax.enable_x64(True):
        rc = [jx_compile(r) for r, _ in pairs]
        want = jx_run_batch([jx_compile(r) for r, _ in pairs])
    for (r, p), c, g, rcc, w in zip(pairs, points, got, rc, want):
        _assert_parity((p, c, g), (r, rcc, w))
        if w.trace is not None:
            _assert_traces_close(g.trace, w.trace)


def test_batch_of_one_equals_the_single_point():
    """A batch of one point takes the single point's operations: every
    output bit-equal, series included."""
    spec = _spec(get_scenario, "cascading_spine_loss[ecmp]", slots=200,
                 trace=TraceSpec(enabled=True, every=3))
    c = compile_scenario(spec)
    [got] = engine.run_compiled_batch([c], device="cpu")
    want = c.run(device="cpu")
    for f in ("mean_goodput", "completion_slot", "total_goodput",
              "util_up_last"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    for k in want.trace:
        np.testing.assert_array_equal(got.trace[k], want.trace[k], k)


def test_union_segments_keep_each_lanes_snapshots():
    """On the union of the lanes' segment starts, each lane's capacity,
    visible-capacity and ECMP snapshots are those of its own segment
    holding that slot (the reaction's lagged segments included)."""
    pairs = _batch("reaction_timelines")
    points = [compile_scenario(p) for _, p in pairs]
    lanes = [engine._lane(c) for c in points]
    union = tuple(sorted(set().union(*(ln.boundaries for ln in lanes))))
    assert len(union) > max(len(ln.boundaries) for ln in lanes)
    widths = tuple(map(max, zip(*(ln.widths for ln in lanes))))
    for c, ln in zip(points, lanes):
        own = engine.prepare(c, "cpu", torch.float64)[2]
        ops = engine._lane_operands(ln, union, widths, "cpu", torch.float64)
        for t in range(c.cfg.slots):
            g, o = int(ops.seg_id[t]), int(own.seg_id[t])
            for f in ("up", "down", "acc", "vup", "vdown", "link_cap",
                      "ecmp_up", "ecmp_down", "assign"):
                assert torch.equal(getattr(ops, f)[g], getattr(own, f)[o]), f
            # the plans may be wider (the batch's width): pads add +0.0
            want = own.ecmp_load[o]
            got = ops.ecmp_load[g]
            assert torch.equal(got[..., :want.shape[-1]], want)
            assert bool((got[..., want.shape[-1]:] == len(ln.fa)).all())


def test_batch_rejects_points_of_another_structure():
    """Points must share the engine config, trace spec and flow count."""
    base = get_scenario("fig11_degraded_leaf").with_sim(slots=20)
    for other in (base.with_sim(routing="ecmp"), base.with_sim(slots=21),
                  base.with_sim(trace=TraceSpec(enabled=True)),
                  get_scenario("fig9_victim_noise").with_sim(slots=20)):
        with pytest.raises(ValueError, match="structurally identical"):
            engine.dispatch_compiled_batch(
                [compile_scenario(base), compile_scenario(other)], "cpu")


# the megabatch grid: two flow buckets (60 -> 64 and 30 -> 32 flows),
# routing x NIC, two seeds, flap timelines that differ, a traced half
GRID_SLOTS = 48


def _grid():
    out = []
    for name, start in (("flap_during_incast", 20),
                        ("staggered_incast_bursts", None),
                        ("flap_during_incast", 31)):
        for routing in ("ar", "war", "ecmp"):
            for nic in ("spx", "dcqcn"):
                for seed in (0, 1):
                    trace = name == "flap_during_incast" and seed == 1
                    out.append(_pair(name, start, trace=trace,
                                     slots=GRID_SLOTS, routing=routing,
                                     nic=nic, seed=seed))
    return out


def test_megabatch_rows_equal_single_runs_and_the_reference():
    """`run_megabatch` over the grid: one slot loop per (structure, flow
    bucket, routing, NIC); each row equals its point run alone and stays
    within `_assert_parity` of the reference's `run_megabatch` row, and a
    traced row's flow-axis fields have the point's own flow count and
    the reference's values."""
    pairs = _grid()
    points = [compile_scenario(p) for _, p in pairs]
    engine.reset_dispatch_stats()
    got = megabatch.run_megabatch(points, device="cpu")
    # (untraced, traced) x (bucket 64, bucket 32) groups, minus the
    # bucket-32 points that are never traced: 3 groups of 6 sub-batches
    assert engine.dispatch_stats()["loops"] == 18
    with jax.enable_x64(True):
        rc = [jx_compile(r) for r, _ in pairs]
        want = jx_megabatch.run_megabatch([jx_compile(r) for r, _ in pairs])
    for (r, p), c, g, rcc, w in zip(pairs, points, got, rc, want):
        assert_lane_equals_single(g, c.run(device="cpu"))
        _assert_parity((p, c, g), (r, rcc, w))
        assert len(g.mean_goodput) == len(c.flows)
        if w.trace is not None:
            for f in FLOW_AXIS_FIELDS:
                assert g.trace[f].shape[1] == len(c.flows)
            _assert_traces_close(g.trace, w.trace, p.name)


def test_megabatch_groups_by_structure_and_flow_bucket():
    """`plan_megabatch` groups by structure with routing and NIC lifted
    out and by pow2 flow bucket (at least `FLOW_BUCKET_MIN`), in first
    appearance order."""
    points = [compile_scenario(p) for _, p in _grid()]
    _, planned = megabatch.plan_megabatch(points)
    assert [len(g) for g in planned] == [12, 12, 12]
    buckets = [{megabatch._bucket(len(c.flows), megabatch.FLOW_BUCKET_MIN)
                for _, c in g} for g in planned]
    assert buckets == [{64}, {64}, {32}]
    assert [megabatch._bucket(n, 8) for n in (1, 8, 9, 60, 64, 65)] == \
        [8, 8, 16, 64, 64, 128]


def test_pad_flows_stay_out_of_every_plan():
    """A padded lane's plans index only its own flows or the pad row:
    no pad flow is summed into a host, pair or ECMP link bucket."""
    spec = _spec(get_scenario, "staggered_incast_bursts[ecmp]", slots=20)
    c = compile_scenario(spec)
    ln = engine._lane(c)
    F, pad = len(ln.fa), 32
    ops = engine._lane_operands(ln, ln.boundaries, ln.widths, "cpu",
                                torch.float64, pad=pad)
    assert ops.fb.demand.shape == (pad,)
    assert bool((ops.fb.demand[F:] == 0).all())
    assert bool(torch.isinf(ops.fb.bytes_total[F:]).all())
    assert bool((ops.fb.start_slot[F:] == spec.sim.slots).all())
    assert bool(ops.fb.same_leaf[F:].all())
    for plan in (ops.agg_src, ops.agg_dst, ops.agg_pair, ops.ecmp_load):
        used = plan[plan != pad]
        assert bool((used < F).all())


def test_megabatch_prep_is_memoized_by_content():
    """Host prep is built once per content key: the grid's points share
    one flow-array build per scenario, one timeline per (scenario,
    fault start), and an ECMP replay only per ECMP seed."""
    pairs = _grid()
    points = [compile_scenario(p) for _, p in pairs]
    caches, planned = megabatch.plan_megabatch(points)
    for group in planned:
        megabatch.dispatch_planned(group, caches, "cpu")
    kinds = {}
    for key in caches:
        kinds[key[0]] = kinds.get(key[0], 0) + 1
    assert kinds["fa"] == 2                   # two scenarios
    assert kinds["tl"] == 3                   # two flap starts, no faults
    # AR and WAR share one placeholder a timeline; ECMP one per seed
    assert kinds["assign"] == 3 * 2 + 3 * 2
    for group in planned:
        for _, c in group:
            lane = engine._lane(c, caches)
            assert lane.fa is caches[lane.fa_key]
