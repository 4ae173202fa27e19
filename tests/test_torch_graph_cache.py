"""The graph cache across calls (`netsim.graph.cached_loop`, through
`engine.cached_slot_loop` and `engine._cached_run`), the port's
counterpart of the reference's `_JIT_CACHE`, run without capture on the
CPU: a cached entry is rebound to the new operands and carry and
stepped (`SlotLoop.run`) where CUDA replays it.

A loop rebound to another point of its structure must equal a fresh
loop of that point bit for bit (`torch.equal` on every output), a result
handed out must not change when a later call rebinds the entry, every
field of the key must give a miss, a handed-over `carry0` must seed the
rebound loop and stay unwritten, and the cache must keep to its bounds.
The CUDA cases (a warm re-run captures nothing; two outstanding batches
of one structure) are in `test_torch_gpu.py`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.netsim import engine, graph
from repro_torch.netsim.graph import _leaves
from repro_torch.scenarios import compile_scenario, get_scenario
from repro_torch.trace import TraceSpec


@pytest.fixture(autouse=True)
def _empty_cache():
    graph.clear_graph_cache()
    yield
    graph.clear_graph_cache()


def _compiled(name="fig12_plane_flap", **sim):
    return compile_scenario(get_scenario(name).with_sim(**sim))


def _prepared(name="fig12_plane_flap", dtype=torch.float64, **sim):
    return engine.prepare(_compiled(name, **sim), "cpu", dtype)


def _fresh(cfg, ops, carry0=None, trace=None):
    loop = engine.slot_loop(cfg, ops, carry0, trace)
    loop.run()
    return engine._loop_results(cfg, loop)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _hit(cfg, ops, trace=None) -> bool:
    return engine.cached_slot_loop(cfg, ops, trace=trace)[1]


def _other_demand(ops):
    """`ops` with every flow's demand scaled: another point of the same
    structure."""
    return ops._replace(fb=ops.fb._replace(demand=ops.fb.demand * 0.75))


# (scenario, sim overrides, how B differs from A, aggregation mode):
# fig12's swlb probe deadline shortened to fire inside the run
POINTS = [
    ("fig12_plane_flap", dict(slots=260, nic="swlb", sw_lb_delay_ms=20.0),
     "demand", None),
    ("fig12_plane_flap", dict(slots=120, routing="ecmp"), "seed", None),
    ("fig12_plane_flap", dict(slots=120, routing="ecmp"), "seed", "sparse"),
    ("reroute_random_failures", dict(slots=120), "seed", None),
]


@pytest.mark.parametrize("name,sim,vary,agg", POINTS)
def test_rebound_loop_equals_a_fresh_loop(monkeypatch, name, sim, vary,
                                          agg):
    """A then B, two points of one structure: B through the cache (a hit
    on A's entry) equals B on a fresh loop, and A's result, held from
    before, is unchanged."""
    if agg:
        monkeypatch.setenv("REPRO_JX_AGG", agg)
    cfg, _, ops_a = _prepared(name, seed=0, **sim)
    if vary == "seed":
        cfg_b, _, ops_b = _prepared(name, seed=1, **sim)
        assert cfg_b == cfg
    else:
        ops_b = _other_demand(ops_a)
    engine.reset_dispatch_stats()
    got_a = engine._cached_run(cfg, ops_a)
    kept = [r.clone() for r in got_a]
    timing = {}
    got_b = engine._cached_run(cfg, ops_b, timing=timing)
    assert timing["cached"] and timing["capture_s"] == 0.0
    assert graph.graph_cache_stats()["hits"] == 1
    _assert_same(got_b, _fresh(cfg, ops_b))
    _assert_same(got_a, kept)
    _assert_same(got_a, _fresh(cfg, ops_a))
    assert not all(torch.equal(a, b) for a, b in zip(got_a, got_b))
    assert engine.dispatch_stats() == {"loops": 2, "graphs": 0}


def test_rebound_batch_and_trace_equal_fresh_loops():
    """A traced batch of two seeds, then another two: the lane axis and
    the record buffers are rebound as the carry is."""
    trace = TraceSpec(enabled=True, every=7)
    pts = [[_compiled("reroute_random_failures", slots=90, seed=s,
                      trace=trace) for s in seeds]
           for seeds in ((0, 1), (2, 3))]
    batches = [engine.prepare_batch(p, "cpu") for p in pts]
    cfg, trace_b = batches[0][:2]
    assert batches[1][:2] == (cfg, trace_b)
    outs = [engine._cached_run(cfg, ops, trace=trace_b)
            for _, _, _, ops in batches]
    assert graph.graph_cache_stats()["hits"] == 1
    for (_, _, _, ops), got in zip(batches, outs):
        _assert_same(got, _fresh(cfg, ops, trace=trace_b))


@pytest.mark.parametrize("name", ["fig12_plane_flap",
                                  "cascading_spine_loss[ecmp]"])
def test_rebound_loop_takes_a_handed_over_carry(name):
    """`carry0` (the state after 150 eager slots) seeds a rebound loop,
    which equals a fresh loop from it, and is never written."""
    base, _, routing = name.partition("[")
    sim = dict(slots=260, routing=routing[:-1]) if routing else \
        dict(slots=260, nic="swlb", sw_lb_delay_ms=20.0)
    cfg, _, ops = _prepared(base, **sim)
    engine._cached_run(cfg, ops)
    carry0 = engine.init_carry(ops.fb, cfg)
    for t in range(150):
        carry0, *_ = engine._slot_step(cfg, ops, carry0, t)
    kept = [x.clone() for x in _leaves(carry0)]
    got = engine._cached_run(cfg, ops, carry0)
    assert graph.graph_cache_stats()["hits"] == 1
    _assert_same(got, _fresh(cfg, ops, carry0))
    _assert_same(list(_leaves(carry0)), kept)


def _variants(monkeypatch):
    """(field, base (cfg, ops, trace), variant (cfg, ops, trace)): each
    variant differs from its base in one field of the key."""
    cfg, _, ops = _prepared(slots=60)
    out = [("slots", (cfg, ops, None), _prepared(slots=61)[::2] + (None,))]
    out.append(("trace every", (cfg, ops, TraceSpec(enabled=True, every=1)),
                (cfg, ops, TraceSpec(enabled=True, every=7))))
    monkeypatch.setenv("REPRO_JX_AGG", "sparse")
    sparse = _prepared(slots=60)[::2]
    out.append(("agg_mode", (cfg, ops, None), sparse + (None,)))
    monkeypatch.setenv("REPRO_JX_FLOW_CHUNK", "16")
    chunked = _prepared(slots=60)[::2]
    assert chunked[0].flow_chunk == 16
    out.append(("flow_chunk", sparse + (None,), chunked + (None,)))
    monkeypatch.delenv("REPRO_JX_FLOW_CHUNK")
    c32, _, o32 = _prepared(slots=60, dtype=torch.float32)
    monkeypatch.setenv("REPRO_JX_COMPACT", "1")
    k32 = _prepared(slots=60, dtype=torch.float32)[::2]
    assert k32[0] == dataclasses.replace(c32, compact_carry=True)
    out.append(("compact_carry", (c32, o32, None), k32 + (None,)))
    monkeypatch.delenv("REPRO_JX_COMPACT")
    monkeypatch.delenv("REPRO_JX_AGG")
    pts = [_compiled(slots=60, seed=s) for s in range(3)]
    two = engine.prepare_batch(pts[:2], "cpu")
    three = engine.prepare_batch(pts, "cpu")
    out.append(("lanes", (two[0], two[3], None), (three[0], three[3], None)))
    lanes = [engine._lane(c) for c in pts[:2]]
    pads = [engine._batch_operands(lanes, torch.device("cpu"),
                                   torch.float64, pad=n) for n in (64, 128)]
    out.append(("flow bucket", (two[0], pads[0], None),
                (two[0], pads[1], None)))
    sp = sparse[1].sparse
    wider = sparse[1]._replace(sparse=sp._replace(
        src=sp.src._replace(width=sp.src.width + 1)))
    out.append(("plan width", sparse + (None,), (sparse[0], wider, None)))
    seg = ops.seg_id.copy()
    seg[seg.size // 2:] = seg.max()
    assert not np.array_equal(seg, ops.seg_id)
    out.append(("seg_id", (cfg, ops, None),
                (cfg, ops._replace(seg_id=seg), None)))
    return out


def test_every_key_field_gives_a_miss(monkeypatch):
    """Slots, the trace's decimation, the aggregation mode, the flow
    chunk, the compact carry, the lanes, the flow bucket, a plan's width
    and the slot->segment map each give a miss; the base itself hits."""
    for field, base, variant in _variants(monkeypatch):
        graph.clear_graph_cache()
        assert not _hit(*base), field
        assert not _hit(*variant), field
        assert _hit(*base) and _hit(*variant), field
        assert graph.graph_cache_stats()["entries"] == 2, field


def test_a_miss_on_the_segment_map_runs_its_own_segments():
    """A loop built for one slot->segment map is not replayed on
    another: each runs as its fresh loop."""
    cfg, _, ops = _prepared(slots=60)
    seg = ops.seg_id.copy()
    seg[:] = seg.max()
    other = ops._replace(seg_id=seg)
    _assert_same(engine._cached_run(cfg, ops), _fresh(cfg, ops))
    _assert_same(engine._cached_run(cfg, other), _fresh(cfg, other))


def test_eviction_at_the_bounds_and_clear(monkeypatch):
    """Least recently used out first at `GRAPH_CACHE_ENTRIES` entries or
    `GRAPH_CACHE_BYTES` bytes; an entry over the byte bound alone is run
    but not kept; `clear_graph_cache` empties the cache and its
    counts."""
    runs = [_prepared(slots=s) for s in (40, 41, 42)]
    monkeypatch.setattr(graph, "GRAPH_CACHE_ENTRIES", 2)
    for cfg, _, ops in runs:
        assert not _hit(cfg, ops)
    st = graph.graph_cache_stats()
    assert (st["entries"], st["misses"]) == (2, 3)
    assert _hit(*runs[1][::2]) and _hit(*runs[2][::2])
    assert not _hit(*runs[0][::2])               # evicted first
    assert graph.graph_cache_stats()["entries"] == 2

    graph.clear_graph_cache()
    assert graph.graph_cache_stats() == dict(entries=0, bytes=0, hits=0,
                                             misses=0)
    monkeypatch.setattr(graph, "GRAPH_CACHE_ENTRIES", 64)
    _hit(*runs[0][::2])
    one = graph.graph_cache_stats()["bytes"]
    assert one > 0
    monkeypatch.setattr(graph, "GRAPH_CACHE_BYTES", one + one // 2)
    _hit(*runs[1][::2])
    st = graph.graph_cache_stats()
    assert st["entries"] == 1 and st["bytes"] <= one + one // 2
    assert not _hit(*runs[0][::2])               # the older one went
    monkeypatch.setattr(graph, "GRAPH_CACHE_BYTES", one // 2)
    graph.clear_graph_cache()
    cfg, _, ops = runs[2]
    _assert_same(engine._cached_run(cfg, ops), _fresh(cfg, ops))
    assert graph.graph_cache_stats()["entries"] == 0


class _Graph:
    """A stand-in for a captured graph: what `release` calls."""

    def reset(self):
        pass


def test_dispatch_stats_count_graphs_captured(monkeypatch):
    """`dispatch_stats()["graphs"]` counts the graphs a miss made (here
    two stand-ins a loop) and none for a hit, so a warm re-run reports
    0 graphs; `loops` counts every run."""
    build = engine.slot_loop

    def with_graphs(*a, **k):
        loop = build(*a, **k)
        loop.graphs.update({0: (_Graph(), {}), 1: (_Graph(), {})})
        return loop
    monkeypatch.setattr(engine, "slot_loop", with_graphs)
    cfg, _, ops = _prepared(slots=40)
    cfg2, _, ops2 = _prepared(slots=41)
    engine.reset_dispatch_stats()
    for c, o in ((cfg, ops), (cfg2, ops2)):
        engine._cached_run(c, o)
    assert engine.dispatch_stats() == {"loops": 2, "graphs": 4}
    engine.reset_dispatch_stats()
    for c, o in ((cfg, ops), (cfg2, ops2)):
        engine._cached_run(c, o)
    assert engine.dispatch_stats() == {"loops": 2, "graphs": 0}
    # the CPU entry point runs its plain eager loop, outside the cache
    engine.reset_dispatch_stats()
    graph.clear_graph_cache()
    engine._simulate(cfg, ops)
    assert engine.dispatch_stats() == {"loops": 1, "graphs": 0}
    assert graph.graph_cache_stats()["entries"] == 0
