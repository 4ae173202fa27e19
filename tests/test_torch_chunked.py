"""Chunked flow streaming in the PyTorch port (`netsim/chunked.py`),
held to its one-pass sparse run and to the JAX package's chunked path.

With `EngineConfig.flow_chunk` the slot streams its flows in chunks:
each chunk's rates continue the flow-ordered segment sums of the chunks
before it, and the per-flow half runs chunk by chunk.  In float64 every
chunk length (17, with a tail; 64, longer than a 60-flow run; the whole
flow count) must reproduce the one-pass sparse run bit for bit on a
leaf-spine and a fat tree under AR, WAR and ECMP, and meet
`_assert_parity` against the reference run with
`REPRO_JX_FLOW_CHUNK=17` (under `jax.enable_x64(True)`).  Batches and
megabatch grids under sparse aggregation and under chunks of 17 must
give each lane its single run, and the reference's `run_megabatch` row.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.netsim.jx import engine as jx_engine
from repro.netsim.jx import megabatch as jx_megabatch
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import get_scenario as jx_get
from repro.trace import TraceSpec as JxTraceSpec
from repro_torch.netsim import engine, megabatch
from repro_torch.scenarios import compile_scenario, get_scenario
from repro_torch.trace import TraceSpec

from test_torch_batch import _pair, _spec, assert_lane_equals_single
from test_torch_engine import _assert_parity
from test_torch_sparse import _assert_same

# a leaf-spine of 60 flows with a link flap at slot 100, a fat tree of
# 64 flows with core kills at slot 100
CHUNK_POINTS = [("flap_during_incast", 120),
                ("ft_core_failure_resiliency", 120)]


def _env(monkeypatch, chunk=None, mode="sparse"):
    monkeypatch.setenv("REPRO_JX_AGG", mode)
    if chunk is None:
        monkeypatch.delenv("REPRO_JX_FLOW_CHUNK", raising=False)
    else:
        monkeypatch.setenv("REPRO_JX_FLOW_CHUNK", str(chunk))


@pytest.mark.parametrize("routing", ["ar", "war", "ecmp"])
@pytest.mark.parametrize("name,slots", CHUNK_POINTS)
def test_chunks_equal_one_pass_and_the_reference(monkeypatch, name, slots,
                                                 routing):
    spec = get_scenario(name).with_sim(slots=slots, routing=routing)
    _env(monkeypatch)
    c = compile_scenario(spec)
    one = c.run(device="cpu")
    F = len(c.flows)
    for chunk in (17, 64, F):
        _env(monkeypatch, chunk)
        cfg, *_ = engine._prepared(c)
        assert (cfg.agg_mode, cfg.flow_chunk) == ("sparse", chunk)
        got = c.run(device="cpu")
        assert got.mean_goodput.shape == (F,)
        _assert_same(got, one)
    _env(monkeypatch, 17)
    rspec = _spec(jx_get, name, slots=slots, routing=routing)
    with jax.enable_x64(True):
        rc = jx_compile(rspec)
        assert jx_engine._prepared(rc)[0].flow_chunk == 17
        want = rc.run(backend="jax")
    _assert_parity((spec, c, got), (rspec, rc, want))


def test_chunk_kernel_calls_per_slot(monkeypatch):
    """A chunked slot of n chunks: the plane split twice a chunk (its
    sums, then its per-flow half), one segment-sum launch and one NIC
    update a chunk, and one launch each of the link-level kernels."""
    calls = {}
    for fn in ("plane_split", "pair_fractions", "bottleneck_many",
               "bucket_load_bottleneck", "queue_update_many", "nic_update",
               "segment_sum_many"):
        def counted(*args, _fn=fn, _orig=getattr(engine, fn), **kw):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _orig(*args, **kw)
        monkeypatch.setattr(engine, fn, counted)
    slots, n = 10, 4                                   # 60 flows, 4 chunks
    _env(monkeypatch, 17)
    compile_scenario(get_scenario("flap_during_incast").with_sim(
        slots=slots)).run(device="cpu")
    assert calls == dict(plane_split=2 * n * slots,
                         segment_sum_many=n * slots, nic_update=n * slots,
                         pair_fractions=slots, bottleneck_many=slots,
                         queue_update_many=slots)


def test_chunking_refusals(monkeypatch):
    """As the reference: a forced chunk makes the run sparse, a trace
    keeps it in one pass, and the engine refuses chunks with dense
    aggregation (`ValueError`) or with a trace
    (`NotImplementedError`)."""
    _env(monkeypatch, 17, mode="dense")
    spec = get_scenario("flap_during_incast").with_sim(slots=8)
    c = compile_scenario(spec)
    cfg, *_ = engine._prepared(c)
    assert (cfg.agg_mode, cfg.flow_chunk) == ("sparse", 17)
    traced = compile_scenario(spec.with_sim(trace=TraceSpec(enabled=True)))
    tcfg, *_ = engine._prepared(traced)
    assert (tcfg.agg_mode, tcfg.flow_chunk) == ("dense", 0)
    rc = jx_compile(_spec(jx_get, "flap_during_incast", slots=8,
                          trace=JxTraceSpec(enabled=True)))
    assert jx_engine._prepared(rc)[0].flow_chunk == 0
    _, _, ops = engine.prepare(c, "cpu")
    with pytest.raises(ValueError, match="sparse"):
        engine._simulate(dataclasses.replace(cfg, agg_mode="dense"), ops)
    with pytest.raises(NotImplementedError, match="TraceSpec"):
        engine._simulate(cfg, ops, trace=TraceSpec(enabled=True))


BATCH_LANES = [(None, dict(seed=s)) for s in range(3)] + [(60, dict(seed=4))]


@pytest.mark.parametrize("chunk", [None, 17])
@pytest.mark.parametrize("name", ["flap_during_incast[ecmp]",
                                  "ft_core_failure_resiliency[war]"])
def test_batch_lanes_equal_single_runs(monkeypatch, name, chunk):
    """`run_compiled_batch` under sparse aggregation and under chunks of
    17: each lane equals its point run alone."""
    _env(monkeypatch, chunk)
    points = [compile_scenario(_spec(get_scenario, name, start, slots=110,
                                     **sim)) for start, sim in BATCH_LANES]
    got = engine.run_compiled_batch(points, device="cpu")
    for c, g in zip(points, got):
        assert engine._prepared(c)[0].flow_chunk == (chunk or 0)
        assert_lane_equals_single(g, c.run(device="cpu"))


def _grid():
    """Two flow buckets (60 -> 64 and 30 -> 32 flows), routing x NIC,
    two seeds."""
    out = []
    for name, start in (("flap_during_incast", 20),
                        ("staggered_incast_bursts", None)):
        for routing in ("ar", "war", "ecmp"):
            for nic in ("spx", "swlb"):
                for seed in (0, 1):
                    out.append(_pair(name, start, slots=40,
                                     routing=routing, nic=nic, seed=seed))
    return out


@pytest.mark.parametrize("chunk", [None, 17])
def test_megabatch_rows_equal_single_runs_and_the_reference(monkeypatch,
                                                            chunk):
    """`run_megabatch` under sparse aggregation and under chunks of 17
    (sized off each group's flow bucket, which rounds up to whole
    chunks): every row equals its point run alone and meets
    `_assert_parity` against the reference's `run_megabatch` row under
    the same setting."""
    _env(monkeypatch, chunk)
    pairs = _grid()
    points = [compile_scenario(p) for _, p in pairs]
    caches, planned = megabatch.plan_megabatch(points)
    for group in planned:
        for prep in megabatch.prepare_planned(group, caches):
            assert {ln.cfg.agg_mode for ln in prep.lanes} == {"sparse"}
            assert {ln.cfg.flow_chunk for ln in prep.lanes} == {chunk or 0}
            if chunk:
                assert prep.pad % chunk == 0 and prep.pad >= 32
    got = megabatch.run_megabatch(points, device="cpu")
    with jax.enable_x64(True):
        rcs = [jx_compile(r) for r, _ in pairs]
        want = jx_megabatch.run_megabatch([jx_compile(r) for r, _ in pairs])
    for (r, p), c, g, rc, w in zip(pairs, points, got, rcs, want):
        assert len(g.mean_goodput) == len(c.flows)
        assert_lane_equals_single(g, c.run(device="cpu"))
        _assert_parity((p, c, g), (r, rc, w))


def test_sparse_plans_leave_pad_flows_out(monkeypatch):
    """A padded chunked lane's plans index only its own flows: every
    entry reads a real flow of its chunk."""
    c = compile_scenario(_spec(get_scenario, "staggered_incast_bursts[ecmp]",
                               slots=20))
    _env(monkeypatch, 7)
    ln = engine._lane(c)
    F, pad, P = len(ln.fa), 32, ln.cfg.n_planes
    ops = engine._lane_operands(ln, ln.boundaries, ln.widths, "cpu",
                                torch.float64, pad=pad)
    sp = ops.sparse
    assert (sp.chunk, sp.n_in) == (7, pad)
    assert ops.fb.demand.shape == (35,)             # 32 rounded to 5 x 7
    for plan in (sp.src, sp.dst, sp.link):
        offs = plan.offsets.reshape(-1, plan.offsets.shape[-1])
        ents = plan.entries.reshape(offs.shape[0], -1)
        for o, e in zip(offs, ents):
            K = (o.numel() - 1) // 5
            for ch in range(5):
                lo, hi = int(o[ch * K]), int(o[(ch + 1) * K])
                flows = ch * 7 + e[lo:hi].long() // P
                assert bool((flows < F).all())
    np.testing.assert_array_equal(ops.fb.demand[F:].numpy(), 0.0)
