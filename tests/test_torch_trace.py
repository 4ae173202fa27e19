"""Trace capture in the PyTorch port, held to the JAX package.

With `sim.trace` enabled, the port's slot engine records the reference's
five per-slot signals (`host_bw`, `util`, `queue`, `ecn`, `eligible`) at
the slots `range(0, slots, every)`.  On the CPU every field must match
the reference's `run_compiled` (under `jax.enable_x64(True)`) within
1e-5 in shape and value: on fig12's plane flap with every field and
with a decimated field subset, and on a fat tree, an ECMP spine cascade
and an ECMP scenario under failure reaction.  The §5.2 acceptance
signature of fig12 at 600 slots must come out of the port's trace, and
its `distill_metrics` row must carry the reference row's trace columns.
Tracing off must change nothing: no trace, the same outputs bit for bit
and the same kernel calls a slot.  `SlotLoop`'s record buffers, stepped
without capture, must equal the eager loop's records.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.netsim.jx.engine import run_compiled as jx_run_compiled
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import distill_metrics as jx_distill
from repro.scenarios import get_scenario as jx_get
from repro.trace import TraceSpec as JxTraceSpec
from repro_torch.core.telemetry import bw_histogram, classify_histogram, \
    find_stragglers
from repro_torch.netsim import engine
from repro_torch.netsim.cc import PROBE_TIMEOUT
from repro_torch.netsim.graph import _leaves
from repro_torch.scenarios import compile_scenario, distill_metrics, \
    get_scenario
from repro_torch.trace import TRACE_FIELDS, TraceSpec, trace_summary, \
    trace_to_npz, trace_to_perfetto

from test_torch_engine import TOL, _assert_parity, _split


def _specs(name, slots, **trace_kw):
    """(reference spec, port spec) of a `name[routing]` scenario with an
    enabled trace."""
    base, sim = _split(name)
    return (jx_get(base).with_sim(slots=slots, trace=JxTraceSpec(
                enabled=True, **trace_kw), **sim),
            get_scenario(base).with_sim(slots=slots, trace=TraceSpec(
                enabled=True, **trace_kw), **sim))


def _runs(name, slots, **trace_kw):
    """(port, reference), each (spec, compiled, result): the port on the
    CPU, the reference's `run_compiled` in float64."""
    rspec, spec = _specs(name, slots, **trace_kw)
    with jax.enable_x64(True):
        rc = jx_compile(rspec)
        ref = jx_run_compiled(jx_compile(rspec))
    c = compile_scenario(spec)
    return (spec, c, c.run(device="cpu")), (rspec, rc, ref)


def _assert_traces_close(got, want, where=""):
    assert set(got) == set(want), where
    for k in want:
        x = np.asarray(got[k], np.float64)
        y = np.asarray(want[k], np.float64)
        assert x.shape == y.shape, f"{where} {k}: {x.shape} vs {y.shape}"
        assert np.abs(x - y).max(initial=0.0) < TOL, f"{where} {k}"


@pytest.mark.parametrize("every,fields", [
    (1, TRACE_FIELDS), (7, ("host_bw", "queue")), (7, TRACE_FIELDS),
    (3, ("ecn", "eligible", "util"))])
def test_fig12_trace_matches_the_reference(every, fields):
    """fig12's plane flap at 137 slots: the recorded slots are
    `range(0, 137, every)`, only the requested fields are captured, and
    each agrees with the reference's within 1e-5."""
    port, ref = _runs("fig12_plane_flap", 137, every=every, fields=fields)
    got = port[2].trace
    np.testing.assert_array_equal(got["slot"], np.arange(0, 137, every))
    assert set(got) == {"slot"} | set(fields)
    for f in fields:
        assert got[f].shape[0] == len(range(0, 137, every))
    if "eligible" in fields:
        assert got["eligible"].dtype == bool
    _assert_traces_close(got, ref[2].trace, f"fig12 every={every}")
    _assert_parity(port, ref)


@pytest.mark.parametrize("name,slots", [
    ("ft_core_failure_resiliency", 140),      # fat tree, WAR, core kill
    ("cascading_spine_loss[ecmp]", 200),      # ECMP re-hash at each kill
    ("reroute_random_failures", 140)])        # ECMP under reaction
def test_trace_matches_the_reference_across_fabrics(name, slots):
    """A fat tree, an ECMP spine cascade and an ECMP scenario under
    failure reaction: every field within 1e-5 of the reference, and the
    run's other outputs still under `_assert_parity`."""
    port, ref = _runs(name, slots, every=3)
    _assert_traces_close(port[2].trace, ref[2].trace, name)
    _assert_parity(port, ref)
    if ref[2].blackhole_timeline is not None:
        np.testing.assert_allclose(port[2].blackhole_timeline,
                                   ref[2].blackhole_timeline, atol=TOL)


def test_fig12_acceptance_signature():
    """§5.2 on the port's full fig12 run: the flapped (host 0, plane 1)
    port is bi-modal healthy-blocked, the surviving ports are line-rate,
    host 0 is the one straggler, a quarter of the active ports are
    bi-modal, and the distilled row has the reference row's trace
    columns."""
    port, ref = _runs("fig12_plane_flap", 600)
    spec, c, res = port
    cap = spec.topo.access_cap
    hb = res.trace["host_bw"]
    assert classify_histogram(bw_histogram(hb[:, 0, 1] / cap)) == \
        "healthy-blocked"
    for plane in (0, 2, 3):
        assert classify_histogram(bw_histogram(hb[:, 0, plane] / cap)) == \
            "line-rate"
    host = hb.sum(2) / (cap * spec.topo.n_planes)
    assert find_stragglers(host.T) == [0]
    summ = trace_summary(res.trace, cap, spec.topo.n_planes)
    assert summ["straggler_ranks"] == (0,)
    assert summ["bimodal_frac"] == 0.25
    assert summ["hft_transient_drops"] >= 0
    got, want = distill_metrics(*port), jx_distill(*ref)
    assert got.straggler_ranks == want.straggler_ranks == (0,)
    assert got.bimodal_frac == want.bimodal_frac == 0.25
    assert got.hft_transient_drops == want.hft_transient_drops
    assert got.extra == want.extra
    assert got.extra["port_classes"]["healthy-blocked"] == 1
    _assert_parity(port, ref)


def test_trace_exports_roundtrip(tmp_path):
    """The port's trace through `trace_to_npz` and `trace_to_perfetto`:
    the arrays come back as they were, and the timeline has a counter
    track for every host and plane and the plane-1 access kill at slot
    50 as a failover instant."""
    spec = get_scenario("fig12_plane_flap").with_sim(
        slots=137, trace=TraceSpec(enabled=True))
    res = compile_scenario(spec).run(device="cpu")
    npz, pft = tmp_path / "t.npz", tmp_path / "t.json"
    trace_to_npz(str(npz), res.trace, slot_us=spec.sim.slot_us)
    trace_to_perfetto(str(pft), res.trace, slot_us=spec.sim.slot_us,
                      label="fig12")
    z = np.load(str(npz))
    for k, v in res.trace.items():
        np.testing.assert_array_equal(z[k], v)
    assert float(z["slot_us"]) == spec.sim.slot_us
    events = json.loads(pft.read_text())["traceEvents"]
    assert events and all("ts" in e for e in events)
    instants = [e for e in events if e["ph"] == "i"]
    assert any("plane1 failover" in e["name"] for e in instants)
    # the NIC's probes miss from slot 50 and give the plane up at the
    # probe timeout's last miss
    assert min(e["ts"] for e in instants if "plane1" in e["name"]) == \
        (50 + PROBE_TIMEOUT - 1) * spec.sim.slot_us
    names = {e["name"] for e in events}
    assert {f"host{h}.goodput" for h in range(8)} <= names
    assert {f"plane{p}.util" for p in range(4)} <= names


@pytest.mark.parametrize("name", ["fig12_plane_flap",
                                  "cascading_spine_loss[ecmp]"])
def test_trace_off_changes_nothing(monkeypatch, name):
    """A run with tracing off has no trace; tracing on leaves every other
    output bit-equal and calls each kernel wrapper once a slot, as the
    run without it does."""
    base, sim = _split(name)
    calls = {}
    for fn in ("plane_split", "pair_fractions", "bottleneck_many",
               "bucket_load_bottleneck", "queue_update_many",
               "nic_update"):
        def counted(*args, _fn=fn, _orig=getattr(engine, fn), **kw):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _orig(*args, **kw)
        monkeypatch.setattr(engine, fn, counted)
    runs = []
    for trace in (TraceSpec(), TraceSpec(enabled=True, every=5)):
        calls.clear()
        spec = get_scenario(base).with_sim(slots=120, trace=trace, **sim)
        runs.append((compile_scenario(spec).run(device="cpu"), dict(calls)))
    (off, calls_off), (on, calls_on) = runs
    assert off.trace is None and on.trace is not None
    assert calls_on == calls_off
    assert set(calls_off.values()) == {120}
    for f in ("mean_goodput", "completion_slot", "total_goodput",
              "util_up_last"):
        np.testing.assert_array_equal(getattr(on, f), getattr(off, f))


@pytest.mark.parametrize("name,every,fields", [
    ("fig12_plane_flap", 1, TRACE_FIELDS),
    ("fig12_plane_flap", 7, ("host_bw", "eligible")),
    ("reroute_random_failures_ft", 4, TRACE_FIELDS)])
def test_record_buffers_equal_the_eager_records(name, every, fields):
    """`SlotLoop` stepped without capture: each slot writes its record
    row through the device table (a slot that is not recorded, the
    scratch row), and the records, scratch row dropped, equal the eager
    loop's, as do the carry and series."""
    base, sim = _split(name)
    trace = TraceSpec(enabled=True, every=every, fields=fields)
    spec = get_scenario(base).with_sim(slots=90, trace=trace, **sim)
    cfg, fa, ops = engine.prepare(compile_scenario(spec), "cpu",
                                  torch.float64)
    loop = engine.slot_loop(cfg, ops, trace=trace)
    n_rec = len(range(0, 90, every))
    assert loop.n_rec == n_rec
    assert loop.rows.tolist() == [t // every if t % every == 0 else n_rec
                                  for t in range(90)]
    loop.run()
    want = engine._simulate(cfg, ops, trace=trace)
    got = engine._loop_results(cfg, loop)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert [r.shape[0] for r in loop.records] == [n_rec] * len(fields)
    res = engine._wrap(cfg, fa, got, torch.device("cpu"), trace)
    assert list(res.trace) == ["slot"] + list(fields)
    carry = engine.init_carry(ops.fb, cfg)
    for t in range(90):
        carry, *_ = engine._slot_step(cfg, ops, carry, t, trace)
    for g, w in zip(_leaves(loop.carry), _leaves(carry)):
        assert torch.equal(g, w)


def test_distill_keeps_defaults_without_a_trace():
    """Without a trace the row keeps the "not captured" columns."""
    spec = get_scenario("fig12_plane_flap").with_sim(slots=40)
    c = compile_scenario(spec)
    m = distill_metrics(spec, c, c.run(device="cpu"))
    assert m.hft_transient_drops == -1 and math.isnan(m.bimodal_frac)
    assert m.straggler_ranks == () and "port_classes" not in m.extra
