"""The PyTorch port's host preparation, held to the JAX package's by array
equality.

The port keeps its own copies of the scenario schema and registry, the
scenario compiler, the fault-timeline compiler and the slot engine's
operand builders.  For every leaf-spine AR/WAR registry scenario without
failure reaction or schedule workloads (plus the giga-scale point under
AR) the copies must produce exactly the reference's flows, tenants,
fault transitions, `FlowArrays`, capacity timelines, segment maps and
aggregation plans — so both engines start every run from the same
operands.  The last tests pin the import boundary (the port imports
neither `jax` nor `repro`) and the `NotImplementedError`s of the parts
later slices bring.
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
    return (s.topo.kind == "leaf_spine" and s.sim.routing in ("ar", "war")
            and s.reaction is None
            and all(w.kind != "schedule" for w in s.workloads))


SLICE = sorted(n for n in jx_list() if _in_slice(n))
GIGA_AR = "giga_fabric_storage[ar]"


def _pair(name):
    """(reference spec, port spec) for a slice scenario name."""
    if name == GIGA_AR:
        return (jx_get("giga_fabric_storage").with_sim(routing="ar"),
                get_scenario("giga_fabric_storage").with_sim(routing="ar"))
    return jx_get(name), get_scenario(name)


def _flow_rows(flows):
    return [(f.src, f.dst, f.demand, f.bytes_total, f.group, f.start_slot,
             f.phase) for f in flows]


def test_slice_covers_the_leaf_spine_ar_war_registry():
    assert len(SLICE) == 17
    assert {"fig9_victim_noise", "fig11_degraded_leaf",
            "fig12_plane_flap"} <= set(SLICE)


def test_registry_specs_equal_the_reference():
    assert list_scenarios() == jx_list()
    for name in jx_list():
        assert dataclasses.asdict(get_scenario(name)) == \
            dataclasses.asdict(jx_get(name)), name


@pytest.mark.parametrize("name", SLICE + [GIGA_AR])
def test_host_prep_equals_reference(name):
    ref_spec, spec = _pair(name)
    rc, c = jx_compile(ref_spec), compile_scenario(spec)
    assert _flow_rows(c.flows) == _flow_rows(rc.flows)
    assert c.tenants == rc.tenants
    assert c.fault_slots == rc.fault_slots

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

    # the reference picks sparse aggregation at giga scale; its dense
    # gather plans are the ones the port runs
    rcfg = dataclasses.replace(
        jx_engine.JxConfig.from_sim(rc.cfg, ref_spec.topo),
        agg_mode="dense")
    cfg = engine.EngineConfig.from_sim(c.cfg, spec.topo)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
    segs = jx_engine._assign_for(rcfg, rfa, rtl, rc.cfg.seed, boundaries)
    raggs = jx_engine._aggs_for(rcfg, rfa, segs,
                                jx_engine._agg_widths(rcfg, rfa, segs))
    aggs = engine._aggs_for(cfg, fa, engine._agg_widths(cfg, fa))
    for field in ("src", "dst", "pair"):
        np.testing.assert_array_equal(getattr(aggs, field),
                                      getattr(raggs, field), err_msg=field)


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
    f32 = operands_from_numpy(cfg, fa, engine._aggs_for(
        cfg, fa, engine._agg_widths(cfg, fa)), tl.up[b], tl.down[b],
        tl.access[b], engine._seg_id(b, cfg.slots), device="cpu",
        dtype=torch.float32)
    assert f32.up.dtype == f32.fb.demand.dtype == torch.float32


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
    ("giga_fabric_storage", "run"),          # ECMP
    ("bisection_fat_tree", "run"),           # fat-tree fabric
    ("reroute_random_failures", "compile"),  # failure reaction
    ("train_step_baseline", "compile"),      # schedule workload
])
def test_later_slices_raise_not_implemented(name, stage):
    spec = get_scenario(name)
    if stage == "compile":
        with pytest.raises(NotImplementedError):
            compile_scenario(spec)
        return
    c = compile_scenario(spec.with_sim(slots=4))
    with pytest.raises(NotImplementedError):
        c.run(device="cpu")


def test_poisson_flap_and_trace_raise_not_implemented():
    spec = dataclasses.replace(get_scenario("poisson_flap_storm"),
                               reaction=None).with_sim(routing="ar")
    with pytest.raises(NotImplementedError, match="poisson_flap"):
        compile_scenario(spec)
    traced = get_scenario("fig12_plane_flap").with_sim(
        trace=TraceSpec(enabled=True))
    with pytest.raises(NotImplementedError, match="trace"):
        compile_scenario(traced).run(device="cpu")
