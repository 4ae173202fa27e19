"""The PyTorch port's host preparation, held to the JAX package's by array
equality.

The port keeps its own copies of the scenario schema and registry, the
scenario compiler, the fault-timeline compiler, the ECMP assignment
replay and the slot engine's operand builders.  For every leaf-spine
AR/WAR/ECMP registry scenario without failure reaction or schedule
workloads (among them the giga-scale point under its own ECMP), the
giga point under AR and three registry scenarios under ECMP, the copies
must produce exactly the reference's flows, tenants, fault transitions,
`FlowArrays`, capacity timelines, segment maps, ECMP assignment
segments and aggregation plans — so both engines start every run from
the same operands.  The last tests pin the import boundary (the port imports
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
    return (s.topo.kind == "leaf_spine"
            and s.sim.routing in ("ar", "war", "ecmp")
            and s.reaction is None
            and all(w.kind != "schedule" for w in s.workloads))


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
    assert len(SLICE) == 18
    assert {"fig9_victim_noise", "fig11_degraded_leaf",
            "fig12_plane_flap", "giga_fabric_storage"} <= set(SLICE)


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
    ("ft_cross_pod_all2all[ecmp]", "run"),   # ECMP on a fat tree
    ("bisection_fat_tree", "run"),           # fat-tree fabric
    ("reroute_random_failures", "compile"),  # failure reaction
    ("train_step_baseline", "compile"),      # schedule workload
])
def test_later_slices_raise_not_implemented(name, stage):
    spec = _pair(name)[1]
    if stage == "compile":
        with pytest.raises(NotImplementedError):
            compile_scenario(spec)
        return
    c = compile_scenario(spec.with_sim(slots=4))
    with pytest.raises(NotImplementedError):
        c.run(device="cpu")


def test_ecmp_replay_raises_outside_the_slice():
    """Fat-tree path capacity and the reaction modes of the replay are
    later slices; the leaf-spine replay equals the reference's draw for
    draw (including re-hash draws at each spine kill)."""
    from repro.netsim.jx.events import ecmp_assign_segments as jx_assign
    from repro_torch.netsim.events import ecmp_assign_segments
    spec = get_scenario("cascading_spine_loss").with_sim(routing="ecmp")
    tl = compile_fault_timeline(spec)
    fa = FlowArrays.build(compile_scenario(spec).flows, spec.topo)
    b = tl.change_slots()
    args = (fa.src_leaf, fa.dst_leaf, tl, 5, spec.topo.n_spines, b)
    np.testing.assert_array_equal(ecmp_assign_segments(*args),
                                  jx_assign(*args))
    with pytest.raises(NotImplementedError, match="reaction"):
        ecmp_assign_segments(*args, vis_timeline=tl)
    with pytest.raises(NotImplementedError, match="reaction"):
        ecmp_assign_segments(*args, mode="backup")
    ft = get_scenario("ft_cross_pod_all2all")
    ftl = compile_fault_timeline(ft)
    ffa = FlowArrays.build(compile_scenario(ft).flows, ft.topo)
    with pytest.raises(NotImplementedError, match="fat-tree"):
        ecmp_assign_segments(ffa.src_leaf, ffa.dst_leaf, ftl, 0,
                             ft.topo.n_cores, [0])


def test_poisson_flap_and_trace_raise_not_implemented():
    spec = dataclasses.replace(get_scenario("poisson_flap_storm"),
                               reaction=None).with_sim(routing="ar")
    with pytest.raises(NotImplementedError, match="poisson_flap"):
        compile_scenario(spec)
    traced = get_scenario("fig12_plane_flap").with_sim(
        trace=TraceSpec(enabled=True))
    with pytest.raises(NotImplementedError, match="trace"):
        compile_scenario(traced).run(device="cpu")
