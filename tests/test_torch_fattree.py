"""The PyTorch port on the 3-tier fat-tree fabric, held to the JAX package.

The fat tree routes over cores: a path composes stage A (leaf↔agg, the
agg serving the core) with stage B (pod↔core) for leaf pairs in
different pods, and the carry holds the stage-B queues `q2_up` and
`q2_down`.  The port's host prep (the masked stage-B plans, the bucket
keys and widths, the stage-B capacity timeline, the path capacity of
the ECMP replay) must equal the reference's arrays; its CPU slot engine
must match `CompiledScenario.run(backend="numpy")` and
`run(backend="jax")` (under `jax.enable_x64(True)`) with the contract
of `tests/test_jx_parity.py::_assert_parity` on the registry's three
fat-tree scenarios under AR, WAR and ECMP; one slot handed over from the
JAX engine's state (stage-B queues included) must reproduce the JAX
engine's next state; and the step-by-step replay structure the CUDA loop
captures must equal the eager loop bit for bit.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim.fabric import FlowArrays as JxFlowArrays
from repro.netsim.jx import engine as jx_engine
from repro.netsim.jx.events import compile_fault_timeline as jx_timeline
from repro.netsim.jx.events import timeline_path_capacity as jx_path_cap
from repro.netsim.jx.state import FlowBatch as JxFlowBatch
from repro.netsim.jx.state import init_carry as jx_init_carry
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import get_scenario as jx_get
from repro_torch.netsim import engine
from repro_torch.netsim.carry import carry_from_numpy, operands_from_numpy
from repro_torch.netsim.events import compile_fault_timeline, \
    timeline_path_capacity
from repro_torch.netsim.fabric import FlowArrays
from repro_torch.netsim.graph import _leaves
from repro_torch.scenarios import compile_scenario, get_scenario

from test_torch_engine import _assert_parity, _run_port, _run_refs, _split

FAT_TREE = ["bisection_fat_tree", "ft_cross_pod_all2all",
            "ft_core_failure_resiliency"]
# slots that cover each scenario's faults: bisection's random kills at
# 150, the core kills at 100 and the heal at 260
SLOTS = {"bisection_fat_tree": 200, "ft_cross_pod_all2all": 120,
         "ft_core_failure_resiliency": 300}


def _pair(name):
    base, sim = _split(name)
    rs, ps = jx_get(base), get_scenario(base)
    return (rs.with_sim(**sim), ps.with_sim(**sim)) if sim else (rs, ps)


# ---------------------------------------------------------------------------
# host prep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAT_TREE + [f"{n}[ecmp]" for n in FAT_TREE]
                         + ["reroute_random_failures_ft"])
def test_host_prep_equals_reference(name):
    """Flows, the stage-A and stage-B timelines and their segment
    snapshots, the config, the ECMP assignment (path capacity through
    the agg map and the pod-core hops) and every aggregation plan,
    including the masked stage-B plans, stacked A-up, A-down, B-up,
    B-down."""
    ref_spec, spec = _pair(name)
    rc, c = jx_compile(ref_spec), compile_scenario(spec)
    rfa = JxFlowArrays.build(rc.flows, rc.topo)
    fa = FlowArrays.build(c.flows, c.topo)
    np.testing.assert_array_equal(fa.src, rfa.src)
    np.testing.assert_array_equal(fa.dst_leaf, rfa.dst_leaf)
    rtl, tl = jx_timeline(ref_spec), compile_fault_timeline(spec)
    for field in ("up", "down", "access", "up2", "down2"):
        np.testing.assert_array_equal(getattr(tl, field),
                                      getattr(rtl, field), err_msg=field)
    b = tuple(tl.change_slots())
    assert b == tuple(rtl.change_slots())
    for got, want in zip(engine._seg_caps(tl, b),
                         jx_engine._seg_caps(rtl, b), strict=True):
        np.testing.assert_array_equal(got, want)
    rcfg = dataclasses.replace(
        jx_engine.JxConfig.from_sim(rc.cfg, ref_spec.topo),
        agg_mode="dense")
    cfg = engine.EngineConfig.from_sim(c.cfg, spec.topo)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
    for prop in ("n_paths", "n_up", "cores_per_agg", "leaves_per_pod"):
        assert getattr(cfg, prop) == getattr(rcfg, prop), prop
    assert engine._plan_rows(cfg) == jx_engine._plan_rows(rcfg)
    segs = engine._assign_for(cfg, fa, tl, c.cfg.seed, b)
    np.testing.assert_array_equal(
        segs, jx_engine._assign_for(rcfg, rfa, rtl, rc.cfg.seed, b))
    widths = engine._agg_widths(cfg, fa, segs)
    assert widths == jx_engine._agg_widths(rcfg, rfa, segs)
    aggs = engine._aggs_for(cfg, fa, segs, widths)
    raggs = jx_engine._aggs_for(rcfg, rfa, segs, widths)
    for field in ("src", "dst", "pair", "ecmp_load"):
        got, want = getattr(aggs, field), getattr(raggs, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    if cfg.routing == "ecmp":
        assert aggs.ecmp_load.shape[2] == engine._plan_rows(cfg)
        for g in range(segs.shape[0]):
            for p in range(cfg.n_planes):
                for got, want in zip(
                        engine._ft_ecmp_keys(cfg, fa, segs[g][:, p]),
                        jx_engine._ft_ecmp_keys(rcfg, rfa, segs[g][:, p])):
                    for x, y in zip(got, want):
                        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_perm_matrix_equals_reference(seed):
    rng = np.random.default_rng(seed)
    F, n = 500, 17
    keys = rng.integers(0, n, F)
    mask = rng.random(F) < 0.6
    width = max(1, int(np.bincount(keys[mask], minlength=n).max()))
    got = engine._masked_perm_matrix(keys, mask, n, width + 2, F)
    want = jx_engine._masked_perm_matrix(keys, mask, n, width + 2, F)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_masked_plans_leave_out_intra_pod_flows_bit_equivalently():
    """The stage-B plans leave out intra-pod flows; a plan over every
    flow with their rates zeroed (what the reference's sparse branch and
    the NumPy engine sum, an exact 0.0 each) gives bit-equal bucket
    sums."""
    spec = get_scenario("ft_cross_pod_all2all").with_sim(routing="ecmp")
    c = compile_scenario(spec)
    cfg, fa, tl, _ = engine._prepared(c)
    segs = engine._assign_for(cfg, fa, tl, c.cfg.seed, [0])
    keys = engine._ft_ecmp_keys(cfg, fa, segs[0][:, 0])
    rate = torch.tensor(np.random.default_rng(3).uniform(0.0, 1.0,
                                                         (len(fa), 1)))
    F = len(fa)
    for k, mask, n in keys[2:]:
        assert 0 < mask.sum() < F                  # both kinds of flow
        masked = engine._masked_perm_matrix(k, mask, n, F, F)
        every = engine._perm_matrix(k, n, F, F)
        zeroed = torch.where(torch.tensor(mask)[:, None], rate, 0.0)
        got = engine._seg_sum(rate, torch.as_tensor(masked).long())
        want = engine._seg_sum(zeroed, torch.as_tensor(every).long())
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["ft_core_failure_resiliency",
                                  "bisection_fat_tree"])
def test_timeline_path_capacity_on_a_fat_tree(name):
    spec = get_scenario(name)
    t = spec.topo
    tl = compile_fault_timeline(spec)
    fa = FlowArrays.build(compile_scenario(spec).flows, t)
    kw = dict(uplink_cap=t.uplink_cap, core_cap=t.core_cap,
              cores_per_agg=t.n_cores // t.n_aggs,
              leaves_per_pod=t.leaves_per_pod)
    for b in tl.change_slots():
        got = timeline_path_capacity(tl, b, fa.src_leaf, fa.dst_leaf, **kw)
        want = jx_path_cap(tl, b, fa.src_leaf, fa.dst_leaf, **kw)
        assert got.shape == (len(fa), t.n_planes, t.n_cores)
        np.testing.assert_array_equal(got, want)
    assert len(tl.change_slots()) > 1


def test_operands_carry_the_stage_b_arrays():
    """Stage-B capacities scale by the core capacity, the ECMP link
    capacities stack A-up, A-down, B-up and B-down in the plan's row
    order, and each flow's stage-B links index (P, pods, C)."""
    spec = get_scenario("ft_core_failure_resiliency").with_sim(
        routing="ecmp")
    c = compile_scenario(spec)
    cfg, fa, ops = engine.prepare(c, "cpu", torch.float64)
    tl = compile_fault_timeline(spec)
    b = list(tl.change_slots())
    np.testing.assert_array_equal(ops.up2.numpy(), tl.up2[b] * cfg.core_cap)
    n = len(b)
    np.testing.assert_array_equal(
        ops.link_cap.numpy(), np.concatenate(
            [x.reshape(n, cfg.n_planes, -1).numpy()
             for x in (ops.up, ops.down, ops.up2, ops.down2)], -1))
    assert ops.link_cap.shape[-1] == engine._plan_rows(cfg)
    P, pods, C = cfg.n_planes, cfg.n_pods, cfg.n_cores
    a = ops.assign.long()
    p = torch.arange(P)[None, None, :]
    lpp = cfg.leaves_per_pod
    src = (ops.fb.src_leaf // lpp)[None, :, None]
    assert torch.equal(ops.ecmp_up2, (p * pods + src) * C + a)
    assert torch.equal(ops.cross[:, 0], ops.fb.src_leaf // lpp
                       != ops.fb.dst_leaf // lpp)
    assert ops.vup is ops.up and ops.vdown2 is ops.down2


# ---------------------------------------------------------------------------
# the slot engine against the references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routing", ["ar", "war", "ecmp"])
@pytest.mark.parametrize("name", FAT_TREE)
def test_fat_tree_matches_the_references(name, routing):
    rspec, rc, ref_np, ref_jx = _run_refs(name, slots=SLOTS[name],
                                          routing=routing)
    port = _run_port(name, slots=SLOTS[name], routing=routing)
    assert port[2].util_up_last.shape == (
        rspec.topo.n_planes, rspec.topo.n_leaves, rspec.topo.n_aggs)
    _assert_parity(port, (rspec, rc, ref_np))
    _assert_parity(port, (rspec, rc, ref_jx))


@pytest.mark.parametrize("name,nic", [
    ("ft_cross_pod_all2all", "spx"), ("ft_core_failure_resiliency", "swlb"),
    ("bisection_fat_tree[ecmp]", "dcqcn")])
def test_fat_tree_kernel_calls_per_slot(monkeypatch, name, nic):
    """A fat-tree slot calls each kernel wrapper once, as a leaf-spine
    slot does: bottleneck_many takes the six (cap, load) pairs of both
    stages and both access directions under AR/WAR (two under ECMP,
    whose fabric links bucket_load_bottleneck scales), queue_update_many
    the four queues of both stages."""
    calls, widths = {}, {}
    for fn in ("plane_split", "pair_fractions", "bottleneck_many",
               "bucket_load_bottleneck", "queue_update_many", "nic_update"):
        def counted(*args, _fn=fn, _orig=getattr(engine, fn), **kw):
            calls[_fn] = calls.get(_fn, 0) + 1
            if _fn.endswith("_many"):
                widths.setdefault(_fn, set()).add(len(args[0]))
            return _orig(*args, **kw)
        monkeypatch.setattr(engine, fn, counted)
    base, sim = _split(name)
    _run_port(base, slots=20, nic=nic, **sim)
    route = ("bucket_load_bottleneck" if sim.get("routing") == "ecmp"
             else "pair_fractions")
    assert calls == dict.fromkeys(
        ("plane_split", route, "bottleneck_many", "queue_update_many",
         "nic_update"), 20)
    assert widths == {"bottleneck_many": {2 if route.startswith("bucket")
                                          else 6},
                      "queue_update_many": {4}}


def _jax_steps(rspec, k):
    """The reference engine's fat-tree carry after slots 0..k-1 and after
    slot k, and the numpy operands it ran on."""
    rc = jx_compile(rspec)
    cfg, fa, tl, pm, _ = jx_engine._prepared(rc)
    cfg = dataclasses.replace(cfg, agg_mode="dense")
    boundaries = tuple(tl.change_slots())
    segs = jx_engine._assign_for(cfg, fa, tl, rc.cfg.seed, boundaries)
    aggs = jx_engine._aggs_for(cfg, fa, segs,
                               jx_engine._agg_widths(cfg, fa, segs))
    caps = jx_engine._seg_caps(tl, boundaries)
    vis = jx_engine._vis_seg_caps(None, boundaries, cfg.n_planes)
    seg_id = jx_engine._seg_id(boundaries, cfg.slots)
    fb = JxFlowBatch.from_arrays(fa)
    operands = [jnp.asarray(a) for a in
                caps + (jx_engine._seg_dem(pm, boundaries),) + vis]
    jaggs = jax.tree_util.tree_map(jnp.asarray, aggs)
    step = jax.jit(partial(
        jx_engine._slot_step, cfg, fb,
        fb.src_leaf * cfg.n_leaves + fb.dst_leaf,
        jaggs, jnp.asarray(segs), *operands, None,
        lambda seg: jaggs.ecmp_load[seg]))
    carry = jx_init_carry(fb, cfg)
    for t in range(k):
        carry, _ = step(carry, (t, seg_id[t]))
    nxt, total = step(carry, (k, seg_id[k]))
    return (fa, aggs, segs, caps, seg_id), carry, nxt, total


@pytest.mark.parametrize("name,k", [
    ("ft_core_failure_resiliency", 130),           # after the core kills
    ("ft_cross_pod_all2all", 40),
    ("bisection_fat_tree[ecmp]", 170),             # after random kills
    ("ft_core_failure_resiliency[ar]", 270)])      # after the heal
def test_slot_handover(name, k):
    """The JAX engine's state after slot k (stage-B queues included),
    handed to the port's `_slot_step`: slot k+1 equals the reference's
    within 1e-12 relative, completion and NIC state exactly.  This is
    the check that the port's ordered sums (products, then left-to-right
    adds over the destination leaf, an agg's cores and a pod's leaves)
    follow the reference's einsums and reshaped sums at these widths."""
    base, sim = _split(name)
    rspec = jx_get(base).with_sim(slots=k + 5, **sim)
    with jax.enable_x64(True):
        (fa, aggs, segs, caps, seg_id), carry_k, want, want_total = \
            _jax_steps(rspec, k)
        carry_k = jax.tree_util.tree_map(np.asarray, carry_k)
        want = jax.tree_util.tree_map(np.asarray, want)
    c = compile_scenario(get_scenario(base).with_sim(slots=k + 5, **sim))
    cfg, _, own = engine.prepare(c, "cpu", torch.float64)
    up, down, acc, up2, down2 = caps
    ops = operands_from_numpy(cfg, fa, aggs, up, down, acc, seg_id,
                              assign=segs, seg_up2=up2, seg_down2=down2,
                              device="cpu", dtype=torch.float64)
    for a, b in zip(ops, own):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    carry = carry_from_numpy(carry_k, device="cpu", dtype=torch.float64)
    assert carry.q2_up.shape == (cfg.n_planes, cfg.n_pods, cfg.n_cores)
    got, total = engine._slot_step(cfg, ops, carry, k)

    def close(g, w, what):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-15,
                                   err_msg=what)

    for f in ("q_up", "q_down", "q2_up", "q2_down", "remaining",
              "goodput_sum", "util_up"):
        close(getattr(got, f), getattr(want, f), f)
    close(got.nic.rate, want.nic.rate, "rate")
    for f in ("probe_miss", "eligible", "pending_fail"):
        np.testing.assert_array_equal(getattr(got.nic, f).numpy(),
                                      getattr(want.nic, f), err_msg=f)
    np.testing.assert_array_equal(got.done.numpy(), want.done)
    np.testing.assert_array_equal(got.completion.numpy(), want.completion)
    assert float(total) == pytest.approx(float(want_total), rel=1e-12)
    assert bool((got.q2_up > 0).any() | (got.q_up > 0).any()) or k < 50


def test_leaf_spine_carry_has_no_stage_b_queues():
    """A leaf-spine carry keeps no stage-B placeholder, and a reference
    carry's placeholders are not handed over."""
    c = compile_scenario(get_scenario("fig11_degraded_leaf").with_sim(
        slots=4))
    cfg, _, ops = engine.prepare(c, "cpu", torch.float64)
    carry = engine.init_carry(ops.fb, cfg)
    assert carry.q2_up is None and carry.q2_down is None
    nxt, _ = engine._slot_step(cfg, ops, carry, 0)
    assert nxt.q2_up is None and ops.up2 is None
    fat = engine.prepare(compile_scenario(get_scenario(
        "ft_cross_pod_all2all").with_sim(slots=4)), "cpu", torch.float64)
    carry = engine.init_carry(fat[2].fb, fat[0])
    assert carry.q2_down.shape == (1, 2, 8)


# ---------------------------------------------------------------------------
# the replay structure the CUDA loop captures, stepped on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ft_core_failure_resiliency",
                                  "ft_core_failure_resiliency[ecmp]",
                                  "bisection_fat_tree[ar]"])
def test_replay_structure_equals_eager_loop(name):
    """`SlotLoop` stepped without capture: the stage-B queues ride in
    the static carry buffers, and every output and the final carry
    equal the eager loop's bit for bit (three segments on the core-kill
    scenario)."""
    base, sim = _split(name)
    spec = get_scenario(base).with_sim(slots=SLOTS[base], **sim)
    cfg, fa, ops = engine.prepare(compile_scenario(spec), "cpu",
                                  torch.float64)
    carry = engine.init_carry(ops.fb, cfg)
    totals = ops.fb.demand.new_empty(cfg.slots)
    for t in range(cfg.slots):
        carry, totals[t] = engine._slot_step(cfg, ops, carry, t)
    want = engine._results(cfg, carry, totals)
    loop = engine.slot_loop(cfg, ops)
    loop.run()
    got = engine._results(cfg, loop.carry, *loop.series)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    for g, w in zip(_leaves(loop.carry), _leaves(carry), strict=True):
        assert torch.equal(g, w)
    assert loop.carry.q2_up.shape == (cfg.n_planes, cfg.n_pods,
                                      cfg.n_cores)
    assert len(set(ops.seg_id.tolist())) == len(
        compile_fault_timeline(spec).change_slots())
