"""The PyTorch port's slot engine on the CPU, held to both reference
engines of the JAX package.

`repro_torch`'s `run_compiled(..., device="cpu")` runs the plain PyTorch
path in float64.  It must match `CompiledScenario.run(backend="numpy")`
and `run(backend="jax")` (under `jax.enable_x64(True)`) with the contract
of `tests/test_jx_parity.py::_assert_parity`: goodput, utilization and
total-goodput series within 1e-5, completion slots exactly equal, and
equal distilled metric rows.  Tier-1 covers fig9_victim_noise at 80 slots
across ar|war|ecmp x spx|dcqcn|global|esr|swlb, fig11_degraded_leaf and
fig12_plane_flap at full length, and fig12_plane_flap and
cascading_spine_loss under ECMP at full length (capacity changes
mid-run; the spine cascade makes the ECMP re-hash draw).  The
full-length registry cross and the giga-scale point under ECMP and
under AR are marked `slow`.

`test_slot_handover` hands the JAX engine's state after slot k to the
port's `_slot_step` (through `carry_from_numpy` / `operands_from_numpy`)
and compares slot k+1 alone: the tool for locating a fork.
"""
import dataclasses
import importlib.util
import json
import math
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim.jx import engine as jx_engine
from repro.netsim.jx.state import FlowBatch as JxFlowBatch
from repro.netsim.jx.state import init_carry as jx_init_carry
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import distill_metrics as jx_distill
from repro.scenarios import get_scenario as jx_get
from repro.scenarios import list_scenarios as jx_list
from repro_torch.kernels import build
from repro_torch.netsim import engine
from repro_torch.netsim.carry import carry_from_numpy, operands_from_numpy
from repro_torch.scenarios import compile_scenario, distill_metrics, \
    get_scenario, run_point

TOL = 1e-5
NICS = ("spx", "dcqcn", "global", "esr", "swlb")


def _split(name):
    """`name[routing]` -> (name, {"routing": routing}); plain names
    pass with no override."""
    if name.endswith("]"):
        base, routing = name[:-1].split("[")
        return base, {"routing": routing}
    return name, {}


def _run_refs(name, **sim):
    spec = jx_get(name).with_sim(**sim) if sim else jx_get(name)
    with jax.enable_x64(True):
        return (spec, jx_compile(spec),
                jx_compile(spec).run(backend="numpy"),
                jx_compile(spec).run(backend="jax"))


def _run_port(name, dtype=torch.float64, **sim):
    spec = get_scenario(name).with_sim(**sim) if sim else \
        get_scenario(name)
    c = compile_scenario(spec)
    return spec, c, c.run(device="cpu", dtype=dtype)


def _assert_rows_equal(got, want):
    """Distilled `ScenarioMetrics` rows, field by field (floats 1e-5)."""
    g, w = got.to_dict(), want.to_dict()
    assert set(g) == set(w)
    for k in w:
        if isinstance(w[k], float):
            assert (math.isnan(g[k]) and math.isnan(w[k])) or \
                g[k] == pytest.approx(w[k], abs=TOL), k
        elif isinstance(w[k], dict):
            assert g[k].keys() == w[k].keys(), k
            for t in w[k]:
                assert g[k][t] == pytest.approx(w[k][t], abs=TOL), (k, t)
        else:
            assert g[k] == w[k], k


def _assert_parity(port, ref):
    """`_assert_parity`'s contract: port = (spec, compiled, result) of
    this package, ref = (spec, compiled, result) of the reference."""
    spec, c, got = port
    rspec, rc, want = ref
    np.testing.assert_allclose(got.mean_goodput, want.mean_goodput,
                               atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got.completion_slot,
                                  want.completion_slot)
    np.testing.assert_allclose(got.total_goodput, want.total_goodput,
                               atol=TOL * len(want.mean_goodput), rtol=TOL)
    np.testing.assert_allclose(got.util_up_last, want.util_up_last,
                               atol=TOL, rtol=TOL)
    assert got.groups == want.groups
    np.testing.assert_array_equal(got.group_of, want.group_of)
    _assert_rows_equal(distill_metrics(spec, c, got),
                       jx_distill(rspec, rc, want))


@pytest.mark.parametrize("routing", ["ar", "war", "ecmp"])
@pytest.mark.parametrize("nic", NICS)
def test_fig9_routing_nic_cross(routing, nic):
    rspec, rc, ref_np, ref_jx = _run_refs("fig9_victim_noise", slots=80,
                                          routing=routing, nic=nic)
    port = _run_port("fig9_victim_noise", slots=80, routing=routing,
                     nic=nic)
    assert port[2].device == "cpu"
    _assert_parity(port, (rspec, rc, ref_np))
    _assert_parity(port, (rspec, rc, ref_jx))


@pytest.mark.parametrize("name", ["fig11_degraded_leaf",
                                  "fig12_plane_flap"])
def test_registry_full_length(name):
    rspec, rc, ref_np, ref_jx = _run_refs(name)
    port = _run_port(name)
    _assert_parity(port, (rspec, rc, ref_np))
    _assert_parity(port, (rspec, rc, ref_jx))


@pytest.mark.parametrize("name", ["fig12_plane_flap",
                                  "cascading_spine_loss"])
def test_ecmp_full_length(name):
    rspec, rc, ref_np, ref_jx = _run_refs(name, routing="ecmp")
    port = _run_port(name, routing="ecmp")
    _assert_parity(port, (rspec, rc, ref_np))
    _assert_parity(port, (rspec, rc, ref_jx))


def test_run_point_distills_the_reference_row():
    spec = get_scenario("fig12_plane_flap").with_sim(slots=120)
    rspec = jx_get("fig12_plane_flap").with_sim(slots=120)
    rc = jx_compile(rspec)
    _assert_rows_equal(run_point(spec, device="cpu"),
                       jx_distill(rspec, rc, rc.run(backend="numpy")))


def test_run_point_distills_the_reference_row_under_ecmp():
    spec = get_scenario("cascading_spine_loss").with_sim(routing="ecmp",
                                                         slots=200)
    rspec = jx_get("cascading_spine_loss").with_sim(routing="ecmp",
                                                    slots=200)
    rc = jx_compile(rspec)
    row = run_point(spec, device="cpu")
    assert row.routing == "ecmp"
    _assert_rows_equal(row, jx_distill(rspec, rc, rc.run(backend="numpy")))


def test_float32_fast_mode_tracks_float64():
    _, _, r64 = _run_port("fig11_degraded_leaf", slots=120)
    _, c, r32 = _run_port("fig11_degraded_leaf", dtype=torch.float32,
                          slots=120)
    assert r32.mean_goodput.dtype == np.float32
    assert np.isfinite(r32.mean_goodput).all()
    assert r32.mean_goodput.shape == (len(c.flows),)
    np.testing.assert_allclose(r32.mean_goodput, r64.mean_goodput,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# per-slot kernel calls, as the GPU path makes them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,nic", [("fig11_degraded_leaf", "spx"),
                                      ("fig12_plane_flap", "dcqcn"),
                                      ("fig9_victim_noise", "global"),
                                      ("fig12_plane_flap[ecmp]", "swlb"),
                                      ("fig11_degraded_leaf[ecmp]", "esr")])
def test_kernel_calls_per_slot(monkeypatch, name, nic):
    """Every AR/WAR slot calls plane_split, pair_fractions,
    bottleneck_many (up, down and both access links in one launch),
    queue_update x2 and nic_update once each; every ECMP slot
    plane_split, bucket_load_bottleneck, bottleneck_many (both access
    links), queue_update x2 and nic_update once each — with contiguous
    tensors (the CUDA wrappers refuse anything else)."""
    calls = {}

    def tensors(args):
        for a in args:
            if isinstance(a, (tuple, list)):
                yield from tensors(a)
            elif isinstance(a, torch.Tensor):
                yield a

    for fn in ("plane_split", "pair_fractions", "bottleneck_many",
               "bucket_load_bottleneck", "queue_update", "nic_update"):
        def counted(*args, _fn=fn, _orig=getattr(engine, fn), **kw):
            assert all(a.is_contiguous() for a in tensors(args)), _fn
            calls[_fn] = calls.get(_fn, 0) + 1
            return _orig(*args, **kw)
        monkeypatch.setattr(engine, fn, counted)
    slots = 30
    base, sim = _split(name)
    _run_port(base, slots=slots, nic=nic, **sim)
    if sim.get("routing") == "ecmp":
        want = {"plane_split": slots, "bucket_load_bottleneck": slots,
                "bottleneck_many": slots}
    else:
        want = {"plane_split": slots, "pair_fractions": slots,
                "bottleneck_many": slots}
    assert calls == dict(want, queue_update=2 * slots, nic_update=slots)


# ---------------------------------------------------------------------------
# single-slot handover from the JAX engine
# ---------------------------------------------------------------------------

def _jax_steps(rspec, k):
    """The reference engine's carry after slots 0..k-1 and after slot k,
    plus the numpy operands it ran on."""
    rc = jx_compile(rspec)
    cfg, fa, tl, pm, _ = jx_engine._prepared(rc)
    cfg = dataclasses.replace(cfg, agg_mode="dense")
    boundaries = tuple(sorted(set(tl.change_slots())
                              | set(jx_engine.phase_boundaries(pm))))
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


@pytest.mark.parametrize("name,nic,k", [
    ("fig11_degraded_leaf", "spx", 37),
    ("fig12_plane_flap", "swlb", 55),
    ("fig9_victim_noise", "dcqcn", 21),
    ("cascading_spine_loss[ecmp]", "spx", 185)])   # after two spine kills
def test_slot_handover(name, nic, k):
    base, sim = _split(name)
    rspec = jx_get(base).with_sim(nic=nic, slots=k + 5, **sim)
    with jax.enable_x64(True):
        (fa, aggs, segs, caps, seg_id), carry_k, want, want_total = \
            _jax_steps(rspec, k)
        carry_k = jax.tree_util.tree_map(np.asarray, carry_k)
        want = jax.tree_util.tree_map(np.asarray, want)
    c = compile_scenario(get_scenario(base).with_sim(nic=nic, slots=k + 5,
                                                     **sim))
    cfg, _, own = engine.prepare(c, "cpu", torch.float64)
    up, down, acc = caps[:3]               # leaf-spine: no stage B
    ops = operands_from_numpy(cfg, fa, aggs, up, down, acc, seg_id,
                              assign=segs, device="cpu",
                              dtype=torch.float64)
    for a, b in zip(ops, own):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    got, total = engine._slot_step(
        cfg, ops, carry_from_numpy(carry_k, device="cpu",
                                   dtype=torch.float64), k)

    def close(g, w, what):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-15,
                                   err_msg=what)

    for f in ("q_up", "q_down", "remaining", "goodput_sum", "util_up"):
        close(getattr(got, f), getattr(want, f), f)
    close(got.nic.rate, want.nic.rate, "rate")
    close(got.nic.alpha, want.nic.alpha, "alpha")
    for f in ("probe_miss", "eligible", "pending_fail"):
        np.testing.assert_array_equal(getattr(got.nic, f).numpy(),
                                      getattr(want.nic, f), err_msg=f)
    np.testing.assert_array_equal(got.done.numpy(), want.done)
    np.testing.assert_array_equal(got.completion.numpy(), want.completion)
    assert float(total) == pytest.approx(float(want_total), rel=1e-12)


# ---------------------------------------------------------------------------
# device selection
# ---------------------------------------------------------------------------

def test_entry_points_refuse_cuda_without_gpu(monkeypatch):
    """The default device is CUDA; without a GPU the entry points raise
    rather than quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = get_scenario("fig12_plane_flap").with_sim(slots=8)
    c = compile_scenario(spec)
    for call in (lambda: c.run(), lambda: c.run(device="cuda"),
                 lambda: engine.run_compiled(c),
                 lambda: run_point(spec),
                 lambda: engine.prepare(c, "cuda:0")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# full-length registry cross (slow)
# ---------------------------------------------------------------------------

def _slice():
    """The slice's registry scenarios below giga scale (the giga point
    has its own test)."""
    return sorted(
        n for n in jx_list()
        if jx_get(n).topo.kind == "leaf_spine"
        and jx_get(n).sim.routing in ("ar", "war", "ecmp")
        and jx_get(n).topo.n_hosts < 4096
        and jx_get(n).reaction is None
        and all(w.kind != "schedule" for w in jx_get(n).workloads))


@pytest.mark.slow
@pytest.mark.parametrize("name", _slice())
@pytest.mark.parametrize("routing", ["ar", "war", "ecmp"])
@pytest.mark.parametrize("nic", ["spx", "dcqcn"])
def test_registry_cross_full_length(name, routing, nic):
    """The port is held to the JAX engine everywhere, and to the NumPy
    engine wherever the two references agree (completion slots that sit
    exactly on `remaining <= 0` can differ between them)."""
    rspec, rc, ref_np, ref_jx = _run_refs(name, routing=routing, nic=nic)
    port = _run_port(name, routing=routing, nic=nic)
    _assert_parity(port, (rspec, rc, ref_jx))
    try:
        _assert_parity((rspec, rc, ref_jx), (rspec, rc, ref_np))
    except AssertionError:
        return
    _assert_parity(port, (rspec, rc, ref_np))


@pytest.mark.slow
def test_giga_ecmp_equals_golden_and_numpy():
    """giga_fabric_storage under its own routing (ECMP, SPX, 102,400
    flows, 60 slots): the plain path against the NumPy engine and the
    golden row.  Every ECMP link sum is ordered in both, so the runs
    agree under the strict contract, not only the contained-fork one."""
    spec = get_scenario("giga_fabric_storage")
    port = (spec,) + _run_port("giga_fabric_storage")[1:]
    rspec = jx_get("giga_fabric_storage")
    rc = jx_compile(rspec)
    with jax.enable_x64(True):
        ref_np = rc.run(backend="numpy")
    _assert_parity(port, (rspec, rc, ref_np))
    golden = json.loads((Path(__file__).parent / "golden" /
                         "scenarios.json").read_text())
    _chip_smoke().assert_golden(spec.name,
                                distill_metrics(spec, port[1], port[2]),
                                golden)


@pytest.mark.slow
def test_giga_ar_equals_numpy_and_jax():
    """giga_fabric_storage under AR (SPX, 102,400 flows, 60 slots),
    float64: the plain path that the card's kernels are held against,
    held in turn to the NumPy engine and to the JAX engine under the
    strict contract.  AR's leaf-pair sums are ordered in all three."""
    spec = get_scenario("giga_fabric_storage").with_sim(routing="ar")
    port = (spec,) + _run_port("giga_fabric_storage", routing="ar")[1:]
    rspec, rc, ref_np, ref_jx = _run_refs("giga_fabric_storage",
                                          routing="ar")
    _assert_parity(port, (rspec, rc, ref_np))
    _assert_parity(port, (rspec, rc, ref_jx))


# ---------------------------------------------------------------------------
# chip_smoke.py's checks, on the CPU path
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_contracts_hold_on_cpu(capsys):
    """The golden and parity checks chip_smoke.py applies on the card
    accept the CPU plain path; without a GPU the script prints no
    result and returns non-zero."""
    smoke = _chip_smoke()
    spec = get_scenario("fig12_plane_flap")
    c = compile_scenario(spec)
    res = c.run(device="cpu")
    golden = json.loads((Path(__file__).parent / "golden" /
                         "scenarios.json").read_text())
    smoke.assert_golden(spec.name, distill_metrics(spec, c, res), golden)
    smoke.assert_parity(spec, c, res, res)
    for routing in ("ar", "war", "ecmp"):
        want = smoke.slot_launches(routing, 3)
        counts = {k: want.get(k, 0) for k in build.KERNELS}
        total = {}
        smoke.check_launches("x", counts, want, total)
        assert total == counts
        with pytest.raises(AssertionError):
            smoke.check_launches("x", dict.fromkeys(build.KERNELS, 3), want,
                                 {})
    assert smoke.PER_SLOT["ecmp"] == {
        "plane_split": 1, "bucket_load_bottleneck": 1, "bottleneck": 1,
        "queue_update": 2, "nic_update": 1}
    assert smoke.PER_SLOT["ar"] == {
        "plane_split": 1, "pair_fractions": 1, "bottleneck": 1,
        "queue_update": 2, "nic_update": 1}
    assert set(smoke.REPLACES) == set(build.KERNELS)
    if not torch.cuda.is_available():
        assert smoke.main([]) != 0
        assert capsys.readouterr().out == ""
