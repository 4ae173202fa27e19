"""The PyTorch port's training-step schedules on the CPU, held to the JAX
package.

The port carries its own copies of the architecture registry, the model
parameter layout (init half), the plane and stream accounting and the
schedule compiler (`repro_torch.comms`), so a `WorkloadSpec(kind=
"schedule")` lowers to the reference's flows, demand timeline and
`TrainSchedule`s.  Here: `ARCHS` field for field; `param_shapes` against
`jax.eval_shape(init_params)` key path for key path, full width and
`reduced()`; `logical_axes`; `params_from_jax` bit for bit; the byte
plans of the two registry `ScheduleSpec`s and of the two full-width
ones `chip_smoke.py` runs, exactly; `compile_scenario` of the three
registry schedules and of the full-width dense spec; the three registry
runs under `_assert_parity` against both reference engines (AR, and the
flaps under ECMP and WAR), with exact step times and the golden rows; a
batch and a megabatch that mixes schedule and plain lanes; and the
`train_comms_resiliency` study's rows and signature.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.scenarios.spec as jx_spec
from repro.comms.schedule import grad_chunk_bytes as jx_grad_chunk_bytes
from repro.comms.schedule import moe_a2a_bytes_per_rank as jx_a2a
from repro.comms.schedule import plan_schedule as jx_plan
from repro.configs import ARCHS as JX_ARCHS
from repro.configs import ASSIGNED as JX_ASSIGNED
from repro.configs import SHAPES as JX_SHAPES
from repro.configs import matrix as jx_matrix
from repro.core import planes as jx_planes
from repro.core.collectives import stream_report as jx_stream_report
from repro.core.planes import PlaneConfig as JxPlaneConfig
from repro.experiments import get_experiment as jx_get_experiment
from repro.models.transformer import init_params as jx_init_params
from repro.models.transformer import logical_axes as jx_logical_axes
from repro.netsim.fabric import FlowArrays as JxFlowArrays
from repro.netsim.jx.engine import run_compiled_batch as jx_run_batch
from repro.netsim.jx.megabatch import run_megabatch as jx_run_megabatch
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import distill_metrics as jx_distill
from repro.scenarios import get_scenario as jx_get
from repro_torch.comms.schedule import _itemsize, grad_chunk_bytes, \
    moe_a2a_bytes_per_rank, plan_schedule
from repro_torch.configs import ARCHS, ASSIGNED, SHAPES, get_config, matrix
from repro_torch.core import planes
from repro_torch.core.collectives import stream_report
from repro_torch.core.planes import PlaneConfig
from repro_torch.experiments import get_experiment, run_experiment
from repro_torch.models import (init_params, logical_axes, param_count,
                                param_shapes, params_from_jax, tree_items,
                                tree_leaves)
from repro_torch.netsim import engine, megabatch
from repro_torch.netsim.fabric import FlowArrays
from repro_torch.scenarios import compile_scenario, distill_metrics, \
    get_scenario
from repro_torch.scenarios.spec import WorkloadSpec

from test_torch_engine import _assert_parity, _split

ROOT = Path(__file__).resolve().parents[1]
SCHEDULES = ("train_step_baseline", "train_step_flap", "train_step_flap_moe")
# the flaps under every routing, the baseline under its own AR
RUNS = ("train_step_baseline", "train_step_flap", "train_step_flap[ecmp]",
        "train_step_flap[war]", "train_step_flap_moe",
        "train_step_flap_moe[ecmp]", "train_step_flap_moe[war]")
STEP_TIMES = {"train_step_baseline": [60.0, 60.0, 60.0],
              "train_step_flap": [60.0, 87.0, 64.0],
              "train_step_flap_moe": [120.0, 154.0, 125.0]}


def _chip_smoke():
    path = ROOT / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
GIGA = tuple(SMOKE.GIGA_TRAIN)


def _to_ref(obj):
    """A port spec (dataclasses of `repro_torch.scenarios.spec`) rebuilt
    from the reference's classes of the same names, field for field."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(jx_spec, type(obj).__name__)
        return cls(**{f.name: _to_ref(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_to_ref(x) for x in obj)
    return obj


def _path(jax_path):
    """A `tree_flatten_with_path` key path as the port's tuple of dict
    keys and list indices."""
    return tuple(k.key if hasattr(k, "key") else k.idx for k in jax_path)


# ---------------------------------------------------------------------------
# the architecture registry and the parameter layout
# ---------------------------------------------------------------------------

def test_archs_equal_the_reference():
    assert list(ARCHS) == list(JX_ARCHS) and ASSIGNED == JX_ASSIGNED
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == \
            dataclasses.asdict(JX_ARCHS[name]), name
        get_config(name)                        # validates
        assert ARCHS[name].n_periods == JX_ARCHS[name].n_periods
        assert [ARCHS[name].is_moe_pos(p)
                for p in range(ARCHS[name].pattern_len)] == \
            [JX_ARCHS[name].is_moe_pos(p)
             for p in range(JX_ARCHS[name].pattern_len)]
        assert dataclasses.asdict(ARCHS[name].reduced()) == \
            dataclasses.asdict(JX_ARCHS[name].reduced())
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JX_SHAPES.items()}
    assert matrix() == jx_matrix()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-nope")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", list(JX_ARCHS))
def test_param_shapes_equal_eval_shape(name, reduced):
    """Key paths (in `jax.tree.leaves` order), shapes and dtypes of every
    leaf, with no memory behind them."""
    cfg = ARCHS[name].reduced() if reduced else ARCHS[name]
    jcfg = JX_ARCHS[name].reduced() if reduced else JX_ARCHS[name]
    ref = jax.eval_shape(lambda k: jx_init_params(k, jcfg),
                         jax.random.PRNGKey(0))
    want = [(_path(p), tuple(leaf.shape), str(leaf.dtype)) for p, leaf in
            jax.tree_util.tree_flatten_with_path(ref)[0]]
    tree = param_shapes(cfg)
    got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in tree_items(tree)]
    assert got == want
    assert all(t.device.type == "meta" for t in tree_leaves(tree))
    assert param_count(tree) == sum(int(np.prod(s)) for _, s, _ in want)


@pytest.mark.parametrize("name", list(JX_ARCHS))
def test_logical_axes_equal_the_reference(name):
    assert logical_axes(ARCHS[name]) == jx_logical_axes(JX_ARCHS[name])


@pytest.mark.parametrize("name", list(JX_ARCHS))
def test_params_from_jax_carries_weights_bit_for_bit(name):
    jcfg = JX_ARCHS[name].reduced()
    ref = jax.device_get(jax.jit(lambda k: jx_init_params(k, jcfg))(
        jax.random.PRNGKey(3)))
    got = params_from_jax(ref, ARCHS[name].reduced(), device="cpu")
    leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    items = list(tree_items(got))
    assert [p for p, _ in items] == [_path(p) for p, _ in leaves]
    for (_, t), (_, a) in zip(items, leaves):
        a = np.asarray(a)
        assert t.device.type == "cpu" and tuple(t.shape) == a.shape
        assert str(t.dtype) == f"torch.{a.dtype.name}"
        assert np.array_equal(t.numpy().view(np.uint32), a.view(np.uint32))


def test_init_params_fills_the_layout(monkeypatch):
    """Real tensors in `param_shapes`' layout: zeros where the reference
    zeros (norm gains, biases, `A_log`), a truncated normal within two
    standard deviations of `scale / sqrt(fan_in)` elsewhere, the same
    draws from the same seed; CUDA by default."""
    cfg = ARCHS["jamba-v0.1-52b"].reduced()
    got = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    again = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    meta = dict(tree_items(param_shapes(cfg)))
    for (path, t), (_, u) in zip(tree_items(got), tree_items(again)):
        assert tuple(t.shape) == tuple(meta[path].shape), path
        assert t.dtype == torch.float32 and torch.equal(t, u)
    ln1 = got["period"][0]["ln1"]
    assert not ln1.any()
    # a stacked leaf's fan-in is its leading (period) axis, as in the
    # reference's builder
    wq = got["period"][4]["mixer"]["wq"]           # (periods, d, H, D)
    assert 0 < float(wq.abs().max()) <= 2.0 / np.sqrt(wq.shape[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)


def test_params_from_jax_refuses_another_layout():
    cfg = ARCHS["llama3-8b"].reduced()
    ref = jax.device_get(jx_init_params(jax.random.PRNGKey(0),
                                        JX_ARCHS["llama3-8b"].reduced()))
    bad_path = dict(ref, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(bad_path, cfg, device="cpu")
    bad_shape = dict(ref, final_ln=np.zeros(65, np.float32))
    with pytest.raises(ValueError, match="final_ln"):
        params_from_jax(bad_shape, cfg, device="cpu")
    bad_dtype = dict(ref, final_ln=np.zeros(64, np.float64))
    with pytest.raises(ValueError, match="float64"):
        params_from_jax(bad_dtype, cfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in ref.items() if k != "embed"},
                        cfg, device="cpu")


def test_bfloat16_leaves_and_itemsizes():
    """A bfloat16 layout carries bfloat16 weights across bit for bit, and
    the schedule's dtype sizes come from torch (numpy has no
    bfloat16)."""
    jcfg = JX_ARCHS["spx-100m"].reduced()
    cfg = dataclasses.replace(ARCHS["spx-100m"].reduced(),
                              param_dtype="bfloat16")
    # the reference's init widens bfloat16 draws (times a float64 std)
    # to float32: its weights cast to the layout's dtype
    ref = jax.device_get(jax.tree.map(
        lambda a: a.astype(jax.numpy.bfloat16),
        jx_init_params(jax.random.PRNGKey(1), jcfg)))
    got = params_from_jax(ref, cfg, device="cpu")
    for t, a in zip(tree_leaves(got), jax.tree.leaves(ref)):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(a).view(np.int16))
    assert (_itemsize("bfloat16"), _itemsize("float32")) == (2, 4)


# ---------------------------------------------------------------------------
# planes and stream accounting
# ---------------------------------------------------------------------------

def test_planes_equal_the_reference():
    rng = np.random.default_rng(7)
    for P, k in ((1, 16), (2, 16), (4, 37), (8, 64)):
        w = rng.random(P)
        w[rng.integers(P)] = 0.0
        a = planes.apportion(w, k)
        np.testing.assert_array_equal(a, jx_planes.apportion(w, k))
        cb = rng.random(k) * 1e6
        np.testing.assert_array_equal(planes.plane_loads(a, P, cb),
                                      jx_planes.plane_loads(a, P, cb))
        rate = rng.random(P) + 0.1
        assert planes.effective_bandwidth(w, a, rate) == \
            jx_planes.effective_bandwidth(w, a, rate)
    with pytest.raises(AssertionError):
        PlaneConfig(n_planes=4, microchunks=2)


@pytest.mark.parametrize("name", ["llama3-8b", "jamba-v0.1-52b",
                                  "deepseek-v2-236b"])
def test_stream_report_equals_the_reference(name):
    """Chunk sizes, the LPT plane assignment and bytes per plane of the
    full-width model, under uniform and skewed PLB weights."""
    ref = jax.eval_shape(lambda k: jx_init_params(k, JX_ARCHS[name]),
                         jax.random.PRNGKey(0))
    for w in (None, np.array([0.5, 0.3, 0.2, 0.0])):
        got = stream_report(param_shapes(ARCHS[name]),
                            PlaneConfig(n_planes=4), w)
        want = jx_stream_report(ref, JxPlaneConfig(n_planes=4), w)
        for f in ("chunk_bytes", "assignment", "bytes_per_plane"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


# ---------------------------------------------------------------------------
# the schedule plans
# ---------------------------------------------------------------------------

def _plan_cases():
    """(label, ScheduleSpec, slot_us, slots, planes): the two registry
    schedules and the two full-width ones."""
    out = []
    for name in ("train_step_flap", "train_step_flap_moe") + GIGA:
        spec = SMOKE.scenario(name)
        out.append((name, spec.workloads[0].schedule, spec.sim.slot_us,
                    spec.sim.slots, spec.topo.n_planes))
    return out


@pytest.mark.parametrize("label,ss,slot_us,slots,P", _plan_cases(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_schedule_plans_equal_the_reference(label, ss, slot_us, slots, P):
    jss = _to_ref(ss)
    cfg = get_config(ss.model).reduced() if ss.reduced else \
        get_config(ss.model)
    jcfg = JX_ARCHS[ss.model].reduced() if ss.reduced else JX_ARCHS[ss.model]
    np.testing.assert_array_equal(grad_chunk_bytes(cfg, P),
                                  jx_grad_chunk_bytes(jcfg, P))
    assert moe_a2a_bytes_per_rank(cfg, ss) == jx_a2a(jcfg, jss)
    got = plan_schedule(ss, slot_us, slots, n_planes=P)
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jx_plan(jss, slot_us, slots, n_planes=P))
    need = got.step_starts[-1] + got.step_period
    with pytest.raises(ValueError, match=f"needs {need} slots"):
        plan_schedule(ss, slot_us, need - 1, n_planes=P)


def test_full_width_plans_have_the_published_volumes():
    """llama3-8b's f32 gradients are 32,121,044,992 bytes in 192 chunks
    and phi3.5-moe's 167,490,109,440 in 208 (2 planes); the giga
    schedules' windows follow."""
    want = {"giga_train_llama3_8b": (32_121_044_992, 192, (14, 28, 800)),
            "giga_train_phi35_moe": (167_490_109_440, 208, (139, 278, 406))}
    for label, ss, slot_us, slots, P in _plan_cases()[2:]:
        b = grad_chunk_bytes(get_config(ss.model), P)
        plan = plan_schedule(ss, slot_us, slots, n_planes=P)
        assert (int(b.sum()), len(b),
                (plan.w_fwd, plan.w_bwd, plan.w_sync)) == want[label]


# ---------------------------------------------------------------------------
# compiled schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCHEDULES + GIGA[:1])
def test_compiled_schedules_equal_the_reference(name):
    spec = SMOKE.scenario(name)
    ref_spec = jx_get(name) if name in SCHEDULES else _to_ref(spec)
    assert dataclasses.asdict(_to_ref(spec)) == dataclasses.asdict(ref_spec)
    c, rc = compile_scenario(spec), jx_compile(ref_spec)
    fa, rfa = FlowArrays.build(c.flows, c.topo), \
        JxFlowArrays.build(rc.flows, rc.topo)
    for f in ("src", "dst", "src_leaf", "dst_leaf", "demand",
              "bytes_total", "group", "start_slot", "phase"):
        np.testing.assert_array_equal(getattr(fa, f), getattr(rfa, f),
                                      err_msg=f)
    assert fa.groups == rfa.groups
    np.testing.assert_array_equal(c.phase_mult, rc.phase_mult)
    assert len(c.schedules) == len(rc.schedules) == 1
    got, want = (dataclasses.asdict(x.schedules[0]) for x in (c, rc))
    for f in want:
        assert got[f] == want[f], f
    assert c.fault_slots == rc.fault_slots


def test_stacked_schedules_share_lane_zero():
    """Two schedule workloads stack their timelines column-wise after
    the shared always-1.0 lane, each rebased onto the global flow list,
    as the reference stacks them."""
    def two(get, W):
        s = get("train_step_flap")
        w = s.workloads[0]
        return dataclasses.replace(
            s, name="two_schedules", workloads=(w, dataclasses.replace(
                w, schedule=dataclasses.replace(w.schedule, dp=2,
                                                ckpt_every=0))))
    c = compile_scenario(two(get_scenario, WorkloadSpec))
    rc = jx_compile(two(jx_get, jx_spec.WorkloadSpec))
    assert c.phase_mult.shape == (260, 7)
    np.testing.assert_array_equal(c.phase_mult, rc.phase_mult)
    assert [dataclasses.asdict(x) for x in c.schedules] == \
        [dataclasses.asdict(x) for x in rc.schedules]
    assert [f.phase for f in c.flows] == [f.phase for f in rc.flows]


# ---------------------------------------------------------------------------
# runs against both reference engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", RUNS)
def test_schedule_runs_match_both_engines(name):
    """`_assert_parity` against the NumPy and the JAX engine (x64), the
    step times exactly (the study's signature on the flaps) and, under
    the registry's own routing, the golden row."""
    base, sim = _split(name)
    rspec = jx_get(base).with_sim(**sim)
    spec = get_scenario(base).with_sim(**sim)
    with jax.enable_x64(True):
        rc = jx_compile(rspec)
        refs = [jx_compile(rspec).run(backend=b) for b in ("numpy", "jax")]
    c = compile_scenario(spec)
    got = c.run(device="cpu")
    st = c.schedules[0].step_times(got.completion_slot, spec.sim.slots)
    assert st.tolist() == STEP_TIMES[base]
    for ref in refs:
        _assert_parity((spec, c, got), (rspec, rc, ref))
        np.testing.assert_array_equal(st, rc.schedules[0].step_times(
            np.asarray(ref.completion_slot), spec.sim.slots))
    if "flap" in base:
        assert st[1] >= 1.2 * st[0] and st[2] <= 1.1 * st[0]
    if not sim:
        golden = json.loads((ROOT / "tests/golden/scenarios.json")
                            .read_text())
        SMOKE.assert_golden(base, distill_metrics(spec, c, got), golden)


def test_batch_of_schedule_points_matches_the_reference():
    """Three seeds of the MoE flap under ECMP as one batch: each lane
    equal to the reference's batch under `_assert_parity`, and to its
    own single run."""
    seeds = (0, 1, 2)
    specs = [get_scenario("train_step_flap_moe").with_sim(routing="ecmp",
                                                          seed=s)
             for s in seeds]
    rspecs = [jx_get("train_step_flap_moe").with_sim(routing="ecmp", seed=s)
              for s in seeds]
    with jax.enable_x64(True):
        rcs = [jx_compile(s) for s in rspecs]
        refs = jx_run_batch(rcs)
    cs = [compile_scenario(s) for s in specs]
    got = engine.run_compiled_batch(cs, device="cpu")
    for s, c, g, rs, rc, r in zip(specs, cs, got, rspecs, rcs, refs):
        _assert_parity((s, c, g), (rs, rc, r))
        alone = c.run(device="cpu")
        np.testing.assert_array_equal(g.completion_slot,
                                      alone.completion_slot)
        np.testing.assert_array_equal(g.mean_goodput, alone.mean_goodput)


def test_megabatch_mixes_schedule_and_plain_lanes():
    """Schedule points and a plain point of the same fabric and flow
    bucket share one slot loop a (routing, NIC) (the plain lane reads
    1.0 in every timeline lane), each row equal to the reference's
    `run_megabatch` and bit-equal to its single run."""
    def plain(get, W):
        return dataclasses.replace(get("train_step_flap"),
                                   name="train_topo_all2all",
                                   workloads=(W("all2all", demand=0.5),))
    specs = [get_scenario("train_step_baseline"),
             get_scenario("train_step_flap"),
             plain(get_scenario, WorkloadSpec),
             get_scenario("train_step_flap").with_sim(routing="war", seed=5)]
    rspecs = [jx_get("train_step_baseline"), jx_get("train_step_flap"),
              plain(jx_get, jx_spec.WorkloadSpec),
              jx_get("train_step_flap").with_sim(routing="war", seed=5)]
    with jax.enable_x64(True):
        rcs = [jx_compile(s) for s in rspecs]
        refs = jx_run_megabatch([jx_compile(s) for s in rspecs])
    cs = [compile_scenario(s) for s in specs]
    engine.reset_dispatch_stats()
    got = megabatch.run_megabatch(cs, device="cpu")
    assert engine.dispatch_stats()["loops"] == 2           # ar, war
    for s, c, g, rs, rc, r in zip(specs, cs, got, rspecs, rcs, refs):
        _assert_parity((s, c, g), (rs, rc, r))
        alone = c.run(device="cpu")
        for f in ("mean_goodput", "completion_slot", "util_up_last"):
            np.testing.assert_array_equal(getattr(g, f), getattr(alone, f))
        np.testing.assert_allclose(g.total_goodput, alone.total_goodput,
                                   rtol=1e-12, atol=0)
    lanes = next(megabatch.prepare_planned(
        megabatch.plan_megabatch(cs)[1][0], {})).lanes
    assert [ln.cfg.n_phases for ln in lanes] == [4, 4, 4]


def test_train_comms_resiliency_rows_and_signature():
    """The study through `run_experiment` on the CPU: rows equal to the
    reference's NumPy engine with its derive hook (1e-5, step times
    exactly), the flapped steps inflated >= 1.2x and the last step back
    within 1.1x."""
    rs = run_experiment(get_experiment("train_comms_resiliency"),
                        device="cpu")
    jexp = jx_get_experiment("train_comms_resiliency")
    rows = rs.to_metrics()
    for p, got in zip(jexp.points(), rows):
        c = jx_compile(p.spec)
        with jax.enable_x64(True):
            r = c.run(backend="numpy")
        want = jx_distill(p.spec, c, r)
        want.extra.update(jexp.derive(p.spec, c, r))
        assert got.extra == want.extra
        assert got.extra["step_time_slots"] == STEP_TIMES[got.scenario]
        np.testing.assert_allclose(got.mean_goodput, want.mean_goodput,
                                   rtol=1e-5, atol=1e-5)
    flaps = {r.scenario: r.extra for r in rows if "flap" in r.scenario}
    assert len(flaps) == 2
    for x in flaps.values():
        assert x["step_inflation"] >= 1.2 and x["last_step_ratio"] <= 1.1
