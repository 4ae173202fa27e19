"""Failure reaction in the PyTorch port, held to the JAX package.

Under a `ReactionSpec`, routing steers against a routing-visible copy of
the fabric that lags the physical one by the detection (and, for
`mode="rehash"`, convergence) delay: AR/WAR score paths on the visible
capacities and deliver on the physical ones, ECMP's assignment replay
checks dead paths on the visible timeline (re-hashing, or walking the
fast-reroute backup table), and every slot reports the bytes offered
onto physically dead paths.  The port's lowering (`lagged_timeline`,
`poisson_flap_schedule` and its `poisson_flaps` draws, the backup table
and its walk) must equal the reference's arrays; its CPU engine must
match both reference engines under `_assert_parity`, blackhole series
included, on the three registry reaction scenarios and across reaction
modes; and `distill_metrics` must give the reference's
`blackholed_bytes` and `reaction_slots`.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.fault_tolerance import poisson_flaps as jx_poisson_flaps
from repro.netsim.jx.events import compile_fault_timeline as jx_timeline
from repro.netsim.jx.events import lagged_timeline as jx_lagged
from repro.netsim.sim import backup_reassign as jx_backup_reassign
from repro.netsim.topology import backup_path_table as jx_backup_table
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import distill_metrics as jx_distill
from repro.scenarios import get_scenario as jx_get
from repro.scenarios.compile import poisson_flap_schedule as jx_schedule
from repro.scenarios.runner import _reaction_slots as jx_reaction_slots
from repro.scenarios.spec import ReactionSpec as JxReactionSpec
from repro_torch.core.fault_tolerance import poisson_flaps
from repro_torch.netsim import engine
from repro_torch.netsim.events import compile_fault_timeline, \
    lagged_timeline
from repro_torch.netsim.graph import _leaves
from repro_torch.netsim.sim import backup_reassign
from repro_torch.netsim.topology import backup_path_table
from repro_torch.scenarios import compile_scenario, distill_metrics, \
    get_scenario
from repro_torch.scenarios.compile import poisson_flap_schedule
from repro_torch.scenarios.runner import _reaction_slots
from repro_torch.scenarios.spec import ReactionSpec

from test_torch_engine import TOL, _assert_parity, _split

REACTION = ["reroute_random_failures", "poisson_flap_storm",
            "reroute_random_failures_ft"]


def _specs(name, reaction=None, **sim):
    """(reference spec, port spec); `reaction` replaces the registry's
    reaction as (detect_slots, mode, converge_slots)."""
    base, routing = _split(name)
    sim = dict(sim, **routing)
    rs, ps = jx_get(base), get_scenario(base)
    if reaction is not None:
        rs = dataclasses.replace(rs, reaction=JxReactionSpec(*reaction))
        ps = dataclasses.replace(ps, reaction=ReactionSpec(*reaction))
    return (rs.with_sim(**sim), ps.with_sim(**sim)) if sim else (rs, ps)


def _runs(name, reaction=None, **sim):
    """(port, numpy reference, jax reference), each (spec, compiled,
    result)."""
    rspec, spec = _specs(name, reaction, **sim)
    with jax.enable_x64(True):
        rc = jx_compile(rspec)
        ref_np = jx_compile(rspec).run(backend="numpy")
        ref_jx = jx_compile(rspec).run(backend="jax")
    c = compile_scenario(spec)
    return ((spec, c, c.run(device="cpu")), (rspec, rc, ref_np),
            (rspec, rc, ref_jx))


def _assert_blackholes(port, ref):
    got = port[2].blackhole_timeline
    want = np.asarray(ref[2].blackhole_timeline)
    assert got.shape == want.shape == (port[0].sim.slots,)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["reroute_random_failures",
                                  "reroute_random_failures_ft",
                                  "ft_core_failure_resiliency"])
@pytest.mark.parametrize("lag", [1, 2, 62, 399])
def test_lagged_timeline_equals_reference(name, lag):
    tl = compile_fault_timeline(get_scenario(name))
    got, want = lagged_timeline(tl, lag), jx_lagged(tl, lag)
    for field in ("up", "down", "access", "up2", "down2"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.change_slots() == want.change_slots()


@pytest.mark.parametrize("name,edit", [
    ("poisson_flap_storm", {}),
    ("poisson_flap_storm", {"plane": 0, "stop_slot": 300}),
    ("poisson_flap_storm", {"start_slot": 399}),
    ("poisson_flap_storm", {"start_slot": 400}),
    ("ft_cross_pod_all2all", {})])
def test_poisson_flap_schedule_equals_reference(name, edit):
    """The schedule tuple draw for draw, on the registry's storm, on one
    plane of a shorter window, on windows of one slot and none, and on a
    fat tree (leaf-agg links, then pod-core links)."""
    rs, ps = jx_get(name), get_scenario(name)
    flap = dict(kind="poisson_flap", start_slot=50, flaps_per_min=24000.0,
                down_slots=12, frac=1.0)
    flap.update(edit)
    rf = dataclasses.replace(rs.faults[0], **flap) if rs.faults else None
    if name != "poisson_flap_storm":
        from repro.scenarios.spec import FaultSpec as JxFaultSpec
        from repro_torch.scenarios.spec import FaultSpec
        rs = dataclasses.replace(rs, faults=(JxFaultSpec(**flap),))
        ps = dataclasses.replace(ps, faults=(FaultSpec(**flap),))
    else:
        rs = dataclasses.replace(rs, faults=(rf,))
        ps = dataclasses.replace(ps, faults=(dataclasses.replace(
            ps.faults[0], **edit),))
    got, want = poisson_flap_schedule(ps, 0), jx_schedule(rs, 0)
    assert got == want
    assert all(isinstance(x, int) for row in got for x in row)
    if name == "ft_cross_pod_all2all":
        t = ps.topo
        assert max(link for *_, link in got) >= t.n_leaves * t.n_aggs
    tl, rtl = compile_fault_timeline(ps), jx_timeline(rs)
    for field in ("up", "down", "access", "up2", "down2"):
        g, w = getattr(tl, field), getattr(rtl, field)
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=field)
    assert compile_scenario(ps).fault_slots == jx_compile(rs).fault_slots


@pytest.mark.parametrize("seed,n_links,rate", [(0, 128, 24000.0),
                                               (1, 1, 60.0), (2, 300, 0.0)])
def test_poisson_flaps_draws_equal_reference(seed, n_links, rate):
    got = poisson_flaps(np.random.default_rng(seed), n_links, rate,
                        duration_s=1e-3, horizon_s=0.035)
    want = jx_poisson_flaps(np.random.default_rng(seed), n_links, rate,
                            duration_s=1e-3, horizon_s=0.035)
    assert [(e.link, e.t_down, e.t_up) for e in got] == \
        [(e.link, e.t_down, e.t_up) for e in want]


@pytest.mark.parametrize("kind,n_paths,cpa", [
    ("leaf_spine", 8, 1), ("leaf_spine", 1, 1), ("fat_tree", 8, 2),
    ("fat_tree", 32, 2), ("fat_tree", 8, 1), ("fat_tree", 12, 4)])
def test_backup_path_table_equals_reference(kind, n_paths, cpa):
    got = backup_path_table(kind, n_paths, cores_per_agg=cpa)
    np.testing.assert_array_equal(got, jx_backup_table(kind, n_paths,
                                                       cores_per_agg=cpa))
    assert got.dtype == np.int32
    seen, j = set(), 0
    for _ in range(n_paths):                    # one cycle over every path
        seen.add(j)
        j = int(got[j])
    assert j == 0 and len(seen) == n_paths


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_backup_reassign_equals_reference(seed):
    """Dead assignments walk the chain to the first alive path; rows with
    every path dead keep theirs."""
    rng = np.random.default_rng(seed)
    F, P, J = 300, 2, 8
    alive = rng.random((F, P, J)) < 0.4
    alive[:5] = False
    assign = rng.integers(0, J, (F, P))
    backup = backup_path_table("fat_tree", J, cores_per_agg=2)
    got = backup_reassign(alive, assign, backup)
    np.testing.assert_array_equal(got, jx_backup_reassign(alive, assign,
                                                          backup))
    np.testing.assert_array_equal(got[:5], assign[:5])
    ok = alive.any(-1)
    assert np.take_along_axis(alive, got[:, :, None], 2)[ok].all()


def test_compiled_scenarios_carry_the_backup_table():
    for name in REACTION:
        c, rc = compile_scenario(get_scenario(name)), \
            jx_compile(jx_get(name))
        np.testing.assert_array_equal(c.backup, rc.backup)
        assert c.fault_slots == rc.fault_slots
    rehash = compile_scenario(_specs("reroute_random_failures",
                                     (2, "rehash", 60))[1])
    assert rehash.backup is None


# ---------------------------------------------------------------------------
# the slot engine against the references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", REACTION)
def test_reaction_scenarios_match_the_references(name):
    """The registry's reaction scenarios at full length: the contract of
    `_assert_parity` (blackholed_bytes and reaction_slots among the row's
    fields) and the per-slot blackhole series within 1e-5, against the
    NumPy and the JAX engine."""
    port, ref_np, ref_jx = _runs(name)
    assert port[2].blackhole_timeline is not None
    assert port[2].blackhole_timeline.sum() > 0
    for ref in (ref_np, ref_jx):
        _assert_parity(port, ref)
        _assert_blackholes(port, ref)


@pytest.mark.parametrize("name,reaction", [
    ("reroute_random_failures", (2, "rehash", 60)),
    ("reroute_random_failures_ft", (3, "rehash", 20)),
    ("reroute_random_failures[war]", (2, "backup", 0)),
    ("reroute_random_failures_ft[ar]", (4, "backup", 0)),
    ("poisson_flap_storm[war]", (2, "rehash", 5)),
    ("reroute_random_failures", (0, "backup", 0))])
def test_reaction_modes_match_the_references(name, reaction):
    """Each mode and lag, on both fabrics and all three routings: the
    seeded re-hash after detection and convergence, the backup walk, and
    a zero lag (the visible timeline is the physical one).  The series
    at 220 bytes a flow are held to the JAX engine, and to NumPy where
    the two references agree."""
    port, ref_np, ref_jx = _runs(name, reaction, slots=260)
    _assert_parity(port, ref_jx)
    _assert_blackholes(port, ref_jx)
    try:
        _assert_parity(ref_jx, ref_np)
    except AssertionError:
        return
    _assert_parity(port, ref_np)
    _assert_blackholes(port, ref_np)


def test_distill_metrics_reaction_columns():
    """`blackholed_bytes` is the series' sum and `reaction_slots` the
    longest window from a transition until blackholing stops; both equal
    the reference row's, and both stay at their "not modeled" defaults
    without a reaction."""
    port, ref_np, _ = _runs("poisson_flap_storm")
    row = distill_metrics(*port)
    want = jx_distill(*ref_np)
    assert row.blackholed_bytes == pytest.approx(want.blackholed_bytes,
                                                 abs=TOL)
    assert row.reaction_slots == want.reaction_slots > 0
    plain = compile_scenario(get_scenario("fig12_plane_flap").with_sim(
        slots=40))
    res = plain.run(device="cpu")
    assert res.blackhole_timeline is None
    row = distill_metrics(plain.spec, plain, res)
    assert (row.blackholed_bytes, row.reaction_slots) == (-1.0, -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reaction_slots_equals_reference(seed):
    rng = np.random.default_rng(seed)
    bh = np.where(rng.random(120) < 0.15, rng.uniform(0, 2, 120), 0.0)
    bh[-3:] = 1.0                                  # a window left open
    slots = tuple(sorted({(int(s), "f") for s in rng.integers(0, 120, 6)}))
    assert _reaction_slots(bh, slots) == jx_reaction_slots(bh, slots)
    assert _reaction_slots(np.zeros(50), ((3, "f"),)) == 0


@pytest.mark.parametrize("name", ["reroute_random_failures_ft",
                                  "poisson_flap_storm[ar]"])
def test_replay_structure_writes_the_blackhole_series(name):
    """`SlotLoop` stepped without capture keeps the blackhole timeline
    as its second per-slot series, equal to the eager loop's bit for bit
    (every segment, the lagged view's boundaries among them)."""
    base, sim = _split(name)
    spec = get_scenario(base).with_sim(slots=220, **sim)
    cfg, fa, ops = engine.prepare(compile_scenario(spec), "cpu",
                                  torch.float64)
    assert cfg.react and ops.vup is not ops.up
    want = engine._simulate(cfg, ops)
    loop = engine.slot_loop(cfg, ops)
    assert len(loop.series) == 2
    loop.run()
    got = engine._results(cfg, loop.carry, *loop.series)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float(got[4].sum()) > 0
    tl = compile_fault_timeline(spec)
    vis = lagged_timeline(tl, 2)
    assert len(set(ops.seg_id.tolist())) == len(
        set(tl.change_slots()) | set(vis.change_slots()))
    assert all(x.device.type == "cpu" for x in _leaves(loop.carry))
