"""The structure the CUDA slot loop replays, run without capture on the
CPU: `netsim.graph.SlotLoop` through `engine.slot_loop`.

One slot there is a function of device state only: the slot `t` is a 0-d
tensor the loop advances, whether a slot counts toward the post-warmup
goodput is read from a table at `t`, each slot's total is written at
`t`, the capacity segment comes from the host map, and the carry is
handed from slot to slot through static buffers.  Run step by step on
the CPU it must equal the eager loop of `engine._simulate` bit for bit
(`torch.equal` on every output and on the final carry) and, like it,
the reference engines under `_assert_parity` (NumPy and JAX, the latter
entered with `jax.enable_x64(True)`).  The cases cover one segment
(fig11_degraded_leaf, WAR), two segments with the swlb probe's slot
deadline firing mid-run (fig12_plane_flap), four segments from slots 0,
100, 180 and 260 (cascading_spine_loss, WAR and ECMP), a handed-over
carry, and record/warmup settings where `counted` varies.
"""
import jax
import numpy as np
import pytest
import torch

from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import get_scenario as jx_get
from repro_torch.kernels import build
from repro_torch.netsim import engine
from repro_torch.netsim.graph import _leaves
from repro_torch.scenarios import compile_scenario, get_scenario

from test_torch_engine import _assert_parity, _split

# name[routing], sim overrides; fig12's swlb deadline shortened to 200
# slots so that it fires inside the run
CASES = {
    "fig11_degraded_leaf": {},
    "fig12_plane_flap": {"nic": "swlb", "sw_lb_delay_ms": 20.0},
    "cascading_spine_loss": {},
    "cascading_spine_loss[ecmp]": {},
}


def _spec(name, **sim):
    base, routing = _split(name)
    return base, dict(sim, **routing)


def _prepared(name, dtype=torch.float64, **sim):
    base, sim = _spec(name, **sim)
    spec = get_scenario(base).with_sim(**sim) if sim else \
        get_scenario(base)
    c = compile_scenario(spec)
    cfg, fa, ops = engine.prepare(c, "cpu", dtype)
    return spec, c, cfg, fa, ops


def _eager(cfg, ops, carry0=None):
    """The eager loop, also returning its final carry."""
    carry = engine.init_carry(ops.fb, cfg) if carry0 is None else carry0
    totals = ops.fb.demand.new_empty(cfg.slots)
    for t in range(cfg.slots):
        carry, totals[t] = engine._slot_step(cfg, ops, carry, t)
    return carry, engine._results(cfg, carry, totals)


def _replayed(cfg, ops, carry0=None):
    loop = engine.slot_loop(cfg, ops, carry0)
    loop.run()
    return loop, engine._results(cfg, loop.carry, loop.totals)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_replay_structure_equals_eager_loop(name):
    spec, c, cfg, fa, ops = _prepared(name, **CASES[name])
    carry, want = _eager(cfg, ops)
    loop, got = _replayed(cfg, ops)
    _assert_same(got, want)
    _assert_same(got, engine._simulate(cfg, ops))
    _assert_same(_leaves(loop.carry), _leaves(carry))
    assert int(loop.t) == cfg.slots


def test_segments_follow_the_host_map():
    """Each step reads the segment of its slot, and the four segments of
    cascading_spine_loss start at slots 0, 100, 180 and 260."""
    _, _, cfg, _, ops = _prepared("cascading_spine_loss")
    seen = []

    def spy(carry, t, seg, counted):
        seen.append((int(t), seg))
        return engine._slot(cfg, ops, carry, t, seg, counted)

    loop = engine.slot_loop(cfg, ops)
    loop._step = spy
    loop.run()
    assert seen == [(t, int(ops.seg_id[t])) for t in range(cfg.slots)]
    starts = [t for t in range(cfg.slots)
              if t == 0 or ops.seg_id[t] != ops.seg_id[t - 1]]
    assert starts == [0, 100, 180, 260]


@pytest.mark.parametrize("name", list(CASES))
def test_replay_structure_matches_the_references(name):
    """The step-by-step structure against the NumPy and JAX engines."""
    spec, c, cfg, fa, ops = _prepared(name, **CASES[name])
    _, out = _replayed(cfg, ops)
    port = (spec, c, engine._wrap(cfg, fa, out, torch.device("cpu")))
    base, sim = _spec(name, **CASES[name])
    rspec = jx_get(base).with_sim(**sim) if sim else jx_get(base)
    rc = jx_compile(rspec)
    with jax.enable_x64(True):
        ref_np = rc.run(backend="numpy")
        ref_jx = jx_compile(rspec).run(backend="jax")
    _assert_parity(port, (rspec, rc, ref_np))
    _assert_parity(port, (rspec, rc, ref_jx))


@pytest.mark.parametrize("name", ["fig12_plane_flap",
                                  "cascading_spine_loss[ecmp]"])
def test_replay_structure_takes_a_handed_over_carry(name):
    """`carry0` (here the state after 150 eager slots) seeds the static
    buffers and is never written."""
    spec, c, cfg, fa, ops = _prepared(name, **CASES[name])
    carry0 = engine.init_carry(ops.fb, cfg)
    for t in range(150):
        carry0, _ = engine._slot_step(cfg, ops, carry0, t)
    kept = [x.clone() for x in _leaves(carry0)]
    carry, want = _eager(cfg, ops, carry0)
    loop, got = _replayed(cfg, ops, carry0)
    _assert_same(got, want)
    _assert_same(got, engine._simulate(cfg, ops, carry0))
    _assert_same(_leaves(loop.carry), _leaves(carry))
    _assert_same(_leaves(carry0), kept)


@pytest.mark.parametrize("record_every,warmup_frac", [(1, 0.25), (3, 0.5),
                                                      (7, 0.0), (4, 1.0)])
def test_counted_table_and_totals(record_every, warmup_frac):
    """The device table of counted slots is the eager loop's host rule,
    including a warmup that covers every frame (then every recorded
    frame counts); the per-slot totals land at their slots."""
    spec, c, cfg, fa, ops = _prepared("fig11_degraded_leaf", slots=90,
                                      record_every=record_every,
                                      warmup_frac=warmup_frac)
    loop = engine.slot_loop(cfg, ops)
    want = [engine._counted(cfg, t) for t in range(cfg.slots)]
    assert loop.counted.tolist() == want
    assert any(want) and (record_every == 1 or not all(want))
    carry, eager = _eager(cfg, ops)
    loop.run()
    got = engine._results(cfg, loop.carry, loop.totals)
    _assert_same(got, eager)
    res = engine._wrap(cfg, fa, got, torch.device("cpu"))
    np.testing.assert_array_equal(res.total_goodput,
                                  eager[2].numpy()[::record_every])


def test_replay_counts_what_the_capture_recorded():
    """`count_replay` adds a capture's recorded launches to `LAUNCHES`
    once a replay; nothing else moves."""
    build.reset_launches()
    recorded = dict.fromkeys(build.KERNELS, 0)
    recorded.update(plane_split=1, pair_fractions=1, bottleneck=1)
    for _ in range(3):
        build.count_replay(recorded)
    assert build.LAUNCHES == {k: 3 * n for k, n in recorded.items()}
    build.reset_launches()
