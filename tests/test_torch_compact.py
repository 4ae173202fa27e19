"""The int8 compact carry, against the reference: `REPRO_JX_COMPACT`
sets `EngineConfig.compact_carry` as it sets the reference's
`JxConfig.compact_carry`, and the probe counter's dtype follows the
reference's `jx/state.py::probe_miss_dtype`: int8 under the compact
carry in float32, wide otherwise (the port's int32, the reference's
default integer) and always wide in float64.

The counter saturates at `probe_timeout` (3), so a compact float32 run
must equal the wide float32 run bit for bit in every output: on a
probe-driven swlb scenario (fig12_plane_flap, its probe deadline
shortened to fire inside the run) and under failure reaction
(reroute_random_failures), alone, batched, as a megabatch and in flow
chunks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim.jx import engine as jx_engine
from repro.netsim.jx.state import FlowBatch as JxFlowBatch
from repro.netsim.jx.state import init_carry as jx_init_carry
from repro.netsim.jx.state import probe_miss_dtype as jx_probe_miss_dtype
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import get_scenario as jx_get
from repro_torch.netsim import engine, megabatch
from repro_torch.netsim.carry import carry_from_numpy
from repro_torch.netsim.state import probe_miss_dtype
from repro_torch.scenarios import compile_scenario, get_scenario

# name, sim overrides
POINTS = {
    "swlb": ("fig12_plane_flap",
             dict(slots=260, nic="swlb", sw_lb_delay_ms=20.0)),
    "reaction": ("reroute_random_failures", dict(slots=120)),
}
FIELDS = ("mean_goodput", "completion_slot", "total_goodput",
          "util_up_last", "blackhole_timeline")


def _env(monkeypatch, compact):
    if compact is None:
        monkeypatch.delenv("REPRO_JX_COMPACT", raising=False)
    else:
        monkeypatch.setenv("REPRO_JX_COMPACT", compact)


@pytest.mark.parametrize("compact", [None, "0", "1", "true", "off"])
def test_compact_carry_default_and_from_sim_follow_the_reference(
        monkeypatch, compact):
    _env(monkeypatch, compact)
    assert engine.compact_carry_default() == \
        jx_engine.compact_carry_default()
    name, sim = POINTS["swlb"]
    cfg = engine._prepared(compile_scenario(
        get_scenario(name).with_sim(**sim)))[0]
    with jax.enable_x64(True):
        rcfg = jx_engine._prepared(jx_compile(
            jx_get(name).with_sim(**sim)))[0]
    assert cfg.compact_carry == rcfg.compact_carry
    assert cfg.compact_carry == (compact in ("1", "true"))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_probe_miss_dtype_follows_the_reference(compact, dtype):
    name, sim = POINTS["swlb"]
    c = compile_scenario(get_scenario(name).with_sim(**sim))
    cfg, _, ops = engine.prepare(c, "cpu", getattr(torch, dtype))
    cfg = dataclasses.replace(cfg, compact_carry=compact)
    got = engine.init_carry(ops.fb, cfg).nic.probe_miss.dtype
    assert got == probe_miss_dtype(cfg, getattr(torch, dtype))
    with jax.enable_x64(True):
        rcfg = jx_engine._prepared(jx_compile(
            jx_get(name).with_sim(**sim)))[0]
        want = jx_probe_miss_dtype(
            dataclasses.replace(rcfg, compact_carry=compact),
            getattr(jnp, dtype))
    assert (got == torch.int8) == (want == jnp.int8)
    assert got == (torch.int8 if compact and dtype == "float32"
                   else torch.int32)


@pytest.mark.parametrize("compact", [False, True])
def test_a_handed_over_reference_carry_keeps_its_counter(compact):
    """The reference's float32 carry (its default float width) comes
    across with an int8 counter under the compact carry and an int32
    one otherwise, its values kept."""
    name, sim = POINTS["swlb"]
    with jax.enable_x64(True):
        rcfg, fa = jx_engine._prepared(jx_compile(
            jx_get(name).with_sim(**sim)))[:2]
    rcfg = dataclasses.replace(rcfg, compact_carry=compact)
    ref = jax.tree_util.tree_map(
        np.asarray, jx_init_carry(JxFlowBatch.from_arrays(fa), rcfg))
    assert ref.nic.probe_miss.dtype == (np.int8 if compact else np.int32)
    got = carry_from_numpy(ref, device="cpu", dtype=torch.float32)
    assert got.nic.probe_miss.dtype == (torch.int8 if compact
                                        else torch.int32)
    np.testing.assert_array_equal(got.nic.probe_miss.numpy(),
                                  ref.nic.probe_miss)


def _assert_same(got, want):
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            if b is None:
                assert a is None, f
            else:
                np.testing.assert_array_equal(a, b, f)


def _runs(monkeypatch, how, compact):
    """The float32 results of `how` with the compact carry on or off."""
    _env(monkeypatch, "1" if compact else None)
    if how == "chunks":
        monkeypatch.setenv("REPRO_JX_AGG", "sparse")
        monkeypatch.setenv("REPRO_JX_FLOW_CHUNK", "17")
    pts = [compile_scenario(get_scenario(name).with_sim(seed=s, **sim))
           for name, sim in POINTS.values() for s in (0, 1)]
    f32 = torch.float32
    if how in ("alone", "chunks"):
        return [c.run(device="cpu", dtype=f32) for c in pts]
    if how == "batched":
        return engine.run_compiled_batch(pts[:2], "cpu", f32) + \
            engine.run_compiled_batch(pts[2:], "cpu", f32)
    return megabatch.run_megabatch(pts, "cpu", f32)


@pytest.mark.parametrize("how", ["alone", "batched", "megabatch",
                                 "chunks"])
def test_compact_f32_equals_wide_f32(monkeypatch, how):
    wide = _runs(monkeypatch, how, False)
    compact = _runs(monkeypatch, how, True)
    _assert_same(compact, wide)
    if how == "chunks":
        name, sim = POINTS["swlb"]
        cfg = engine._prepared(compile_scenario(
            get_scenario(name).with_sim(**sim)), torch.float32)[0]
        assert cfg.compact_carry and cfg.flow_chunk == 17


def test_compact_counter_saturates_in_int8():
    """Stepped eagerly, the swlb point's compact counter stays int8 and
    reaches `probe_timeout` (so the probe drives the run), never past
    it."""
    name, sim = POINTS["swlb"]
    c = compile_scenario(get_scenario(name).with_sim(**sim))
    cfg, _, ops = engine.prepare(c, "cpu", torch.float32)
    cfg = dataclasses.replace(cfg, compact_carry=True)
    carry = engine.init_carry(ops.fb, cfg)
    most = 0
    for t in range(cfg.slots):
        carry, *_ = engine._slot_step(cfg, ops, carry, t)
        assert carry.nic.probe_miss.dtype == torch.int8
        most = max(most, int(carry.nic.probe_miss.max()))
    assert most == cfg.probe_timeout
