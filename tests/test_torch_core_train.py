"""The port's `core` training-side modules (congestion control, the NIC
plane load balancer, switch adaptive routing, failover control,
telemetry) against the JAX package's on the CPU, on the same numpy
inputs.

Float32 update rules agree within 1e-6 (relative and absolute: the two
frameworks may round a product or a 4-element sum in another order);
integer and boolean state, selections and recovery records are equal.
Random draws come from a `torch.Generator` in the port and a PRNG key
in the reference, so selections are compared only where the tie-break
noise cannot tip them (score gaps wider than the noise), and the
multinomial ECMP split by its invariants.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import adaptive_routing as jar
from repro.core import congestion as jcc
from repro.core import fault_tolerance as jft
from repro.core import plb as jplb
from repro.core import telemetry as jtel
import repro_torch.core as core
from repro_torch.core import adaptive_routing as ar
from repro_torch.core import congestion as cc
from repro_torch.core import fault_tolerance as ft
from repro_torch.core import plb
from repro_torch.core import telemetry as tel
from repro_torch.core.planes import PlaneConfig

TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _signals(rng, shape):
    rate = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    rtt = rng.uniform(2.0, 20.0, shape).astype(np.float32)
    ecn = np.where(rng.random(shape) < 0.4, rng.random(shape),
                   0.0).astype(np.float32)
    return rate, rtt, ecn


@pytest.mark.parametrize("seed", range(3))
def test_spx_cc_update_matches_reference(seed):
    rate, rtt, ecn = _signals(np.random.default_rng(seed), (64,))
    for cfg in (cc.SpxCCConfig(), cc.SpxCCConfig(md_factor=0.5,
                                                 ai_rate=0.2)):
        jcfg = jcc.SpxCCConfig(**dataclasses.asdict(cfg))
        got = cc.spx_cc_update(_t(rate), _t(rtt), _t(ecn), cfg)
        want = jcc.spx_cc_update(jnp.asarray(rate), jnp.asarray(rtt),
                                 jnp.asarray(ecn), jcfg)
        assert got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_dcqcn_update_matches_reference(seed):
    rng = np.random.default_rng(seed)
    rate, _, ecn = _signals(rng, (64,))
    alpha = rng.random(64).astype(np.float32)
    r, a = cc.dcqcn_update(_t(rate), _t(alpha), _t(ecn))
    jr, ja = jcc.dcqcn_update(jnp.asarray(rate), jnp.asarray(alpha),
                              jnp.asarray(ecn))
    _close(r, jr)
    _close(a, ja)
    # SPX recovers faster than DCQCN (the reference's own check)
    r_spx = r_dcq = torch.tensor([0.3])
    alpha = torch.tensor([0.5])
    for _ in range(20):
        r_spx = cc.spx_cc_update(r_spx, torch.tensor([6.0]), torch.zeros(1))
        r_dcq, alpha = cc.dcqcn_update(r_dcq, alpha, torch.zeros(1))
    assert float(r_spx[0]) > float(r_dcq[0])


def _state_equal(st, jst):
    _close(st.rate_allow, jst.rate_allow)
    _close(st.ewma_goodput, jst.ewma_goodput)
    _close(st.local_queue, jst.local_queue)
    np.testing.assert_array_equal(st.probe_miss.numpy(),
                                  np.asarray(jst.probe_miss))
    np.testing.assert_array_equal(st.eligible.numpy(),
                                  np.asarray(jst.eligible))
    assert st.probe_miss.dtype == torch.int32
    assert st.eligible.dtype == torch.bool


@pytest.mark.parametrize("seed", range(3))
def test_plb_update_and_weights_track_the_reference(seed):
    """Thirty control intervals of random signals, probes lost in runs
    so planes leave and rejoin the eligible set."""
    rng = np.random.default_rng(seed)
    P = 4
    cfg = PlaneConfig(n_planes=P, probe_timeout=3)
    st, jst = plb.plb_init(P), jplb.plb_init(P)
    _state_equal(st, jst)
    lost = np.zeros(P, bool)
    for _ in range(30):
        flip = rng.random(P) < 0.2
        lost = np.where(flip, ~lost, lost)
        _, rtt, ecn = _signals(rng, (P,))
        deliv = np.where(lost, 0.0, rng.random(P)).astype(np.float32)
        queue = rng.random(P).astype(np.float32)
        ok = ~lost
        st = plb.plb_update(st, _t(rtt), _t(ecn), _t(deliv), _t(ok),
                            _t(queue), cfg)
        jst = jplb.plb_update(jst, jnp.asarray(rtt), jnp.asarray(ecn),
                              jnp.asarray(deliv), jnp.asarray(ok),
                              jnp.asarray(queue), cfg)
        _state_equal(st, jst)
        _close(plb.plane_weights(st), jplb.plane_weights(jst))
    # every plane out of the set: uniform weights, as the reference gives
    st.eligible = torch.zeros(P, dtype=torch.bool)
    jst.eligible = jnp.zeros(P, bool)
    _close(plb.plane_weights(st), jplb.plane_weights(jst))


# (rate_allow, local_queue, eligible, tx_rate): queue gaps wider than the
# 1e-3 noise, so the pick is the same whatever the draws
_SELECT = [
    ([1.0, 0.1, 1.0, 1.0], [0.5, 0.0, 0.2, 0.6], [1, 1, 1, 1], 0.25),
    ([1.0, 1.0, 1.0, 1.0], [0.5, 0.3, 0.2, 0.1], [1, 1, 1, 0], 0.25),
    ([0.1, 0.1, 0.1, 0.1], [0.5, 0.3, 0.9, 0.7], [1, 1, 1, 1], 0.5),
    ([0.1, 0.2, 0.1, 0.2], [0.5, 0.3, 0.9, 0.2], [1, 1, 1, 0], 0.5),
    ([1.0, 0.6, 0.4], [0.0, 0.4, 0.2], [0, 1, 1], 0.5),
]


@pytest.mark.parametrize("rate,queue,elig,tx", _SELECT)
def test_select_plane_deterministic_cases(rate, queue, elig, tx):
    st = plb.plb_init(len(rate))
    st.rate_allow = torch.tensor(rate, dtype=torch.float32)
    st.local_queue = torch.tensor(queue, dtype=torch.float32)
    st.eligible = torch.tensor(elig, dtype=torch.bool)
    jst = jplb.plb_init(len(rate))
    jst.rate_allow = jnp.asarray(rate, jnp.float32)
    jst.local_queue = jnp.asarray(queue, jnp.float32)
    jst.eligible = jnp.asarray(elig, bool)
    want = int(jplb.select_plane(jst, jax.random.PRNGKey(0), tx))
    gen = torch.Generator().manual_seed(0)
    picks = {int(plb.select_plane(st, gen, tx)) for _ in range(16)}
    assert picks == {want}
    many = plb.select_planes(st, 64, gen, tx)
    assert many.shape == (64,) and set(many.tolist()) == {want}
    jmany = jplb.select_planes(jst, jax.random.split(
        jax.random.PRNGKey(1), 64), tx)
    assert set(np.asarray(jmany).tolist()) == {want}


def test_select_plane_ties_break_at_random():
    """Equal queues: the noise picks among the eligible planes only."""
    st = plb.plb_init(4)
    st.eligible = torch.tensor([True, False, True, True])
    picks = plb.select_planes(st, 400, torch.Generator().manual_seed(3))
    assert set(picks.tolist()) == {0, 2, 3}


@pytest.mark.parametrize("seed", range(2))
def test_adaptive_routing_scores_match_reference(seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 1.2, (8, 6)).astype(np.float32)
    up = rng.random((8, 6)) < 0.8
    w = rng.uniform(0.1, 1.0, (8, 6)).astype(np.float32)
    _close(ar.quantize_queue(_t(q)), jar.quantize_queue(jnp.asarray(q)))
    _close(ar.quantize_queue(_t(q), nbins=8, qmax=0.5),
           jar.quantize_queue(jnp.asarray(q), nbins=8, qmax=0.5))
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else _t(weights)
        _close(ar.ar_scores(_t(q), _t(up), tw),
               jar.ar_scores(jnp.asarray(q), jnp.asarray(up), jw))
        for temp in (1.0, 0.25):
            _close(ar.spray_fractions(_t(q), _t(up), tw, temperature=temp),
                   jar.spray_fractions(jnp.asarray(q), jnp.asarray(up), jw,
                                       temperature=temp))
    h = rng.integers(0, 1 << 20, (8, 50)).astype(np.int32)
    np.testing.assert_array_equal(
        ar.ecmp_select(_t(h), _t(up)[:, None, :]).numpy(),
        np.asarray(jar.ecmp_select(jnp.asarray(h), jnp.asarray(up)[:, None])))


def test_jsq_select_deterministic_and_ecmp_fractions():
    q = np.array([0.9, 0.1, 0.5, 0.2], np.float32)
    up = np.array([True, False, True, True])
    want = int(jar.jsq_select(jnp.asarray(q), jnp.asarray(up),
                              jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    picks = {int(ar.jsq_select(_t(q), _t(up), gen)) for _ in range(20)}
    assert picks == {want} == {3}
    # a weighted pick: port 2's score halves by its weight
    w = np.array([1.0, 1.0, 4.0, 1.0], np.float32)
    want = int(jar.jsq_select(jnp.asarray(q), jnp.asarray(up),
                              jax.random.PRNGKey(0), jnp.asarray(w)))
    assert int(ar.jsq_select(_t(q), _t(up), gen, _t(w))) == want
    # fluid ECMP: counts over the up ports only, summing to 1
    fr = ar.ecmp_fractions(torch.tensor(1000), _t(up), gen)
    jfr = jar.ecmp_fractions(jnp.asarray(1000), jnp.asarray(up),
                             jax.random.PRNGKey(0))
    for f in (fr.numpy(), np.asarray(jfr)):
        assert f[1] == 0.0 and abs(f.sum() - 1.0) < 1e-6
        assert np.all(np.abs(f[[0, 2, 3]] - 1 / 3) < 0.1)


# (plane, step) fail and heal events
_SEQUENCES = [
    dict(steps=12, fail={3: [1]}, heal={}),
    dict(steps=16, fail={2: [2], 9: [0]}, heal={7: [2]}),
    dict(steps=14, fail={1: [0, 3]}, heal={4: [0], 10: [3]}),
    dict(steps=10, fail={0: [1], 1: [1]}, heal={2: [1], 3: [2]}),
]


@pytest.mark.parametrize("seq", _SEQUENCES)
def test_failover_controller_matches_reference(seq):
    cfg = PlaneConfig(n_planes=4, probe_timeout=3)
    fc, jfc = ft.FailoverController(cfg), jft.FailoverController(cfg)
    for step in range(seq["steps"]):
        for p in seq["fail"].get(step, []):
            fc.fail_plane(p)
            jfc.fail_plane(p)
        for p in seq["heal"].get(step, []):
            fc.restore_plane(p)
            jfc.restore_plane(p)
        w, jw = fc.on_step(), jfc.on_step()
        assert w.dtype == np.float32
        _close(w, jw)
        _state_equal(fc.state, jfc.state)
        np.testing.assert_array_equal(fc.plane_up, jfc.plane_up)
    _close(fc.weights(), jfc.weights())
    assert [dataclasses.astuple(r) for r in fc.records] == \
        [dataclasses.astuple(r) for r in jfc.records]
    assert [r.recovery_steps for r in fc.records] == \
        [r.recovery_steps for r in jfc.records]


def test_failover_controller_takes_measured_signals():
    """Queues and RTTs passed in replace the defaults."""
    rng = np.random.default_rng(5)
    cfg = PlaneConfig(n_planes=4)
    fc, jfc = ft.FailoverController(cfg), jft.FailoverController(cfg)
    for step in range(8):
        if step == 2:
            fc.fail_plane(3)
            jfc.fail_plane(3)
        q = rng.random(4).astype(np.float32)
        rtt = rng.uniform(4, 16, 4).astype(np.float32)
        _close(fc.on_step(q, rtt), jfc.on_step(q, rtt))
        _state_equal(fc.state, jfc.state)
    rec = fc.records[0]
    assert rec.recovery_steps is not None
    assert rec.recovery_steps <= cfg.probe_timeout + cfg.recovery_steps


@pytest.mark.parametrize("args", [(256, 16), (240, 16), (512, 16, 2),
                                  (16, 16), (33, 8, 4), (64, 8, 3)])
def test_elastic_mesh_plan_matches_reference(args):
    assert ft.elastic_mesh_plan(*args) == jft.elastic_mesh_plan(*args)


@pytest.mark.parametrize("args", [(8, 16), (24, 16, 2)])
def test_elastic_mesh_plan_errors_match_reference(args):
    with pytest.raises(ValueError) as want:
        jft.elastic_mesh_plan(*args)
    with pytest.raises(ValueError, match=str(want.value)):
        ft.elastic_mesh_plan(*args)


def test_hft_buffer_matches_reference():
    rng = np.random.default_rng(2)
    buf, jbuf = tel.HFTBuffer(capacity=40), jtel.HFTBuffer(capacity=40)
    for t in range(60):
        m = {"bw": float(rng.uniform(0.8, 1.0))}
        if t % 7 == 3:
            m["bw"] = 0.1                        # a transient drop
        if t % 2:
            m["loss"] = float(rng.random())
        buf.record(float(t), m)
        jbuf.record(float(t), m)
    assert len(buf.records) == 40
    for key in ("bw", "loss", "absent"):
        np.testing.assert_array_equal(buf.series(key), jbuf.series(key))
        assert buf.drops(key) == jbuf.drops(key)
    assert buf.drops("bw") and buf.drops("bw", frac=0.05) == []
    assert tel.HFTBuffer().drops("bw") == []


def test_step_time_tracker_matches_reference():
    rng = np.random.default_rng(4)
    tr, jtr = tel.StepTimeTracker(8), jtel.StepTimeTracker(8)
    for i in range(12):
        st = rng.uniform(0.9, 1.1, 8)
        if i >= 4:
            st[5] *= 1.8                         # a straggler appears
        assert tr.update(st) == jtr.update(st)
        np.testing.assert_array_equal(tr.ewma, jtr.ewma)
    assert tr.update(np.ones(8)) == jtr.update(np.ones(8)) == [5]


@pytest.mark.parametrize("bw", [np.ones(16), np.r_[np.ones(15), 0.2],
                                np.linspace(0.5, 1.0, 8), np.zeros(4)])
def test_symmetry_check_matches_reference(bw):
    got = tel.symmetry_check("g", bw)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jtel.symmetry_check("g", bw))


def test_core_exports_the_reference_names_it_ports():
    """The reference's `repro.core` names, `plane_allreduce` and the
    int8 codec included."""
    names = {n for n in dir(jcore) if not n.startswith("_")
             and not isinstance(getattr(jcore, n), type(jcore))}
    names -= {"annotations"}
    assert {"plane_allreduce", "int8_encode", "int8_decode"} <= names
    missing = sorted(n for n in names if not hasattr(core, n))
    assert missing == []
