"""The PyTorch port's kernels on the CPU.

On the CPU every wrapper in `repro_torch.kernels` runs its plain PyTorch
version (`repro_torch.kernels.ref`).  Those are held here to the JAX
package's jnp oracles (`repro.kernels.ref`) in float64 — bit for bit,
except the softmax of `pair_fractions`, whose `exp` differs between the
frameworks (relative 1e-12; XLA on the CPU also flushes subnormal
results to zero, hence the absolute floor at the smallest normal) — and
to the Pallas kernels run in interpret mode in float32 (1e-6), over every
mode and shapes with non-power-of-two block tails.  The per-packet
`jsq_route` and `plb_select` return indices, which must equal both
exactly.  Inputs come from numpy with a seed and reach both frameworks
as the same arrays.

The CUDA kernels themselves run only on a GPU: `tests/test_torch_gpu.py`
holds them against these plain versions there, and `chip_smoke.py` does
so at the main path's shapes.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import jsq_route as jx_jsq
from repro.kernels import link_load as jx_link
from repro.kernels import plb_select as jx_plb
from repro.kernels import queue_ecn as jx_queue
from repro.kernels import ref as jx_ref
from repro_torch.kernels import build, int8_codec, jsq_route, link_load, \
    ops, plb_select, queue_ecn, ref

NIC_KW = dict(base_rtt_us=4.0, slot_us=10.0, ecn_thresh=3.0,
              target_rtt_us=12.0, min_rate=0.01, md=0.7, ai=0.08,
              rtt_gain=0.15, dcqcn_ai=0.01, alpha_g=0.0625)
F32_TOL = dict(rtol=1e-6, atol=1e-6)


def _plane_inputs(seed, F, P):
    rng = np.random.default_rng(seed)
    rate = rng.uniform(0.01, 1.0, (F, P))
    rate[rng.random((F, P)) < 0.2] = 0.01          # planes at MIN_RATE
    elig = rng.random((F, P)) > 0.25
    elig[::7] = False                              # rows with no plane
    return rate, elig, rng.uniform(0.0, 1.0, F)


def _pair_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 12.0, shape)              # past qmax too
    cap = rng.uniform(0.0, 1.0, shape)
    cap[rng.random(shape) < 0.15] = 0.0
    cap[0, 0] = 0.0                                # one fully dead row
    w = cap * rng.uniform(0.0, 1.0, shape)
    return q, cap, w


def _link_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 70.0, shape)
    load = rng.uniform(0.0, 2.0, shape)
    cap = rng.uniform(0.0, 1.5, shape)
    cap[rng.random(shape) < 0.15] = 0.0
    return q, load, cap


def _nic_inputs(seed, F, P):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 16.0, (F, P)), rng.uniform(0.0, 1.0, (F, P)),
            rng.uniform(0.0, 1.0, (F, P)), rng.random((F, 1)) < 0.5)


def _plan_inputs(seed, F, P, R, C):
    """(F, P) rates with exact zeros, a (P, R, C) int32 plan of flow
    indices padded with F (ragged bucket fills, one empty bucket) and
    (P, R) capacities with dead links."""
    rng = np.random.default_rng(seed)
    rate = rng.uniform(0.0, 1.0, (F, P))
    rate[rng.random((F, P)) < 0.1] = 0.0
    plan = rng.integers(0, F, (P, R, C)).astype(np.int32)
    fill = rng.integers(0, C + 1, (P, R))
    fill[0, 0] = 0
    plan[np.arange(C)[None, None, :] >= fill[..., None]] = F
    cap = rng.uniform(0.0, 2.0, (P, R))
    cap[rng.random((P, R)) < 0.1] = 0.0
    return rate, plan, cap


def _gathered(rate, plan):
    """The reference's (P, R, C) gather of `rate` through `plan`."""
    padT = np.concatenate([rate, np.zeros((1, rate.shape[1]))], 0).T
    return padT[np.arange(rate.shape[1])[:, None, None], plan]


def _packet_inputs(seed, lanes, N):
    """Per-port (or per-plane) vectors and N packets: float64 queues,
    a 0/1 mask with lane 0 up, weights, tx rates, and uint32 hashes
    over the full 32 bits."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 1.2, lanes)                # past qmax too
    q[rng.random(lanes) < 0.2] = 0.5               # equal queues: ties
    mask = (rng.random(lanes) > 0.2).astype(np.float64)
    mask[0] = 1.0
    w = rng.uniform(0.25, 1.0, lanes)
    tx = rng.uniform(0.0, 0.6, N)
    h = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    return q, mask, w, tx, h


def _jx(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _th(*arrays, dtype=torch.float64):
    return [torch.from_numpy(a) if a.dtype == bool
            else torch.as_tensor(a, dtype=dtype) for a in arrays]


# ---------------------------------------------------------------------------
# float64: plain versions vs the JAX package's jnp oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["spx", "dcqcn", "agg", "swlb"])
@pytest.mark.parametrize("F,P", [(37, 1), (129, 2), (250, 3), (64, 4),
                                 (33, 8)])
def test_plane_split_f64_bit_equal(mode, F, P):
    rate, elig, demand = _plane_inputs(F * P, F, P)
    with jax.enable_x64(True):
        want = np.asarray(jx_ref.plane_split_ref(
            *_jx(rate, elig, demand), mode=mode, min_rate=0.01))
    got = plb_select.plane_split(*_th(rate, elig, demand), mode=mode,
                                 min_rate=0.01)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1, 8, 8, 8), (2, 5, 5, 16),
                                   (3, 7, 9, 5)])
def test_pair_fractions_f64(shape):
    q, cap, w = _pair_inputs(sum(shape), shape)
    with jax.enable_x64(True):
        want = np.asarray(jx_ref.pair_score_softmax_ref(
            *_jx(q, cap, w), nbins=16, temperature=0.25))
    got = jsq_route.pair_fractions(*_th(q, cap, w), nbins=16,
                                   temperature=0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=np.finfo(np.float64).tiny)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-12)


@pytest.mark.parametrize("shape", [(1, 8, 8), (2, 13, 3), (4096, 2)])
def test_bottleneck_and_queue_update_f64_bit_equal(shape):
    q, load, cap = _link_inputs(len(shape), shape)
    with jax.enable_x64(True):
        want_f = np.asarray(jx_ref.bottleneck_ref(*_jx(cap, load)))
        want_q, want_u = (np.asarray(a) for a in jx_ref.queue_update_ref(
            *_jx(q, load, cap), q_cap=64.0))
    got_q, got_u = queue_ecn.queue_update(*_th(q, load, cap), q_cap=64.0)
    np.testing.assert_array_equal(
        link_load.bottleneck(*_th(cap, load)).numpy(), want_f)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_u.numpy(), want_u)


# entries of one grouped bottleneck launch: a one-element entry and
# lengths that are not multiples of the kernel's 256-thread block; "6"
# is a fat-tree slot's group (stage A up and down, stage B up and down,
# both access directions)
_GROUPS = {"1": [(2, 8, 16)], "2": [(1,), (37, 3)],
           "3": [(257,), (2, 256, 16), (1,)],
           "4": [(2, 256, 16), (2, 16, 256), (4096, 2), (1001,)],
           "5": [(1,), (2, 8, 4), (257,), (2, 2, 8), (37, 3)],
           "6": [(2, 8, 4), (2, 4, 8), (2, 2, 8), (2, 2, 8), (64, 2),
                 (64, 2)]}


@pytest.mark.parametrize("shapes", list(_GROUPS.values()), ids=list(_GROUPS))
def test_bottleneck_many_f64_bit_equal(shapes):
    pairs = [_link_inputs(10 + k, sh)[1:] for k, sh in enumerate(shapes)]
    with jax.enable_x64(True):
        want = [np.asarray(jx_ref.bottleneck_ref(*_jx(cap, load)))
                for load, cap in pairs]
    got = link_load.bottleneck_many(
        [tuple(_th(cap, load)) for load, cap in pairs])
    assert len(got) == len(shapes)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), w)


# entries of one grouped queue_update launch: a slot's up (P, L, S) and
# down (P, S, L) links at two widths, one entry alone, one-element
# entries, and a one-element entry beside ragged ones
_QUEUE_GROUPS = {"1": [(2, 8, 16)], "1-ragged": [(8193,)],
                 "2": [(2, 8, 16), (2, 16, 8)],
                 "2-narrow": [(1, 4, 2), (1, 2, 4)],
                 "2-single": [(1,), (1,)], "2-ragged": [(1,), (37, 3)],
                 "2-ragged-last": [(255,), (1,)],
                 "3-ragged": [(257,), (1,), (37, 3)],
                 "4": [(2, 8, 4), (2, 4, 8), (2, 2, 8), (2, 2, 8)],
                 "4-ragged": [(1,), (255,), (8193,), (1,)]}


def _queue_group(shapes, dtype):
    """The (q, load, cap) entries as numpy and as torch tensors."""
    arrays = [_link_inputs(30 + k, sh) for k, sh in enumerate(shapes)]
    return arrays, [tuple(_th(*a, dtype=dtype)) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shapes", list(_QUEUE_GROUPS.values()),
                         ids=list(_QUEUE_GROUPS))
def test_queue_update_many_bit_equal(shapes, dtype):
    """Each entry equals the plain version of its own entry bit for bit;
    in float64 also the JAX package's oracle
    (`repro.kernels.queue_ecn.queue_update` off Pallas)."""
    arrays, entries = _queue_group(shapes, dtype)
    got = queue_ecn.queue_update_many(entries, q_cap=64.0)
    assert len(got) == len(shapes)
    for (q_new, u), (q, load, cap) in zip(got, entries):
        want_q, want_u = ref.queue_update_ref(q, load, cap, q_cap=64.0)
        assert q_new.dtype == dtype and torch.equal(q_new, want_q)
        assert torch.equal(u, want_u)
    if dtype == torch.float64:
        with jax.enable_x64(True):
            for (q_new, u), a in zip(got, arrays):
                want_q, want_u = jx_queue.queue_update(*_jx(*a), q_cap=64.0)
                np.testing.assert_array_equal(q_new.numpy(),
                                              np.asarray(want_q))
                np.testing.assert_array_equal(u.numpy(), np.asarray(want_u))


@pytest.mark.parametrize("mode", ["spx", "dcqcn", "agg"])
@pytest.mark.parametrize("F,P", [(37, 1), (129, 2), (65, 4)])
def test_nic_update_f64_bit_equal(mode, F, P):
    qmean, rate, alpha, esr = _nic_inputs(F + P, F, P)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jx_ref.nic_update_ref(
            *_jx(qmean, rate, alpha, esr), mode=mode, **NIC_KW)]
    got = queue_ecn.nic_update(*_th(qmean, rate, alpha, esr), mode=mode,
                               **NIC_KW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("F,P,R,C", [(50, 1, 16, 7), (300, 2, 64, 47),
                                     (129, 3, 37, 11), (10, 2, 9, 1),
                                     (200, 4, 37, 200)])
def test_bucket_load_bottleneck_f64_bit_equal(F, P, R, C):
    """The plain version in parity mode (ordered, the default in
    float64) against the ordered jnp oracle on the gathered plan."""
    rate, plan, cap = _plan_inputs(F + R, F, P, R, C)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jx_ref.load_bottleneck_ref(
            *_jx(_gathered(rate, plan), cap), eps=link_load.EPS,
            ordered=True)]
    got = link_load.bucket_load_bottleneck(
        *_th(rate), torch.from_numpy(plan), *_th(cap))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), w)
    # the ordered sum starts from column 0, as `ref.bucket_sum_ref` does
    ordered = ref.load_bottleneck_ref(*_th(rate), torch.from_numpy(plan),
                                      *_th(cap), ordered=True)
    for g, o in zip(got, ordered):
        assert torch.equal(g, o)


def test_bucket_load_bottleneck_on_engine_plans():
    """On the engine's own plans (fig11 under ECMP) the loads are the
    flow-ordered link sums of the plane's rates, bucket by bucket."""
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario, get_scenario
    c = compile_scenario(get_scenario("fig11_degraded_leaf")
                         .with_sim(routing="ecmp"))
    cfg, fa, ops_ = engine.prepare(c, "cpu", torch.float64)
    rng = np.random.default_rng(11)
    rate = torch.as_tensor(rng.uniform(0.0, 1.0, (len(fa), cfg.n_planes)))
    load, frac = link_load.bucket_load_bottleneck(
        rate, ops_.ecmp_load[0], ops_.link_cap[0])
    L, S = cfg.n_leaves, cfg.n_spines
    a = ops_.assign[0].numpy()
    for p in range(cfg.n_planes):
        want_up = np.zeros(L * S)
        np.add.at(want_up, fa.src_leaf * S + a[:, p], rate[:, p].numpy())
        np.testing.assert_array_equal(load[p, :L * S].numpy(), want_up)
    assert torch.equal(frac, ref.bottleneck_ref(ops_.link_cap[0], load))


@pytest.mark.parametrize("ports,N", [(16, 37), (64, 256), (256, 4097)])
def test_jsq_route_equals_jnp_oracle(ports, N):
    q, up, w, _, h = _packet_inputs(ports + N, ports, N)
    want = np.asarray(jx_ref.jsq_route_ref(*_jx(q.astype(np.float32), up,
                                                w.astype(np.float32), h)))
    got = jsq_route.jsq_route(*_th(q, up, w), torch.from_numpy(h))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not set(got.numpy()) & set(np.flatnonzero(up == 0))
    # the ops entry point and int64 hashes give the same ports
    assert torch.equal(ops.jsq_route(*_th(q, up, w),
                                     torch.from_numpy(h.astype(np.int64))),
                       got)


@pytest.mark.parametrize("ports,N", [(7, 37), (256, 4097)])
@pytest.mark.parametrize("up", [1.0, 0.0], ids=["all-up", "all-down"])
def test_jsq_route_exact_ties_equal_jnp_oracle(ports, N, up):
    """Every port scores the same, so the hashed tie-break alone decides
    (all down: every value is 1e30 and argmin's first port, 0, wins)."""
    _, _, _, _, h = _packet_inputs(ports * N, ports, N)
    q, w = np.full(ports, 0.37), np.full(ports, 0.5)
    mask = np.full(ports, up)
    want = np.asarray(jx_ref.jsq_route_ref(*_jx(q.astype(np.float32), mask,
                                                w.astype(np.float32), h)))
    got = jsq_route.jsq_route(*_th(q, mask, w), torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy(), want)
    if up == 0.0:
        assert not got.any()

@pytest.mark.parametrize("P,N", [(2, 37), (4, 300), (8, 4097)])
def test_plb_select_equals_jnp_oracle(P, N):
    ra, el, lq, tx, h = _packet_inputs(P * N, P, N)
    want = np.asarray(jx_ref.plb_select_ref(*_jx(
        ra.astype(np.float32), el, lq.astype(np.float32),
        tx.astype(np.float32), h)))
    got = plb_select.plb_select(*_th(ra, el, lq, tx), torch.from_numpy(h))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not set(got.numpy()) & set(np.flatnonzero(el == 0))
    assert torch.equal(ops.plb_select(*_th(ra, el, lq, tx),
                                      torch.from_numpy(h)), got)


def test_hash_tie_is_uint32_arithmetic():
    """The int64 emulation of the uint32 multiply-xorshift hash, at the
    edges of the 32-bit range."""
    h = np.array([0, 1, 65535, 65536, 2**31 - 1, 2**31, 2**32 - 1],
                 np.uint64)
    lanes = np.arange(5, dtype=np.uint64)
    mix = (h[:, None] * 2654435761 + lanes[None] * 40503) % 2**32
    mix ^= mix >> 16
    want = (mix & 0xFFFF).astype(np.float32) / np.float32(65536.0)
    got = ref._hash_tie(torch.from_numpy(h.astype(np.int64)), 5, 40503)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# float32: plain versions vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["spx", "dcqcn", "agg", "swlb"])
@pytest.mark.parametrize("F,P,bp", [(37, 3, 16), (129, 4, 64)])
def test_plane_split_vs_pallas_interpret(mode, F, P, bp):
    rate, elig, demand = _plane_inputs(F, F, P)
    want = jx_plb.plane_split(
        *_jx(rate.astype(np.float32), elig, demand.astype(np.float32)),
        mode=mode, min_rate=0.01, bp=bp, use_pallas=True, interpret=True)
    got = plb_select.plane_split(*_th(rate, elig, demand,
                                      dtype=torch.float32),
                                 mode=mode, min_rate=0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("shape,br", [((3, 5, 7, 7), 16),
                                      ((2, 9, 4, 16), 32)])
def test_pair_fractions_vs_pallas_interpret(shape, br):
    q, cap, w = (a.astype(np.float32) for a in _pair_inputs(7, shape))
    want = jx_jsq.pair_fractions(*_jx(q, cap, w), nbins=16,
                                 temperature=0.25, qmax=8.0, br=br,
                                 use_pallas=True, interpret=True)
    got = jsq_route.pair_fractions(*_th(q, cap, w, dtype=torch.float32),
                                   nbins=16, temperature=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_bottleneck_and_queue_update_vs_pallas_interpret():
    q, load, cap = (a.astype(np.float32)
                    for a in _link_inputs(3, (3, 11, 37)))   # odd tail
    want_f = jx_link.bottleneck(*_jx(cap, load), bp=256, use_pallas=True,
                                interpret=True)
    want_q, want_u = jx_queue.queue_update(*_jx(q, load, cap), q_cap=64.0,
                                           bp=256, use_pallas=True,
                                           interpret=True)
    tq, tl, tc = _th(q, load, cap, dtype=torch.float32)
    got_q, got_u = queue_ecn.queue_update(tq, tl, tc, q_cap=64.0)
    np.testing.assert_allclose(link_load.bottleneck(tc, tl).numpy(),
                               np.asarray(want_f), **F32_TOL)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                               **F32_TOL)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u),
                               **F32_TOL)


@pytest.mark.parametrize("shapes", list(_GROUPS.values()), ids=list(_GROUPS))
def test_bottleneck_many_vs_pallas_interpret(shapes):
    pairs = [tuple(a.astype(np.float32)
                   for a in _link_inputs(20 + k, sh)[1:][::-1])
             for k, sh in enumerate(shapes)]
    got = link_load.bottleneck_many(
        [tuple(_th(cap, load, dtype=torch.float32)) for cap, load in pairs])
    for g, (cap, load) in zip(got, pairs):
        want = jx_link.bottleneck(*_jx(cap, load), bp=256, use_pallas=True,
                                  interpret=True)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("shapes", list(_QUEUE_GROUPS.values()),
                         ids=list(_QUEUE_GROUPS))
def test_queue_update_many_vs_pallas_interpret(shapes):
    """float32 entries against the Pallas kernel run in interpret mode,
    one call per entry."""
    arrays, entries = _queue_group(shapes, torch.float32)
    got = queue_ecn.queue_update_many(entries, q_cap=64.0)
    for (q_new, u), a in zip(got, arrays):
        want_q, want_u = jx_queue.queue_update(
            *_jx(*(x.astype(np.float32) for x in a)), q_cap=64.0, bp=256,
            use_pallas=True, interpret=True)
        np.testing.assert_allclose(q_new.numpy(), np.asarray(want_q),
                                   **F32_TOL)
        np.testing.assert_allclose(u.numpy(), np.asarray(want_u),
                                   **F32_TOL)


@pytest.mark.parametrize("mode", ["spx", "dcqcn", "agg"])
@pytest.mark.parametrize("F,P,bp", [(37, 3, 16), (130, 2, 64)])
def test_nic_update_vs_pallas_interpret(mode, F, P, bp):
    qmean, rate, alpha, esr = _nic_inputs(F, F, P)
    f32 = [a.astype(np.float32) for a in (qmean, rate, alpha)]
    want = jx_queue.nic_update(*_jx(*f32, esr), mode=mode, bp=bp,
                               use_pallas=True, interpret=True, **NIC_KW)
    got = queue_ecn.nic_update(*_th(*f32, esr, dtype=torch.float32),
                               mode=mode, **NIC_KW)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("P,R,C,br", [(3, 37, 11, 16), (2, 64, 8, 128)])
def test_bucket_load_bottleneck_vs_pallas_interpret(P, R, C, br):
    F = 3 * R
    rate, plan, cap = (a.astype(np.float32) if a.dtype == np.float64
                       else a for a in _plan_inputs(P + R, F, P, R, C))
    want = jx_link.bucket_load_bottleneck(
        *_jx(_gathered(rate, plan).astype(np.float32), cap),
        ordered=False, br=br, use_pallas=True, interpret=True)
    got = link_load.bucket_load_bottleneck(
        *_th(rate, dtype=torch.float32), torch.from_numpy(plan),
        *_th(cap, dtype=torch.float32))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("N,bp", [(37, 16), (512, 256), (300, 256)])
def test_jsq_route_vs_pallas_interpret(N, bp):
    q, up, w, _, h = _packet_inputs(N, 16, N)
    want = jx_jsq.jsq_route(*_jx(q, up, w, h), bp=bp, interpret=True)
    got = jsq_route.jsq_route(*_th(q, up, w), torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("N,bp", [(37, 16), (300, 256), (4097, 256)])
def test_plb_select_vs_pallas_interpret(N, bp):
    ra, el, lq, tx, h = _packet_inputs(N, 4, N)
    want = jx_plb.plb_select(*_jx(ra, el, lq, tx, h), bp=bp,
                             interpret=True)
    got = plb_select.plb_select(*_th(ra, el, lq, tx), torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain versions, nothing else falls back
# ---------------------------------------------------------------------------

def _cpu(seed, *shape, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)


_LENGTHS = torch.tensor([3, 0], dtype=torch.int32)


@pytest.mark.parametrize("call,plain", [
    (lambda: plb_select.plane_split(*_th(*_plane_inputs(0, 16, 2)),
                                    mode="spx", min_rate=0.01),
     lambda: ref.plane_split_ref(*_th(*_plane_inputs(0, 16, 2)),
                                 mode="spx", min_rate=0.01)),
    (lambda: ops.flash_attention(_cpu(1, 1, 2, 8, 64), _cpu(2, 1, 2, 8, 64),
                                 _cpu(3, 1, 2, 8, 64), window=3),
     lambda: ref.flash_attention_ref(_cpu(1, 1, 2, 8, 64),
                                     _cpu(2, 1, 2, 8, 64),
                                     _cpu(3, 1, 2, 8, 64), window=3)),
    (lambda: ops.flash_attention_bshd(_cpu(1, 1, 8, 2, 64),
                                      _cpu(2, 1, 8, 2, 64),
                                      _cpu(3, 1, 8, 2, 64)),
     lambda: ref.flash_attention_ref(
         _cpu(1, 1, 8, 2, 64).transpose(1, 2),
         _cpu(2, 1, 8, 2, 64).transpose(1, 2),
         _cpu(3, 1, 8, 2, 64).transpose(1, 2)).transpose(1, 2)),
    (lambda: ops.decode_attention(_cpu(1, 2, 2, 1, 64), _cpu(2, 2, 2, 9, 64),
                                  _cpu(3, 2, 2, 9, 64), _LENGTHS),
     lambda: ref.decode_attention_ref(_cpu(1, 2, 2, 1, 64),
                                      _cpu(2, 2, 2, 9, 64),
                                      _cpu(3, 2, 2, 9, 64), _LENGTHS)),
    (lambda: ops.int8_encode(_cpu(1, 4, 33), _cpu(2, 4, 33) * 0.1),
     lambda: ref.int8_encode_ref(_cpu(1, 4, 33), _cpu(2, 4, 33) * 0.1)),
    (lambda: ops.int8_decode(_cpu(1, 4, 33).to(torch.int8), _cpu(2, 4, 1),
                             dtype=torch.bfloat16),
     lambda: ref.int8_decode_ref(_cpu(1, 4, 33).to(torch.int8),
                                 _cpu(2, 4, 1), torch.bfloat16)),
], ids=["plane_split", "flash_attention", "flash_attention_bshd",
        "decode_attention", "int8_encode", "int8_decode"])
def test_cpu_tensors_take_plain_version_without_launching(call, plain):
    build.reset_launches()
    got, want = call(), plain()
    for g, w in zip(*((x,) if isinstance(x, torch.Tensor) else x
                      for x in (got, want))):
        assert g.device.type == "cpu" and torch.equal(g, w)
    assert set(build.LAUNCHES) == set(build.KERNELS)
    assert all(n == 0 for n in build.LAUNCHES.values())


def _meta(*shape, dtype=torch.float64):
    return torch.empty(shape, dtype=dtype, device="meta")


_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("call", [
    lambda: plb_select.plane_split(_meta(4, 2), _meta(4, 2, dtype=bool),
                                   _meta(4), mode="spx"),
    lambda: jsq_route.pair_fractions(_meta(1, 2, 2, 4), _meta(1, 2, 2, 4),
                                     _meta(1, 2, 2, 4)),
    lambda: link_load.bottleneck(_meta(8), _meta(8)),
    lambda: link_load.bucket_load_bottleneck(
        _meta(5, 2), _meta(2, 4, 3, dtype=torch.int32), _meta(2, 4)),
    lambda: queue_ecn.queue_update(_meta(8), _meta(8), _meta(8),
                                   q_cap=64.0),
    lambda: queue_ecn.nic_update(_meta(4, 2), _meta(4, 2), _meta(4, 2),
                                 _meta(4, 1, dtype=bool), mode="spx",
                                 **NIC_KW),
    lambda: jsq_route.jsq_route(_meta(8), _meta(8), _meta(8),
                                _meta(16, dtype=torch.int32)),
    lambda: plb_select.plb_select(_meta(4), _meta(4), _meta(4), _meta(16),
                                  _meta(16, dtype=torch.int32)),
    lambda: ops.flash_attention(*(_meta(1, 2, 8, 64, dtype=_BF16),) * 3),
    lambda: ops.decode_attention(_meta(1, 2, 1, 64, dtype=_BF16),
                                 _meta(1, 2, 8, 64, dtype=_BF16),
                                 _meta(1, 2, 8, 64, dtype=_BF16),
                                 _meta(1, dtype=torch.int32)),
    lambda: ops.int8_encode(_meta(4, 8, dtype=_F32), _meta(4, 8, dtype=_F32)),
    lambda: ops.int8_decode(_meta(4, 8, dtype=torch.int8),
                            _meta(4, 1, dtype=_F32)),
    lambda: ops.flash_attention_bshd(_meta(1, 8, 4, 64, dtype=_BF16),
                                     _meta(1, 8, 2, 64, dtype=_BF16),
                                     _meta(1, 8, 2, 64, dtype=_BF16)),
    lambda: ops.bottleneck_many([(_meta(8), _meta(8)),
                                 (_meta(3, 2), _meta(3, 2))]),
    lambda: ops.queue_update_many([(_meta(2, 4), _meta(2, 4), _meta(2, 4)),
                                   (_meta(4, 2), _meta(4, 2), _meta(4, 2))],
                                  q_cap=64.0),
], ids=list(build.KERNELS) + ["flash_attention_bshd", "bottleneck_many",
                              "queue_update_many"])
def test_non_cpu_tensor_never_falls_back(call):
    build.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert all(n == 0 for n in build.LAUNCHES.values())


@pytest.mark.parametrize("pairs,match", [
    ([], "1-6"),
    ([(_meta(8), _meta(8))] * 7, "1-6"),
    ([(_meta(8), _meta(8)), (_meta(8, dtype=_F32), _meta(8, dtype=_F32))],
     "dtype"),
    ([(_meta(8), _meta(8, dtype=_F32))], "dtype"),
    ([(_meta(8), _meta(8)), (torch.ones(8), torch.ones(8))], "on cpu"),
    ([(torch.ones(8), torch.ones(8)), (_meta(8), _meta(8))], "on meta"),
    ([(_meta(8), _meta(8)), (_meta(8), _meta(4, 2))], "shape"),
], ids=["0", "7", "mixed-dtype", "pair-dtype", "cpu-among-device",
        "device-among-cpu", "shape"])
def test_bottleneck_many_refuses_bad_groups(pairs, match):
    """Whatever the device: 1-6 pairs, one dtype, one device, matching
    shapes in each pair; nothing launches."""
    build.reset_launches()
    with pytest.raises(ValueError, match=match):
        link_load.bottleneck_many(pairs)
    assert all(n == 0 for n in build.LAUNCHES.values())


_Q = (_meta(8), _meta(8), _meta(8))


@pytest.mark.parametrize("entries,match", [
    ([], "1-4"),
    ([_Q] * 5, "1-4"),
    ([_Q, (_meta(8, dtype=_F32),) * 3], "dtype"),
    ([(_meta(8), _meta(8, dtype=_F32), _meta(8))], "dtype"),
    ([_Q, (torch.ones(8),) * 3], "on cpu"),
    ([(torch.ones(8),) * 3, _Q], "on meta"),
    ([(_meta(8), _meta(8), _meta(4, 2))], "shape"),
    ([_Q, (_meta(8), _meta(4), _meta(8))], "shape"),
    ([_Q[:2]], "expected"),
], ids=["0", "5", "mixed-dtype", "entry-dtype", "cpu-among-device",
        "device-among-cpu", "shape", "shape-second-entry", "two-tensors"])
def test_queue_update_many_refuses_bad_groups(entries, match):
    """Whatever the device: 1-4 entries of three tensors, one dtype, one
    device, one shape in each entry; nothing launches."""
    build.reset_launches()
    with pytest.raises(ValueError, match=match):
        queue_ecn.queue_update_many(entries, q_cap=64.0)
    assert all(n == 0 for n in build.LAUNCHES.values())


@pytest.mark.parametrize("module,constant", [
    (link_load, "kMaxGroup"), (queue_ecn, "kMaxQueueGroup")])
def test_group_limits_match_the_kernel(module, constant):
    """The wrappers refuse a group exactly where the kernel would: their
    MAX_GROUP is the CUDA source's constant."""
    src = (Path(build.__file__).parent / "csrc" /
           "netsim_kernels.cu").read_text()
    (value,) = re.findall(rf"constexpr int {constant} = (\d+);", src)
    assert module.MAX_GROUP == int(value)


def test_library_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build.library()


def test_unknown_modes_raise():
    rate, elig, demand = _th(*_plane_inputs(0, 4, 2))
    with pytest.raises(ValueError):
        plb_select.plane_split(rate, elig, demand, mode="ecmp")
    with pytest.raises(ValueError):
        queue_ecn.nic_update(rate, rate, rate, elig[:, :1], mode="swlb",
                             **NIC_KW)


def test_build_key_tracks_source_and_flags(tmp_path, monkeypatch):
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("librepro_torch_kernels_")
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert [s.name for s in build.SOURCES] == ["netsim_kernels.cu",
                                               "model_kernels.cu"]
    assert all(s.exists() for s in build.SOURCES)
    # the key covers every source and the flags
    copies = []
    for src in build.SOURCES:
        copies.append(tmp_path / src.name)
        copies[-1].write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "SOURCES", tuple(copies))
    assert build.library_path() == path
    seen = {path}
    for copy in copies:
        copy.write_bytes(copy.read_bytes() + b"// edited\n")
        seen.add(build.library_path())
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    seen.add(build.library_path())
    assert len(seen) == 4


def test_every_kernel_has_an_entry_point_per_dtype():
    """Each wrapper's kernel names a C entry point for each dtype it is
    built for, and refuses the others."""
    assert build.symbol("plane_split", torch.float64) == \
        "netsim_plane_split_f64"
    assert build.symbol("flash_attention", torch.bfloat16) == \
        "model_flash_attention_bf16"
    for kernel in ("flash_attention", "decode_attention", "int8_encode",
                   "int8_decode"):
        assert build.float_dtype(kernel, _meta(1, dtype=_BF16)) == _BF16
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            build.float_dtype(kernel, _meta(1))
    with pytest.raises(ValueError, match="float32 or float64"):
        build.float_dtype("bottleneck", _meta(1, dtype=_BF16))
    # ... and each entry point is defined in exactly one source
    for kernel in build.KERNELS:
        stem = build.symbol(kernel, torch.float32)[:-len("f32")]
        assert sum(stem in s.read_text() for s in build.SOURCES) == 1, kernel


# (dtype, C, offset of x in elements, instance, elements a load)
_ENCODE_PICKS = [
    (_F32, 14336, 0, "shared", 4), (_BF16, 14336, 0, "shared", 8),
    (_F32, 8192, 0, "registers", 4), (_BF16, 8192, 0, "registers", 8),
    (_F32, 8196, 0, "shared", 4), (_BF16, 8200, 0, "shared", 8),
    (_F32, 1001, 0, "registers", 1), (_F32, 4, 0, "registers", 4),
    (_BF16, 4, 0, "registers", 1), (_F32, 1, 0, "registers", 1),
    (_F32, 4095, 0, "registers", 1), (_F32, 4097, 0, "shared", 1),
    (_F32, 14336, 1, "shared", 1), (_BF16, 4096, 1, "registers", 1),
    (_F32, 58092, 0, "shared", 4), (_F32, 58096, 0, "two_pass", 1),
    (_BF16, 116184, 0, "shared", 8), (_BF16, 116192, 0, "two_pass", 1),
]


@pytest.mark.parametrize("dtype,C,offset,instance,width", _ENCODE_PICKS)
def test_encode_instance_follows_shape_dtype_and_alignment(dtype, C, offset,
                                                           instance, width):
    """The encode kernel takes 16-byte loads only where C and the
    operands' alignment allow them, keeps rows of up to 512 x 8 loads
    and 8,192 elements in registers, stages rows of up to 227 KB less
    its scratch in shared memory, and reads longer ones in two passes."""
    x = torch.zeros(C + offset, dtype=dtype)[offset:].view(1, C)
    noise = torch.zeros(1, C)
    assert int8_codec.encode_instance(x, noise) == (instance, width)
    if not offset:                   # misaligned noise: element loads
        assert int8_codec.encode_instance(
            x, torch.zeros(C + 1)[1:].view(1, C)) == \
            ("shared" if instance == "registers" and C > 4096 else instance,
             1)


def test_encode_limits_match_the_kernel_source():
    """The wrapper's instance limits are the kernel's own constants."""
    import re
    src = build.source("int8_encode").read_text()

    def const(name):
        return re.search(rf"constexpr int(?:64_t)? {name} = ([^;]+);",
                         src).group(1)

    threads, loads = int(const("kEncThreads")), int(const("kEncMaxLoads"))
    assert (threads, loads, int(const("kEncMaxElems"))) == (
        int8_codec.ENC_THREADS, int8_codec.ENC_MAX_LOADS,
        int8_codec.ENC_MAX_ELEMS)
    head = re.fullmatch(r"(\d+) \+ kEncThreads / 32 \* 4",
                        const("kEncHeadBytes")).group(1)
    smem = re.fullmatch(r"(\d+) - kEncHeadBytes",
                        const("kEncRowBytes")).group(1)
    assert int(smem) - int(head) - threads // 32 * 4 == \
        int8_codec.ENC_ROW_BYTES
    assert re.search(r"enum EncodeInstance \{ kEncRegisters = 0, "
                     r"kEncShared = 1, kEncTwoPass = 2 \};", src)
    assert int8_codec.ENCODE_INSTANCES == ("registers", "shared",
                                           "two_pass")
