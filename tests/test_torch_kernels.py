"""The PyTorch port's slot-engine kernels on the CPU.

On the CPU every wrapper in `repro_torch.kernels` runs its plain PyTorch
version (`repro_torch.kernels.ref`).  Those are held here to the JAX
package's jnp oracles (`repro.kernels.ref`) in float64 — bit for bit,
except the softmax of `pair_fractions`, whose `exp` differs between the
frameworks (relative 1e-12; XLA on the CPU also flushes subnormal
results to zero, hence the absolute floor at the smallest normal) — and
to the Pallas kernels run in interpret mode in float32 (1e-6), over every
mode and shapes with non-power-of-two block tails.  Inputs come from
numpy with a seed and reach both frameworks as the same arrays.

The CUDA kernels themselves run only on a GPU: `tests/test_torch_gpu.py`
holds them against these plain versions there, and `chip_smoke.py` does
so at the main path's shapes.
"""
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
from repro_torch.kernels import build, jsq_route, link_load, plb_select, \
    queue_ecn, ref

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


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain versions, nothing else falls back
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_plain_version_without_launching():
    build.reset_launches()
    rate, elig, demand = _plane_inputs(0, 16, 2)
    got = plb_select.plane_split(*_th(rate, elig, demand), mode="spx",
                                 min_rate=0.01)
    want = ref.plane_split_ref(*_th(rate, elig, demand), mode="spx",
                               min_rate=0.01)
    assert torch.equal(got, want)
    assert set(build.LAUNCHES) == set(build.KERNELS)
    assert all(n == 0 for n in build.LAUNCHES.values())


def _meta(*shape, dtype=torch.float64):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: plb_select.plane_split(_meta(4, 2), _meta(4, 2, dtype=bool),
                                   _meta(4), mode="spx"),
    lambda: jsq_route.pair_fractions(_meta(1, 2, 2, 4), _meta(1, 2, 2, 4),
                                     _meta(1, 2, 2, 4)),
    lambda: link_load.bottleneck(_meta(8), _meta(8)),
    lambda: queue_ecn.queue_update(_meta(8), _meta(8), _meta(8),
                                   q_cap=64.0),
    lambda: queue_ecn.nic_update(_meta(4, 2), _meta(4, 2), _meta(4, 2),
                                 _meta(4, 1, dtype=bool), mode="spx",
                                 **NIC_KW),
], ids=list(build.KERNELS))
def test_non_cpu_tensor_never_falls_back(call):
    build.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert all(n == 0 for n in build.LAUNCHES.values())


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


def test_build_key_tracks_source_and_flags():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libnetsim_kernels_")
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
