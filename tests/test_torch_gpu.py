"""The PyTorch port's CUDA kernels and GPU slot engine, on the card.

Every test here is marked `gpu` and skips without a CUDA device.  The
file imports neither `jax` nor the JAX package, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Each kernel must equal its plain PyTorch version on the same GPU tensors
bit for bit (pair_fractions: 1e-12 relative in float64, 1e-6 in
float32, for `exp`; bucket_load_bottleneck in float32 against the
ordered plain sum, which is the order the kernel keeps), and the GPU
engine must reproduce the CPU plain path of the same scenario under
AR/WAR and under ECMP.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, jsq_route, link_load, ops, \
    plb_select, queue_ecn, ref
from repro_torch.scenarios import compile_scenario, get_scenario

NIC_KW = dict(base_rtt_us=4.0, slot_us=10.0, ecn_thresh=3.0,
              target_rtt_us=12.0, min_rate=0.01, md=0.7, ai=0.08,
              rtt_gain=0.15, dcqcn_ai=0.01, alpha_g=0.0625)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _uniform(rng, shape, dtype, dev, lo=0.0, hi=1.0, zero_frac=0.0):
    a = rng.uniform(lo, hi, shape)
    a[rng.random(shape) < zero_frac] = 0.0
    return torch.tensor(a, dtype=dtype, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_equal_plain_versions(cuda, dtype):
    rng = np.random.default_rng(0)
    F, P, L, S = 1001, 3, 9, 13                  # odd sizes: ragged tails
    rate = _uniform(rng, (F, P), dtype, cuda, lo=0.01)
    elig = torch.tensor(rng.random((F, P)) < 0.8, device=cuda)
    demand = _uniform(rng, (F,), dtype, cuda)
    for mode in ("spx", "dcqcn", "agg", "swlb"):
        assert torch.equal(
            plb_select.plane_split(rate, elig, demand, mode=mode,
                                   min_rate=0.01),
            ref.plane_split_ref(rate, elig, demand, mode=mode,
                                min_rate=0.01)), mode
    q = _uniform(rng, (P, L, L, S), dtype, cuda, hi=12.0)
    cap = _uniform(rng, (P, L, L, S), dtype, cuda, zero_frac=0.15)
    w = cap * _uniform(rng, (P, L, L, S), dtype, cuda)
    torch.testing.assert_close(
        jsq_route.pair_fractions(q, cap, w, nbins=16, temperature=0.25),
        ref.pair_score_softmax_ref(q, cap, w, nbins=16, temperature=0.25),
        rtol=1e-12 if dtype == torch.float64 else 1e-6,
        atol=torch.finfo(dtype).tiny)
    ql = _uniform(rng, (P, L, S), dtype, cuda, hi=70.0)
    load = _uniform(rng, (P, L, S), dtype, cuda, hi=2.0)
    lcap = _uniform(rng, (P, L, S), dtype, cuda, zero_frac=0.15)
    assert torch.equal(link_load.bottleneck(lcap, load),
                       ref.bottleneck_ref(lcap, load))
    for g, want in zip(queue_ecn.queue_update(ql, load, lcap, q_cap=64.0),
                       ref.queue_update_ref(ql, load, lcap, q_cap=64.0)):
        assert torch.equal(g, want)
    qmean = _uniform(rng, (F, P), dtype, cuda, hi=16.0)
    alpha = _uniform(rng, (F, P), dtype, cuda)
    esr = torch.tensor(rng.random((F, 1)) < 0.5, device=cuda)
    for mode in ("spx", "dcqcn", "agg"):
        for g, want in zip(
                queue_ecn.nic_update(qmean, rate, alpha, esr, mode=mode,
                                     **NIC_KW),
                ref.nic_update_ref(qmean, rate, alpha, esr, mode=mode,
                                   **NIC_KW)):
            assert torch.equal(g, want), mode


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bucket_load_bottleneck_equals_plain_version(cuda, dtype):
    rng = np.random.default_rng(1)
    F, P, R, C = 1001, 3, 37, 13                 # odd sizes: ragged tails
    rate = _uniform(rng, (F, P), dtype, cuda, zero_frac=0.1)
    plan = rng.integers(0, F + 1, (P, R, C)).astype(np.int32)  # F = pad
    plan = torch.tensor(plan, device=cuda)
    cap = _uniform(rng, (P, R), dtype, cuda, hi=2.0, zero_frac=0.1)
    got = link_load.bucket_load_bottleneck(rate, plan, cap)
    for g, want in zip(got, ref.load_bottleneck_ref(rate, plan, cap,
                                                    ordered=True)):
        assert torch.equal(g, want)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [37, 4096, 4097])
def test_packet_kernels_equal_plain_versions(cuda, N):
    rng = np.random.default_rng(N)
    h = torch.tensor(rng.integers(0, 1 << 32, N), device=cuda)
    for lanes in (16, 256):
        q = _uniform(rng, (lanes,), torch.float32, cuda, hi=1.2)
        up = (_uniform(rng, (lanes,), torch.float32, cuda) > 0.2).float()
        up[0] = 1.0
        w = _uniform(rng, (lanes,), torch.float32, cuda, lo=0.25)
        assert torch.equal(ops.jsq_route(q, up, w, h),
                           ref.jsq_route_ref(q, up, w, h)), lanes
    for planes in (2, 4, 8):
        ra = _uniform(rng, (planes,), torch.float32, cuda)
        el = (_uniform(rng, (planes,), torch.float32, cuda) > 0.2).float()
        lq = _uniform(rng, (planes,), torch.float32, cuda)
        tx = _uniform(rng, (N,), torch.float32, cuda, hi=0.6)
        assert torch.equal(ops.plb_select(ra, el, lq, tx, h),
                           ref.plb_select_ref(ra, el, lq, tx, h)), planes


@pytest.mark.gpu
def test_wrappers_refuse_bad_operands(cuda):
    x = torch.zeros(8, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        link_load.bottleneck(x, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        link_load.bottleneck(x.T, x.T)
    with pytest.raises(ValueError, match="planes"):
        plb_select.plane_split(torch.zeros(4, 9, dtype=torch.float64,
                                           device=cuda),
                               torch.ones(4, 9, dtype=torch.bool,
                                          device=cuda),
                               torch.zeros(4, dtype=torch.float64,
                                           device=cuda), mode="spx")


@pytest.mark.gpu
@pytest.mark.parametrize("name,nic,routing", [
    ("fig11_degraded_leaf", "spx", None),
    ("fig12_plane_flap", "swlb", None),
    ("fig9_victim_noise", "dcqcn", None),
    ("fig11_degraded_leaf", "esr", "ecmp"),
    ("fig12_plane_flap", "spx", "ecmp")])
def test_gpu_engine_reproduces_cpu_path(cuda, name, nic, routing):
    spec = get_scenario(name).with_sim(slots=60, nic=nic)
    if routing is not None:
        spec = spec.with_sim(routing=routing)
    build.reset_launches()
    gpu = compile_scenario(spec).run(device=cuda)
    route = ({"bucket_load_bottleneck": 60, "bottleneck": 120}
             if routing == "ecmp" else
             {"pair_fractions": 60, "bottleneck": 240})
    assert build.LAUNCHES == dict(
        dict.fromkeys(build.KERNELS, 0), plane_split=60, queue_update=120,
        nic_update=60, **route)
    cpu = compile_scenario(spec).run(device="cpu")
    np.testing.assert_allclose(gpu.mean_goodput, cpu.mean_goodput,
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(gpu.completion_slot, cpu.completion_slot)
    np.testing.assert_allclose(gpu.util_up_last, cpu.util_up_last,
                               rtol=1e-12, atol=1e-15)
