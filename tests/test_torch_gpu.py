"""The PyTorch port's CUDA kernels and GPU slot engine, on the card.

Every test here is marked `gpu` and skips without a CUDA device.  The
file imports neither `jax` nor the JAX package, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Each kernel must equal its plain PyTorch version on the same GPU tensors
bit for bit (pair_fractions: 1e-12 relative in float64, 1e-6 in
float32, for `exp`; bucket_load_bottleneck in float32 against the
ordered plain sum, which is the order the kernel keeps; the attention
kernels within 1e-5 in float32 and 2e-2 in bfloat16, as the CPU tests
hold the plain versions to the JAX package, since they sum in another
order and the bf16 flash kernel rounds the probabilities to bf16 for
its second product), and the GPU engine must reproduce the CPU plain
path of the same scenario under AR/WAR and under ECMP.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, int8_codec, jsq_route, link_load, \
    ops, plb_select, queue_ecn, ref
from repro_torch.netsim import engine
from repro_torch.netsim.graph import _leaves
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
@pytest.mark.parametrize("S", [1, 2, 3, 8, 16, 17, 32, 33, 64, 1024])
@pytest.mark.parametrize("size", ["small", "large"])
@pytest.mark.parametrize("nbins,temperature,qmax", [(16, 0.25, 8.0),
                                                    (10, 0.3, 6.0)])
def test_pair_fractions_equals_plain_version(cuda, dtype, S, size, nbins,
                                             temperature, qmax):
    """Every row-group width of the warp kernel (S <= 32) and the
    generic path (S > 32).  Row counts are odd, so the last tile and
    the last warp are ragged; the large ones span thousands of blocks.
    Every 7th row has no live spine (all logits -1e30: each fraction is
    1/S), every 7th from the 3rd exactly one.  The engine's constants
    (power-of-two qmax and temperature, which the kernel multiplies by
    their exact reciprocals) and others (which it divides by)."""
    R = 1001 if size == "small" else (1 << 22) // S + 3
    rng = np.random.default_rng(S)
    q = _uniform(rng, (R, S), dtype, cuda, hi=12.0)
    cap = _uniform(rng, (R, S), dtype, cuda, zero_frac=0.15)
    cap[::7] = 0.0
    one = torch.arange(3, R, 7, device=cuda)
    cap[one] = 0.0
    cap[one, one % S] = 0.5
    w = cap * _uniform(rng, (R, S), dtype, cuda)
    kw = dict(nbins=nbins, temperature=temperature, qmax=qmax)
    got = _launched("pair_fractions",
                    lambda: jsq_route.pair_fractions(q, cap, w, **kw))
    want = ref.pair_score_softmax_ref(q, cap, w, **kw)
    torch.testing.assert_close(
        got, want, rtol=1e-12 if dtype == torch.float64 else 1e-6,
        atol=torch.finfo(dtype).tiny)
    assert torch.equal(got[::7], torch.full_like(got[::7], 1.0 / S))
    assert torch.equal(got[one, one % S], torch.ones_like(got[one, 0]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shapes", [
    [(2, 8, 16)],
    [(1,), (37, 3)],
    [(257,), (2, 256, 16), (1,)],
    [(2, 256, 16), (2, 16, 256), (4096, 2), (1001,)]],
    ids=["1", "2", "3", "4"])
def test_bottleneck_many_equals_plain_version(cuda, dtype, shapes):
    """One launch for 1-4 entries of different shapes (a one-element
    entry, lengths that are not multiples of the block), each entry
    bit-equal to the plain version."""
    rng = np.random.default_rng(len(shapes))
    pairs = [(_uniform(rng, sh, dtype, cuda, hi=2.0, zero_frac=0.1),
              _uniform(rng, sh, dtype, cuda, hi=2.0, zero_frac=0.1))
             for sh in shapes]
    got = _launched("bottleneck", lambda: link_load.bottleneck_many(pairs))
    assert len(got) == len(pairs)
    for g, (c, ld) in zip(got, pairs):
        assert g.shape == c.shape and torch.equal(g, ref.bottleneck_ref(c, ld))


@pytest.mark.gpu
def test_bottleneck_many_refuses_bad_groups(cuda):
    x = torch.ones(8, 4, dtype=torch.float64, device=cuda)
    build.reset_launches()
    for pairs, match in (
            ([], "pairs"), ([(x, x)] * 5, "pairs"),
            ([(x, x), (x.float(), x.float())], "dtype"),
            ([(x, x), (x.cpu(), x.cpu())], "on cpu"),
            ([(x.cpu(), x.cpu()), (x, x)], "on cuda"),
            ([(x, x), (x, x[:4])], "shape")):
        with pytest.raises(ValueError, match=match):
            link_load.bottleneck_many(pairs)
    assert build.LAUNCHES["bottleneck"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shapes", [
    [(1,)], [(255,)], [(2, 256, 16)], [(257,), (8193,)],
    [(2, 256, 16), (2, 16, 256)], [(1,), (255,)], [(8193,), (1,)]],
    ids=["1", "255", "8192", "257+8193", "slot", "1+255", "8193+1"])
def test_queue_update_many_equals_plain_version(cuda, dtype, shapes):
    """One launch for one or two entries of ragged lengths, each
    bit-equal to the plain version of its entry; dead links (cap 0 and
    cap just at eps) included."""
    rng = np.random.default_rng(len(shapes) * 10 + shapes[0][0])
    entries = []
    for sh in shapes:
        cap = _uniform(rng, sh, dtype, cuda, hi=1.5, zero_frac=0.15)
        cap.view(-1)[0] = 1e-12
        entries.append((_uniform(rng, sh, dtype, cuda, hi=70.0),
                        _uniform(rng, sh, dtype, cuda, hi=2.0), cap))
    got = _launched("queue_update", lambda: queue_ecn.queue_update_many(
        entries, q_cap=64.0))
    assert len(got) == len(entries)
    for (q_new, u), e in zip(got, entries):
        want_q, want_u = ref.queue_update_ref(*e, q_cap=64.0)
        assert torch.equal(q_new, want_q)
        assert torch.equal(u, want_u)


@pytest.mark.gpu
def test_queue_update_many_refuses_bad_groups(cuda):
    x = torch.ones(8, 4, dtype=torch.float64, device=cuda)
    e = (x, x, x)
    build.reset_launches()
    for entries, match in (
            ([], "entries"), ([e] * 3, "entries"),
            ([e, (x.float(),) * 3], "dtype"),
            ([e, (x.cpu(),) * 3], "on cpu"),
            ([(x.cpu(),) * 3, e], "on cuda"),
            ([(x, x, x[:4])], "shape")):
        with pytest.raises(ValueError, match=match):
            queue_ecn.queue_update_many(entries, q_cap=64.0)
    assert build.LAUNCHES["queue_update"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("F", [1, 255, 257, 102401])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset-1"])
def test_plane_split_equals_plain_version(cuda, dtype, P, F, offset):
    """Every mode, every P the kernel takes (compile-time instances for
    1, 2 and 4; the run-time one for the rest), ragged flow counts, and
    views one element past an aligned start.  Every 7th row has no eligible plane, about a
    fifth of the planes sit at MIN_RATE (spx's rate filter) and every
    5th row has all its planes there (spx falls back to eligibility)."""
    rng = np.random.default_rng(F * 10 + P)

    def view(a, dt):
        store = torch.zeros(a.size + offset, dtype=dt, device=cuda)
        out = store[offset:].view(a.shape)
        out.copy_(torch.as_tensor(a, device=cuda))
        return out

    rate = rng.uniform(0.01, 1.0, (F, P))
    rate[rng.random((F, P)) < 0.2] = 0.01
    rate[::5] = 0.01
    elig = rng.random((F, P)) < 0.75
    elig[::7] = False
    r, e = view(rate, dtype), view(elig, torch.bool)
    d = view(rng.uniform(0.0, 1.0, F), dtype)
    for mode in ("spx", "dcqcn", "agg", "swlb"):
        got = _launched("plane_split", lambda: plb_select.plane_split(
            r, e, d, mode=mode, min_rate=0.01))
        assert torch.equal(got, ref.plane_split_ref(r, e, d, mode=mode,
                                                    min_rate=0.01)), mode


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


def _tail_padded_plan(rng, P, R, C):
    """(P, R, C) plan as the engine builds it (`engine._perm_matrix`):
    each bucket's flows in flow order, pads only at the tail; bucket
    fills 0..C, so some rows are all pads.  Returns (plan, F)."""
    from repro_torch.netsim.engine import _perm_matrix
    keys = np.repeat(np.arange(R), rng.integers(0, C + 1, R))
    F = len(keys)
    return np.stack([_perm_matrix(rng.permutation(keys), R, C, F)
                     for _ in range(P)]), F


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [1, 2, 3, 4])
# one lane group is 8, 16 or 32 lanes wide: C below, at and above each,
# the giga plan's 47 and a C of several passes of 64 columns
@pytest.mark.parametrize("C", [1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 47, 64,
                               65, 200])
@pytest.mark.parametrize("pads", ["anywhere", "tail"])
def test_bucket_load_bottleneck_shapes_equal_plain_version(cuda, dtype, P,
                                                           C, pads):
    rng = np.random.default_rng(C * 8 + P)
    R = 37                             # not a multiple of a block's buckets
    if pads == "tail":
        plan, F = _tail_padded_plan(rng, P, R, C)
    else:
        F = 501
        plan = rng.integers(0, F + 1, (P, R, C))        # F = pad
        plan[:, ::5] = F                                # rows of pads only
    rate = _uniform(rng, (F, P), dtype, cuda, zero_frac=0.1)
    plan = torch.tensor(plan.astype(np.int32), device=cuda)
    cap = _uniform(rng, (P, R), dtype, cuda, hi=2.0, zero_frac=0.1)
    got = _launched("bucket_load_bottleneck",
                    lambda: link_load.bucket_load_bottleneck(rate, plan, cap))
    for g, want in zip(got, ref.load_bottleneck_ref(rate, plan, cap,
                                                    ordered=True)):
        assert torch.equal(g.view(torch.uint8), want.view(torch.uint8))


# (dtype, R, C, instance, elements a load) of each int8_encode instance
_ENCODE_CASES = [
    (torch.float32, 4, 8192, "registers", 4),      # the longest tile
    (torch.bfloat16, 4, 8192, "registers", 8),
    (torch.float32, 37, 1001, "registers", 1),     # element loads
    (torch.bfloat16, 37, 1001, "registers", 1),
    (torch.float32, 3, 4095, "registers", 1),
    (torch.float32, 3, 1, "registers", 1),
    (torch.bfloat16, 3, 1, "registers", 1),
    (torch.float32, 3, 4, "registers", 4),
    (torch.bfloat16, 3, 4, "registers", 1),
    (torch.float32, 4, 14336, "shared", 4),        # a llama3-8b MLP row
    (torch.bfloat16, 4, 14336, "shared", 8),
    (torch.float32, 3, 8196, "shared", 4),
    (torch.bfloat16, 3, 40000, "shared", 8),
    (torch.float32, 3, 4097, "shared", 1),
    (torch.float32, 3, 20001, "shared", 1),
    (torch.float32, 3, 58092, "shared", 4),        # the longest staged row
    (torch.float32, 3, 58096, "two_pass", 1),
    (torch.float32, 3, 58117, "two_pass", 1),
    (torch.bfloat16, 3, 116240, "two_pass", 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,R,C,instance,width", _ENCODE_CASES,
                         ids=[f"{str(d).split('.')[1]}-{r}x{c}-{i}"
                              for d, r, c, i, _ in _ENCODE_CASES])
def test_int8_encode_instances_equal_plain_version(cuda, dtype, R, C,
                                                   instance, width):
    rng = np.random.default_rng(C)
    x = _normal(rng, (R, C), dtype, cuda) * 3
    x[0] = 0.0                                   # an all-zero row
    noise = torch.tensor(rng.uniform(-0.5, 0.5, (R, C)),
                         dtype=torch.float32, device=cuda)
    assert int8_codec.encode_instance(x, noise) == (instance, width)
    q, scale = _launched("int8_encode", lambda: ops.int8_encode(x, noise))
    q_ref, scale_ref = ref.int8_encode_ref(x, noise)
    assert torch.equal(q, q_ref)
    assert torch.equal(scale.view(torch.int32), scale_ref.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_encode_unaligned_rows_take_element_loads(cuda, dtype):
    rng = np.random.default_rng(5)
    R, C = 5, 14336
    base = _normal(rng, (R * C + 1,), dtype, cuda)
    x = base[1:].view(R, C)                      # 2 or 4 bytes off 16
    noise = torch.tensor(rng.uniform(-0.5, 0.5, (R, C)),
                         dtype=torch.float32, device=cuda)
    assert int8_codec.encode_instance(x, noise) == ("shared", 1)
    q, scale = _launched("int8_encode", lambda: ops.int8_encode(x, noise))
    q_ref, scale_ref = ref.int8_encode_ref(x, noise)
    assert torch.equal(q, q_ref)
    assert torch.equal(scale.view(torch.int32), scale_ref.view(torch.int32))
    zeros = torch.zeros((2, 1001), dtype=dtype, device=cuda)
    q, scale = ops.int8_encode(zeros, noise[:2, :1001].contiguous())
    q_ref, scale_ref = ref.int8_encode_ref(zeros, noise[:2, :1001])
    assert torch.equal(q, q_ref)
    assert torch.equal(scale.view(torch.int32), scale_ref.view(torch.int32))


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
@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("N", [1, 31, 4096, 4097])
@pytest.mark.parametrize("kind", ["random", "equal-queues", "none-pass"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset-1"])
def test_plb_select_equals_plain_version(cuda, P, N, kind, offset):
    """Planes at compile time (P = 1, 2, 4) and at run time, packets
    that leave a thread's last accesses partial, pointers off the
    kernel's vector width (offset-1), equal queues (the hashed
    tie-break decides) and allowances no packet's rate meets (every
    eligible plane counts)."""
    rng = np.random.default_rng(1000 * P + N)
    ra = _uniform(rng, (P,), torch.float32, cuda)
    el = (_uniform(rng, (P,), torch.float32, cuda) > 0.2).float()
    lq = _uniform(rng, (P,), torch.float32, cuda)
    if kind == "equal-queues":
        lq.fill_(0.5)
    tx = _uniform(rng, (N + offset,), torch.float32, cuda, lo=0.01,
                  hi=0.6)[offset:]
    h = torch.tensor(rng.integers(0, 1 << 32, N + offset),
                     device=cuda)[offset:]
    if kind == "none-pass":
        ra.zero_()
    got = _launched("plb_select",
                    lambda: plb_select.plb_select(ra, el, lq, tx, h))
    assert torch.equal(got, ref.plb_select_ref(ra, el, lq, tx, h))


def _jsq_operands(rng, ports, N, dev, *, up_frac=0.8, ties=False):
    """Port vectors and N hashes: random queues (20% of them equal) or,
    with `ties`, one queue and one weight for every port, so that the
    hashed tie-break alone decides."""
    if ties:
        q = torch.full((ports,), 0.37, device=dev)
        w = torch.full((ports,), 0.5, device=dev)
    else:
        qa = rng.uniform(0.0, 1.2, ports)
        qa[rng.random(ports) < 0.2] = 0.5
        q = torch.tensor(qa, dtype=torch.float32, device=dev)
        w = _uniform(rng, (ports,), torch.float32, dev, lo=0.25)
    up = torch.tensor((rng.random(ports) < up_frac).astype(np.float32),
                      device=dev)
    h = torch.tensor(rng.integers(0, 1 << 32, N), device=dev)
    return q, up, w, h


@pytest.mark.gpu
@pytest.mark.parametrize("ports", [1, 7, 31, 32, 33, 255, 256, 257, 8192])
@pytest.mark.parametrize("N", [1, 37, 4096, 4097])
def test_jsq_route_equals_plain_version(cuda, ports, N):
    """Groups of lanes a packet: ports below, at and past a group's
    width and a warp's, and packets that leave a block's last groups
    empty."""
    rng = np.random.default_rng(ports * 10007 + N)
    q, up, w, h = _jsq_operands(rng, ports, N, cuda)
    got = _launched("jsq_route", lambda: ops.jsq_route(q, up, w, h))
    assert torch.equal(got, ref.jsq_route_ref(q, up, w, h))


@pytest.mark.gpu
@pytest.mark.parametrize("ports", [1, 7, 33, 256, 8192])
@pytest.mark.parametrize("N", [37, 4097])
@pytest.mark.parametrize("up_frac", [1.0, 0.0], ids=["all-up", "all-down"])
def test_jsq_route_exact_ties_equal_plain_version(cuda, ports, N, up_frac):
    """Every port scores the same, so the hashed tie-break alone decides
    (all down: every value is 1e30 and port 0 must win)."""
    rng = np.random.default_rng(ports + N)
    q, up, w, h = _jsq_operands(rng, ports, N, cuda, up_frac=up_frac,
                                ties=True)
    got = _launched("jsq_route", lambda: ops.jsq_route(q, up, w, h))
    assert torch.equal(got, ref.jsq_route_ref(q, up, w, h))
    if up_frac == 0.0:
        assert not bool(got.any())


@pytest.mark.gpu
@pytest.mark.parametrize("ports", [64, 256])
def test_jsq_route_tie_collisions_take_the_lowest_port(cuda, ports):
    """Packets whose least value two or more ports share (equal scores,
    equal tie-break): the lowest of them must win, as argmin's first
    index does, whichever lanes of a group hold them."""
    rng = np.random.default_rng(ports)
    found, ties = [], []
    while sum(len(f) for f in found) < 16:      # ~1 packet in 1,000
        cand = torch.tensor(rng.integers(0, 1 << 32, 1 << 15))
        tie = ref._hash_tie(cand, ports, 40503)
        shared = (tie == tie.min(1, keepdim=True).values).sum(1) >= 2
        found.append(cand[shared])
        ties.append(tie[shared])
    h, tie = torch.cat(found).to(cuda), torch.cat(ties)
    q = torch.full((ports,), 0.37, device=cuda)
    w = torch.full((ports,), 0.5, device=cuda)
    up = torch.ones(ports, device=cuda)
    got = _launched("jsq_route", lambda: ops.jsq_route(q, up, w, h))
    want = ref.jsq_route_ref(q, up, w, h)
    assert torch.equal(got, want)
    first = tie.argmin(1).to(torch.int32)
    assert torch.equal(want.cpu(), first)


ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _normal(rng, shape, dtype, dev):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=dev).to(dtype)


def _launched(kernel, fn):
    """fn()'s result; fn must launch `kernel` once and nothing else."""
    build.reset_launches()
    out = fn()
    assert build.LAUNCHES == dict(dict.fromkeys(build.KERNELS, 0),
                                  **{kernel: 1})
    torch.cuda.synchronize()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (100, 100, True, 0), (100, 100, False, 0), (130, 130, True, 17),
    (70, 150, True, 0),                          # Sq < Sk, top-left
    (150, 70, False, 20), (150, 70, True, 20),   # rows that see no key
    # the bf16 kernel's tiling: several 128-row blocks and ring stages,
    # a window across tile edges, Sq != Sk both ways, and rows >= 299
    # that see no key with one 128-row block straddling them
    (1000, 1000, True, 0), (4096, 4096, True, 0), (1000, 1000, True, 300),
    (1000, 1000, False, 300), (300, 1000, True, 0), (1000, 300, True, 0),
    (300, 1000, False, 128), (1000, 300, False, 0), (1000, 200, True, 100),
    (1000, 200, False, 100)])
def test_flash_attention_equals_plain_version(cuda, dtype, D, Sq, Sk,
                                              causal, window):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq + Sk + D)
    q = _normal(rng, (2, 3, Sq, D), dtype, cuda)
    k, v = (_normal(rng, (2, 3, Sk, D), dtype, cuda) for _ in range(2))
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window))
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)



# sequence lengths on both sides of the float32 kernel's block (64 or
# 128 query rows) and key tile (32 or 64 keys) edges
_EDGES = (127, 128, 129, 257)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("Sq", _EDGES)
@pytest.mark.parametrize("Sk", _EDGES)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 33), (False, 33)])
def test_flash_attention_f32_tile_edges(cuda, D, Sq, Sk, causal, window):
    """float32 at lengths that straddle the block and tile edges, causal,
    windowed, and (Sq > Sk with a window) rows that see no key."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq * 1000 + Sk + D)
    q = _normal(rng, (1, 2, Sq, D), torch.float32, cuda)
    k, v = (_normal(rng, (1, 2, Sk, D), torch.float32, cuda)
            for _ in range(2))
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window))
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = ATTN_TOL[torch.float32]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bshd_reads_gqa_heads_in_place(cuda, dtype):
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, D = 2, 77, 8, 2, 128
    q = _normal(rng, (B, S, Hq, D), dtype, cuda)
    k, v = (_normal(rng, (B, S, Hkv, D), dtype, cuda) for _ in range(2))
    got = _launched("flash_attention", lambda: ops.flash_attention_bshd(
        q, k, v, window=30))
    assert got.shape == (B, S, Hq, D) and got.is_contiguous()
    kr, vr = (t.repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
              for t in (k, v))
    want = ref.flash_attention_ref(q.transpose(1, 2), kr, vr,
                                   window=30).transpose(1, 2)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 300])
def test_flash_attention_bshd_gqa_head_dim_256(cuda, window):
    rng = np.random.default_rng(window + 5)
    B, S, Hq, Hkv, D = 1, 1000, 8, 2, 256
    q = _normal(rng, (B, S, Hq, D), torch.bfloat16, cuda)
    k, v = (_normal(rng, (B, S, Hkv, D), torch.bfloat16, cuda)
            for _ in range(2))
    got = _launched("flash_attention", lambda: ops.flash_attention_bshd(
        q, k, v, window=window))
    want = ref.flash_attention_bshd_ref(q, k, v, window=window)
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_attention_refuses_layouts_tma_cannot_read(cuda):
    """bf16 operands go through TMA descriptors: a stride that is not a
    multiple of 16 bytes raises before anything launches, as do a
    non-contiguous view and a misaligned base."""
    x = torch.zeros(2 * 64 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    # contiguous for PyTorch (the batch axis has size 1), but its batch
    # stride is 7 elements
    odd = x.as_strided((1, 2, 64, 64), (7, 64 * 64, 64, 1))
    assert odd.is_contiguous()
    good = x[:2 * 64 * 64].view(1, 2, 64, 64)
    build.reset_launches()
    with pytest.raises(ValueError, match="TMA"):
        ops.flash_attention(odd, good, good)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(good, good.transpose(2, 3), good)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(good, good, x[1:1 + 2 * 64 * 64].view(
            1, 2, 64, 64))
    assert build.LAUNCHES["flash_attention"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("S,lengths", [(300, [0, 5, 257]),
                                       (1000, [999, 1000, 1])])
def test_decode_attention_equals_plain_version(cuda, dtype, D, S, lengths):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(S + D)
    q = _normal(rng, (3, 4, 1, D), dtype, cuda)
    k, v = (_normal(rng, (3, 4, S, D), dtype, cuda) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = _launched("decode_attention",
                    lambda: ops.decode_attention(q, k, v, lens))
    want = ref.decode_attention_ref(q, k, v, lens)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(37, 1001), (4, 14336)])
def test_int8_codec_equals_plain_version(cuda, dtype, R, C):
    rng = np.random.default_rng(R)
    x = _normal(rng, (R, C), dtype, cuda) * 5
    x[0] = 0.0                                   # scale from the 1e-12 floor
    noise = torch.tensor(rng.uniform(-0.5, 0.5, (R, C)),
                         dtype=torch.float32, device=cuda)
    q, scale = _launched("int8_encode", lambda: ops.int8_encode(x, noise))
    q_ref, scale_ref = ref.int8_encode_ref(x, noise)
    assert torch.equal(q, q_ref)
    assert torch.equal(scale.view(torch.int32), scale_ref.view(torch.int32))
    got = _launched("int8_decode",
                    lambda: ops.int8_decode(q, scale, dtype=dtype))
    want = ref.int8_decode_ref(q, scale, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.gpu
def test_model_wrappers_refuse_bad_operands(cuda):
    x = torch.zeros(1, 2, 8, 64, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(x, x, x)
    y = torch.zeros(1, 2, 8, 96, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(y, y, y)
    z = torch.zeros(1 + 2 * 8 * 64, dtype=torch.float32,
                    device=cuda)[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="dtype"):
        ops.decode_attention(x[:, :, :1], x, x,
                             torch.zeros(1, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        ops.int8_decode(torch.zeros(4, 8, dtype=torch.int8, device=cuda),
                        torch.ones(4, 1, device=cuda), dtype=torch.float64)


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
    # one grouped bottleneck and one grouped queue_update launch a slot,
    # under AR/WAR and ECMP
    route = ({"bucket_load_bottleneck": 60, "bottleneck": 60}
             if routing == "ecmp" else
             {"pair_fractions": 60, "bottleneck": 60})
    assert build.LAUNCHES == dict(
        dict.fromkeys(build.KERNELS, 0), plane_split=60, queue_update=60,
        nic_update=60, **route)
    cpu = compile_scenario(spec).run(device="cpu")
    np.testing.assert_allclose(gpu.mean_goodput, cpu.mean_goodput,
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(gpu.completion_slot, cpu.completion_slot)
    np.testing.assert_allclose(gpu.util_up_last, cpu.util_up_last,
                               rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# the captured slot loop (netsim/graph.py) against the eager one
# ---------------------------------------------------------------------------

def _eager_and_captured(spec, dev, dtype, handover=0):
    """The eager and the captured loop of one prepared run (from the
    carry after `handover` eager slots when > 0), each with the launches
    it counted."""
    cfg, _, ops_ = engine.prepare(compile_scenario(spec), dev, dtype)
    carry0 = None
    if handover:
        carry0 = engine.init_carry(ops_.fb, cfg)
        for t in range(handover):
            carry0, _ = engine._slot_step(cfg, ops_, carry0, t)
    out = []
    for eager in (True, False):
        build.reset_launches()
        res = engine._simulate(cfg, ops_, carry0, _eager=eager)
        torch.cuda.synchronize()
        out.append((res, dict(build.LAUNCHES)))
    build.reset_launches()
    return cfg, out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,routing,nic,handover", [
    ("fig9_victim_noise", None, "spx", 0),          # AR
    ("fig11_degraded_leaf", None, "dcqcn", 0),      # WAR, one segment
    ("cascading_spine_loss", None, "spx", 0),       # WAR, four segments
    ("cascading_spine_loss", "ar", "global", 0),
    ("cascading_spine_loss", "ecmp", "spx", 0),     # four ECMP plans
    ("fig12_plane_flap", "ecmp", "swlb", 0),
    ("fig12_plane_flap", None, "swlb", 150),        # handed-over carry
    ("cascading_spine_loss", "ecmp", "esr", 150)])
def test_captured_loop_equals_eager_loop(cuda, dtype, name, routing, nic,
                                         handover):
    """The same kernels in the same order: every output equal bit for
    bit, and the launches the replays count equal to the eager loop's
    (fig12's swlb deadline shortened to fire inside the run)."""
    spec = get_scenario(name).with_sim(nic=nic, sw_lb_delay_ms=20.0)
    if routing is not None:
        spec = spec.with_sim(routing=routing)
    cfg, ((eager, n_eager), (captured, n_captured)) = _eager_and_captured(
        spec, cuda, dtype, handover)
    for a, b in zip(captured, eager):
        assert a.dtype == b.dtype and torch.equal(a, b)
    route = ("bucket_load_bottleneck" if cfg.routing == "ecmp"
             else "pair_fractions")
    assert n_captured == n_eager == dict(
        dict.fromkeys(build.KERNELS, 0), plane_split=cfg.slots,
        bottleneck=cfg.slots, queue_update=cfg.slots,
        nic_update=cfg.slots, **{route: cfg.slots})


@pytest.mark.gpu
def test_captured_loop_leaves_the_carry_alone(cuda):
    """A handed-over carry seeds the loop's static buffers and is not
    written by the replays."""
    spec = get_scenario("fig11_degraded_leaf").with_sim(slots=40)
    cfg, _, ops_ = engine.prepare(compile_scenario(spec), cuda,
                                  torch.float64)
    carry0 = engine.init_carry(ops_.fb, cfg)
    for t in range(10):
        carry0, _ = engine._slot_step(cfg, ops_, carry0, t)
    kept = [x.clone() for x in _leaves(carry0)]
    loop = engine.slot_loop(cfg, ops_, carry0)
    loop.capture()
    loop.replay()
    torch.cuda.synchronize()
    assert int(loop.t) == cfg.slots
    for a, b in zip(_leaves(carry0), kept):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_capture_failure_raises(cuda, monkeypatch):
    """An error while the slot is captured reaches the caller, and no
    slot after the eager slot 0 runs: no fallback to the eager loop."""
    spec = get_scenario("fig11_degraded_leaf").with_sim(slots=12)
    cfg, _, ops_ = engine.prepare(compile_scenario(spec), cuda,
                                  torch.float64)
    real = engine.nic_update

    def refused_under_capture(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused under capture")
        return real(*args, **kw)

    monkeypatch.setattr(engine, "nic_update", refused_under_capture)
    build.reset_launches()
    with pytest.raises(RuntimeError, match="refused under capture"):
        engine._simulate(cfg, ops_)
    torch.cuda.synchronize()
    assert build.LAUNCHES == dict(
        dict.fromkeys(build.KERNELS, 0), plane_split=1, pair_fractions=1,
        bottleneck=1, queue_update=1, nic_update=1)
    build.reset_launches()
