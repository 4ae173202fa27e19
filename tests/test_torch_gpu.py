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
path of the same scenario under AR/WAR and under ECMP.  Over a lane
axis, bucket_load_bottleneck must equal its plain version and its
single-lane launches, each lane of a batch or a megabatch grid must
equal its point run alone on the card (per-flow outputs bit for bit,
series within 1e-12), and the captured batched and traced loops must
equal their eager loops bit for bit.  The flow-ordered segment sum
must equal its plain version bit for bit (lanes, skewed and empty
buckets, chunk folds), and sparse and chunked runs must equal the dense
run and their own eager loops bit for bit.  The flash backward must stay
within BWD_TOL of its plain version times the largest gradient (float32
2e-5, bfloat16 1e-2: the sums run in another order, and bf16 gradients
are rounded once more), and repeat bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, int8_codec, jsq_route, link_load, \
    ops, plb_select, queue_ecn, ref
from repro_torch.netsim import engine, graph
from repro_torch.netsim.graph import _leaves
from repro_torch.scenarios import compile_scenario, get_scenario

NIC_KW = dict(base_rtt_us=4.0, slot_us=10.0, ecn_thresh=3.0,
              target_rtt_us=12.0, min_rate=0.01, md=0.7, ai=0.08,
              rtt_gain=0.15, dcqcn_ai=0.01, alpha_g=0.0625)


@pytest.fixture
def cuda():
    """The card, with the graph cache emptied first: each test starts
    cold, so its loops capture as a first call does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    graph.clear_graph_cache()
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
def test_pair_fractions_at_the_giga_fat_tree_shape(cuda, dtype):
    """(P, L, L, J) = (2, 256, 256, 32): the giga fat tree splits each
    leaf pair over 32 cores, the widest row the warp kernel takes, with
    the cross-pod pairs' stage-B capacity folded into `cap`."""
    rng = np.random.default_rng(32)
    shape = (2, 256, 256, 32)
    q = _uniform(rng, shape, dtype, cuda, hi=20.0)
    cap = _uniform(rng, shape, dtype, cuda, zero_frac=0.1)
    cap[:, :16, :16] = 0.0                       # a dead corner
    w = cap * _uniform(rng, shape, dtype, cuda)
    got = _launched("pair_fractions", lambda: jsq_route.pair_fractions(
        q, cap, w, nbins=16, temperature=0.25))
    want = ref.pair_score_softmax_ref(q, cap, w, nbins=16, temperature=0.25)
    torch.testing.assert_close(
        got, want, rtol=1e-12 if dtype == torch.float64 else 1e-6,
        atol=torch.finfo(dtype).tiny)
    assert torch.equal(got[:, :16, :16],
                       torch.full_like(got[:, :16, :16], 1.0 / 32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shapes", [
    [(2, 8, 16)],
    [(1,), (37, 3)],
    [(257,), (2, 256, 16), (1,)],
    [(2, 256, 16), (2, 16, 256), (4096, 2), (1001,)],
    [(1,), (2, 8, 4), (257,), (2, 2, 8), (1001,)],
    [(2, 256, 16), (2, 16, 256), (2, 16, 32), (2, 16, 32), (4096, 2),
     (4096, 2)],
    [(255,), (1,), (257,), (37, 3), (1,), (8193,)]],
    ids=["1", "2", "3", "4", "5", "6-giga-fat-tree", "6-ragged"])
def test_bottleneck_many_equals_plain_version(cuda, dtype, shapes):
    """One launch for 1-6 entries of different shapes (a one-element
    entry, lengths that are not multiples of the block; six: a giga
    fat-tree slot's group), each entry bit-equal to the plain
    version."""
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
            ([], "pairs"), ([(x, x)] * 7, "pairs"),
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
    [(2, 256, 16), (2, 16, 256)], [(1,), (255,)], [(8193,), (1,)],
    [(257,), (1,), (8193,)],
    [(2, 256, 16), (2, 16, 256), (2, 16, 32), (2, 16, 32)],
    [(1,), (255,), (8193,), (1,)]],
    ids=["1", "255", "8192", "257+8193", "slot", "1+255", "8193+1",
         "257+1+8193", "fat-tree-slot", "1+255+8193+1"])
def test_queue_update_many_equals_plain_version(cuda, dtype, shapes):
    """One launch for one to four entries of ragged lengths (four: a
    giga fat-tree slot's stage-A and stage-B queues), each bit-equal to
    the plain version of its entry; dead links (cap 0 and cap just at
    eps) included."""
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
            ([], "entries"), ([e] * 5, "entries"),
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
@pytest.mark.parametrize("name,nic,routing,slots", [
    ("fig11_degraded_leaf", "spx", None, 60),
    ("fig12_plane_flap", "swlb", None, 60),
    ("fig9_victim_noise", "dcqcn", None, 60),
    ("fig11_degraded_leaf", "esr", "ecmp", 60),
    ("fig12_plane_flap", "spx", "ecmp", 60),
    ("ft_core_failure_resiliency", "spx", None, 120),
    ("ft_cross_pod_all2all", "dcqcn", "ecmp", 60),
    ("reroute_random_failures_ft", "spx", None, 120),
    ("reroute_random_failures", "spx", "war", 120)])
def test_gpu_engine_reproduces_cpu_path(cuda, name, nic, routing, slots):
    """Leaf-spine and fat-tree fabrics, with and without failure
    reaction (the blackhole series too): one grouped bottleneck and one
    grouped queue_update launch a slot."""
    spec = get_scenario(name).with_sim(slots=slots, nic=nic)
    if routing is not None:
        spec = spec.with_sim(routing=routing)
    build.reset_launches()
    gpu = compile_scenario(spec).run(device=cuda)
    route = ({"bucket_load_bottleneck": slots, "bottleneck": slots}
             if spec.sim.routing == "ecmp" else
             {"pair_fractions": slots, "bottleneck": slots})
    assert build.LAUNCHES == dict(
        dict.fromkeys(build.KERNELS, 0), plane_split=slots,
        queue_update=slots, nic_update=slots, **route)
    cpu = compile_scenario(spec).run(device="cpu")
    np.testing.assert_allclose(gpu.mean_goodput, cpu.mean_goodput,
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(gpu.completion_slot, cpu.completion_slot)
    np.testing.assert_allclose(gpu.util_up_last, cpu.util_up_last,
                               rtol=1e-12, atol=1e-15)
    assert (gpu.blackhole_timeline is None) == (spec.reaction is None)
    if spec.reaction is not None:
        assert cpu.blackhole_timeline.sum() > 0
        np.testing.assert_allclose(gpu.blackhole_timeline,
                                   cpu.blackhole_timeline, rtol=1e-12,
                                   atol=1e-15)


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
            carry0, *_ = engine._slot_step(cfg, ops_, carry0, t)
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
    ("cascading_spine_loss", "ecmp", "esr", 150),
    ("ft_core_failure_resiliency", None, "spx", 0),  # fat tree, WAR
    ("ft_core_failure_resiliency", "ecmp", "dcqcn", 0),
    ("ft_cross_pod_all2all", "war", "spx", 150),
    ("reroute_random_failures_ft", None, "spx", 0),  # reaction, ECMP
    ("poisson_flap_storm", "ar", "spx", 0),          # reaction, AR
    ("reroute_random_failures", "war", "swlb", 105)])
def test_captured_loop_equals_eager_loop(cuda, dtype, name, routing, nic,
                                         handover):
    """The same kernels in the same order: every output equal bit for
    bit (the blackhole series under failure reaction too), and the
    launches the replays count equal to the eager loop's (fig12's swlb
    deadline shortened to fire inside the run); on a fat tree the
    stage-B queues ride in the static carry buffers."""
    spec = get_scenario(name).with_sim(nic=nic, sw_lb_delay_ms=20.0)
    if routing is not None:
        spec = spec.with_sim(routing=routing)
    cfg, ((eager, n_eager), (captured, n_captured)) = _eager_and_captured(
        spec, cuda, dtype, handover)
    assert len(captured) == len(eager) == (5 if cfg.react else 4)
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


# ---------------------------------------------------------------------------
# the lane axis: batches of points, megabatch grids and traces
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,C", [(1, 7), (2, 47), (3, 65), (4, 200)])
def test_bucket_load_bottleneck_lane_axis(cuda, dtype, P, C):
    """B = 4 lanes in one launch: bit-equal to the plain version of the
    batch and to four single-lane launches, each lane's pad reading its
    own zero."""
    rng = np.random.default_rng(P * 100 + C)
    B, R, F = 4, 37, 501
    rate = _uniform(rng, (B, F, P), dtype, cuda, zero_frac=0.1)
    plan = rng.integers(0, F + 1, (B, P, R, C))
    plan[:, :, ::5] = F
    plan = torch.tensor(plan.astype(np.int32), device=cuda)
    cap = _uniform(rng, (B, P, R), dtype, cuda, hi=2.0, zero_frac=0.1)
    got = _launched("bucket_load_bottleneck",
                    lambda: link_load.bucket_load_bottleneck(rate, plan, cap))
    want = ref.load_bottleneck_ref(rate, plan, cap, ordered=True)
    for g, w in zip(got, want):
        assert g.shape == (B, P, R)
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    for b in range(B):
        one = link_load.bucket_load_bottleneck(rate[b], plan[b], cap[b])
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


def _batch_points(name, starts, slots, trace=None, **sim):
    """Compiled points of one structure: `name`'s first fault moved to
    each of `starts` (None: as registered), `sim` overrides per point
    from the dicts in `sim["lanes"]`."""
    import dataclasses
    lanes = sim.pop("lanes", [{}] * len(starts))
    out = []
    for start, extra in zip(starts, lanes):
        spec = get_scenario(name).with_sim(slots=slots, **sim, **extra)
        if trace is not None:
            spec = spec.with_sim(trace=trace)
        if start is not None:
            f0 = dataclasses.replace(spec.faults[0], start_slot=start)
            spec = dataclasses.replace(spec, faults=(f0,) + spec.faults[1:])
        out.append(compile_scenario(spec))
    return out


def _assert_lane_equals(got, want):
    for f in ("mean_goodput", "completion_slot", "util_up_last"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    np.testing.assert_allclose(got.total_goodput, want.total_goodput,
                               rtol=1e-12, atol=0)
    if want.blackhole_timeline is not None:
        np.testing.assert_allclose(got.blackhole_timeline,
                                   want.blackhole_timeline, rtol=1e-12,
                                   atol=1e-300)
    assert (got.trace is None) == (want.trace is None)
    for k in (want.trace or {}):
        np.testing.assert_array_equal(got.trace[k], want.trace[k], k)


# (scenario, fault starts, slots, sim overrides)
GPU_BATCHES = [
    ("fig11_degraded_leaf", [None] * 4, 60,
     dict(routing="ecmp", lanes=[dict(seed=s) for s in range(4)])),
    ("reroute_random_failures", [40, 70, 100], 130, {}),
    ("ft_core_failure_resiliency", [30, 60, 61], 90, {}),
    ("cascading_spine_loss", [100, 150], 200, dict(routing="ar",
                                                   nic="dcqcn")),
    ("ft_cross_pod_all2all", [None] * 3, 40,
     dict(routing="ecmp", lanes=[dict(seed=s) for s in range(3)]))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,starts,slots,sim", GPU_BATCHES)
def test_gpu_batch_lanes_equal_single_runs(cuda, name, starts, slots, sim):
    """`run_compiled_batch` on the card: each lane equals its point run
    alone on the card (per-flow outputs bit for bit, series within
    1e-12), with 5 hand-written launches a slot whatever the lanes."""
    points = _batch_points(name, starts, slots, **dict(sim))
    build.reset_launches()
    got = engine.run_compiled_batch(points, device=cuda)
    per_slot = {k: n // slots for k, n in build.LAUNCHES.items() if n}
    assert sum(per_slot.values()) == 5
    assert all(n == slots * per_slot[k] for k, n in build.LAUNCHES.items()
               if n)
    for c, g in zip(points, got):
        _assert_lane_equals(g, c.run(device=cuda))
    build.reset_launches()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,starts,slots,sim", GPU_BATCHES)
def test_captured_batched_loop_equals_eager(cuda, dtype, name, starts,
                                            slots, sim):
    """The captured loop over a lane axis equals the eager one bit for
    bit, traced fields included, with the same launches."""
    from repro_torch.trace import TraceSpec
    trace = TraceSpec(enabled=True, every=3)
    points = _batch_points(name, starts, slots, trace=trace, **dict(sim))
    cfg, trace, _, ops_ = engine.prepare_batch(points, cuda, dtype)
    out = []
    for eager in (True, False):
        build.reset_launches()
        res = engine._simulate(cfg, ops_, trace=trace, _eager=eager)
        torch.cuda.synchronize()
        out.append((res, dict(build.LAUNCHES)))
    (a, na), (b, nb) = out
    assert na == nb
    assert len(a) == len(b) == (5 if cfg.react else 4) + 5
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    build.reset_launches()


@pytest.mark.gpu
@pytest.mark.parametrize("every", [1, 7])
@pytest.mark.parametrize("name,routing", [("fig12_plane_flap", None),
                                          ("cascading_spine_loss", "ecmp"),
                                          ("reroute_random_failures_ft",
                                           None)])
def test_captured_trace_equals_eager_trace(cuda, every, name, routing):
    """A traced point: the captured records equal the eager ones bit for
    bit, the launches are those of the untraced run, and the trace
    equals the CPU path's (1e-12 relative; exactly for eligible)."""
    from repro_torch.trace import TraceSpec
    trace = TraceSpec(enabled=True, every=every)
    spec = get_scenario(name).with_sim(slots=150, trace=trace)
    if routing is not None:
        spec = spec.with_sim(routing=routing)
    cfg, _, ops_ = engine.prepare(compile_scenario(spec), cuda,
                                  torch.float64)
    out = []
    for eager in (True, False):
        build.reset_launches()
        res = engine._simulate(cfg, ops_, trace=trace, _eager=eager)
        torch.cuda.synchronize()
        out.append((res, dict(build.LAUNCHES)))
    (a, na), (b, nb) = out
    assert na == nb and sum(na.values()) == 5 * cfg.slots
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    gpu = compile_scenario(spec).run(device=cuda)
    cpu = compile_scenario(spec).run(device="cpu")
    for k in cpu.trace:
        if cpu.trace[k].dtype == bool or k == "slot":
            np.testing.assert_array_equal(gpu.trace[k], cpu.trace[k], k)
        else:
            np.testing.assert_allclose(gpu.trace[k], cpu.trace[k],
                                       rtol=1e-12, atol=1e-15, err_msg=k)
    build.reset_launches()


@pytest.mark.gpu
def test_gpu_megabatch_rows_equal_single_runs(cuda):
    """`run_megabatch` on the card over two flow buckets x routing x NIC,
    a traced half: each row equals its point run alone on the card, with
    one captured loop per (bucket, routing, NIC) sub-batch."""
    from repro_torch.netsim import megabatch
    from repro_torch.trace import TraceSpec
    points = []
    for name in ("flap_during_incast", "staggered_incast_bursts"):
        for routing in ("ar", "war", "ecmp"):
            for nic in ("spx", "dcqcn"):
                for seed in (0, 1):
                    spec = get_scenario(name).with_sim(
                        slots=48, routing=routing, nic=nic, seed=seed)
                    if seed:
                        spec = spec.with_sim(trace=TraceSpec(enabled=True))
                    points.append(compile_scenario(spec))
    engine.reset_dispatch_stats()
    got = megabatch.run_megabatch(points, device=cuda)
    stats = engine.dispatch_stats()
    assert stats["loops"] == 24 and stats["graphs"] >= 24
    for c, g in zip(points, got):
        _assert_lane_equals(g, c.run(device=cuda))


# ---------------------------------------------------------------------------
# the Experiment API's executor on the card
# ---------------------------------------------------------------------------

def _cut_experiment(name, slots):
    """A library experiment with its base spec, or the specs its
    "scenario" axis names, cut to `slots` slots (labels kept)."""
    import dataclasses
    from repro_torch.experiments import Axis, get_experiment

    def cut(g):
        if isinstance(g, Axis):
            if g.path != "scenario":
                return g
            return Axis("scenario", tuple(
                get_scenario(v).with_sim(slots=slots) for v in g.values),
                labels=g.values)
        if isinstance(g, tuple):
            return tuple(cut(x) for x in g)
        return type(g)(tuple(cut(x) for x in g.grids))

    exp = get_experiment(name)
    base = exp.base
    if base is not None:
        base = (get_scenario(base) if isinstance(base, str) else base) \
            .with_sim(slots=slots)
    return dataclasses.replace(exp, base=base, axes=cut(exp.axes))


def _assert_rows_close(got, want, tol):
    """Distilled rows field by field, `extra` included: floats within
    `tol` (NaN equal to NaN), everything else exactly."""
    import math

    def close(g, w, path):
        if isinstance(w, float):
            assert (math.isnan(g) and math.isnan(w)) or \
                math.isclose(g, w, rel_tol=tol, abs_tol=tol), (path, g, w)
        elif isinstance(w, dict):
            assert g.keys() == w.keys(), path
            for k in w:
                close(g[k], w[k], f"{path}.{k}")
        elif isinstance(w, (list, tuple)):
            assert len(g) == len(w), path
            for i, (a, b) in enumerate(zip(g, w)):
                close(a, b, f"{path}[{i}]")
        else:
            assert g == w, (path, g, w)

    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g.to_dict(), w.to_dict(), g.scenario)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fig9_isolation", "reroute_reaction"])
def test_gpu_experiment_rows_equal_cpu_rows(cuda, name):
    """`run_experiment` on the card (megabatch, captured loops) against
    the CPU path of the same grid: the CPU contract, 1e-5 (80 slots:
    reroute_reaction's rehash lag of detect + converge slots must stay
    inside the run)."""
    from repro_torch.experiments import run_experiment
    exp = _cut_experiment(name, 80)
    gpu = run_experiment(exp, device=cuda)
    cpu = run_experiment(exp, device="cpu")
    assert gpu.flight["executions"][0]["device"] == "cuda"
    assert gpu.column("axis.scenario") == cpu.column("axis.scenario")
    _assert_rows_close(gpu.to_metrics(), cpu.to_metrics(), 1e-5)


@pytest.mark.gpu
def test_gpu_executor_pipelines_its_sub_batches(cuda):
    """topo_kind_resiliency runs as 4 loops (kind x routing): the host
    prep of each next sub-batch is issued while the last one's loop is
    on the device, and every row equals its point run alone."""
    from repro_torch.experiments import execute_points
    from repro_torch.scenarios import run_point
    exp = _cut_experiment("topo_kind_resiliency", 60)
    specs = [p.spec for p in exp.points()]
    fl = {}
    rows = execute_points(specs, device=cuda, derive=exp.derive, flight=fl)
    pipe = fl["pipeline"]
    assert pipe["pipelined"] and pipe["launches"] == 4 == len(pipe["loops"])
    assert fl["dispatch_stats"]["loops"] == 4
    assert fl["dispatch_stats"]["graphs"] >= 4
    walls = fl["walls"]
    assert walls["loop_s"] > 0 and walls["capture_s"] > 0
    assert 0 <= walls["overlap_s"] <= walls["prep_s"]
    single = [run_point(s, cuda, derive=exp.derive) for s in specs]
    _assert_rows_close(rows, single, 1e-12)


@pytest.mark.gpu
def test_captured_and_eager_executors_give_equal_rows(cuda, monkeypatch):
    """The executor over captured loops against the same executor with
    every loop run eagerly on the card: equal rows."""
    from functools import partial
    from repro_torch.experiments import execute_points
    exp = _cut_experiment("fig9_isolation", 60)
    specs = [p.spec for p in exp.points()]
    captured = execute_points(specs, device=cuda, derive=exp.derive)
    monkeypatch.setattr(engine, "_simulate",
                        partial(engine._simulate, _eager=True))
    fl = {}
    eager = execute_points(specs, device=cuda, derive=exp.derive, flight=fl)
    assert fl["dispatch_stats"]["graphs"] == 0
    _assert_rows_close(captured, eager, 0.0)


# ---------------------------------------------------------------------------
# training-step schedules (demand timelines) on the card
# ---------------------------------------------------------------------------

_SCHEDULES = ("train_step_baseline", "train_step_flap", "train_step_flap_moe")


@pytest.mark.gpu
@pytest.mark.parametrize("routing", [None, "ecmp", "war"])
@pytest.mark.parametrize("name", _SCHEDULES)
def test_gpu_schedule_reproduces_cpu_path(cuda, name, routing):
    """A schedule run on the card (captured, float64) against the CPU
    plain path: per-flow outputs within 1e-12, completion slots and step
    times equal, 5 hand-written launches a slot; the flaps show the
    study's signature."""
    spec = get_scenario(name)
    if routing is not None:
        spec = spec.with_sim(routing=routing)
    c = compile_scenario(spec)
    build.reset_launches()
    gpu = c.run(device=cuda)
    T = spec.sim.slots
    route = ({"bucket_load_bottleneck": T} if spec.sim.routing == "ecmp"
             else {"pair_fractions": T})
    assert build.LAUNCHES == dict(
        dict.fromkeys(build.KERNELS, 0), plane_split=T, bottleneck=T,
        queue_update=T, nic_update=T, **route)
    cpu = compile_scenario(spec).run(device="cpu")
    np.testing.assert_allclose(gpu.mean_goodput, cpu.mean_goodput,
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(gpu.completion_slot, cpu.completion_slot)
    st = c.schedules[0].step_times(gpu.completion_slot, T)
    np.testing.assert_array_equal(
        st, c.schedules[0].step_times(cpu.completion_slot, T))
    if "flap" in name:
        assert st[1] >= 1.2 * st[0] and st[2] <= 1.1 * st[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,routing", [
    ("train_step_baseline", None), ("train_step_flap", None),
    ("train_step_flap", "ecmp"), ("train_step_flap_moe", "war"),
    ("train_step_flap_moe", "ecmp")])
def test_schedule_captured_loop_equals_eager_loop(cuda, dtype, name,
                                                  routing):
    """One graph a segment, phase boundaries included: the captured
    loop equals the eager one bit for bit, with the eager loop's
    launches."""
    spec = get_scenario(name)
    if routing is not None:
        spec = spec.with_sim(routing=routing)
    cfg, ((eager, n_eager), (captured, n_captured)) = _eager_and_captured(
        spec, cuda, dtype)
    assert cfg.n_phases == 4
    for a, b in zip(captured, eager, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert n_captured == n_eager


@pytest.mark.gpu
def test_gpu_megabatch_mixes_schedule_and_plain_lanes(cuda):
    """Schedule and plain points of one fabric and flow bucket share a
    captured loop a (routing, NIC); each lane equals its point alone on
    the card."""
    import dataclasses
    from repro_torch.netsim import megabatch
    from repro_torch.scenarios.spec import WorkloadSpec
    plain = dataclasses.replace(get_scenario("train_step_flap"),
                                name="train_topo_all2all",
                                workloads=(WorkloadSpec("all2all",
                                                        demand=0.5),))
    specs = [get_scenario("train_step_baseline"),
             get_scenario("train_step_flap"), plain,
             get_scenario("train_step_flap").with_sim(routing="ecmp"),
             plain.with_sim(routing="ecmp", seed=3)]
    points = [compile_scenario(s) for s in specs]
    engine.reset_dispatch_stats()
    got = megabatch.run_megabatch(points, device=cuda)
    assert engine.dispatch_stats()["loops"] == 2
    for c, g in zip(points, got):
        _assert_lane_equals(g, c.run(device=cuda))


# ---------------------------------------------------------------------------
# sparse aggregation: the flow-ordered segment sum and its slot paths
# ---------------------------------------------------------------------------

def _seg_plan(keys: np.ndarray, K: int, dev, chunk=None):
    """A CSR plan (int32, on `dev`) of row-major (F, P) `keys`, in chunks
    of `chunk` flows (one chunk by default)."""
    F = keys.shape[0]
    chunk = chunk or F
    p = engine._csr([(np.arange(F), keys)], K, chunk, -(-F // chunk))
    return p._replace(offsets=torch.as_tensor(p.offsets, device=dev),
                      entries=torch.as_tensor(p.entries, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("F,P,K,skew", [(102_400, 2, 8192, False),
                                        (5000, 4, 300, True),
                                        (37, 1, 100, False)])
def test_segment_sum_equals_plain_version(cuda, dtype, F, P, K, skew):
    """Bit for bit against the plain version: one call, empty buckets
    +0.0, a skewed bucket holding half the entries, a fold over chunks
    of 1000 flows (a tail included), and three lanes' plans stacked as
    one launch; no atomics, so two launches agree too."""
    rng = np.random.default_rng(F)
    vals = _uniform(rng, (F, P), dtype, cuda, zero_frac=0.1)
    keys = rng.integers(0, K - 1, (F, P))          # bucket K - 1 empty
    if skew:
        keys[: F // 2] = 3
    plan = _seg_plan(keys, K, cuda)
    want = ref.segment_sum_ref(vals, plan.offsets, plan.entries)
    build.reset_launches()
    got = link_load.segment_sum(vals, plan)
    assert build.LAUNCHES["segment_sum"] == 1
    assert torch.equal(got, want) and torch.equal(
        link_load.segment_sum(vals, plan), got)
    assert got[K - 1].item() == 0.0 and not torch.signbit(got[K - 1])
    chunked = _seg_plan(keys, K, cuda, 1000)
    nc = -(-F // 1000)
    acc = None
    for c in range(nc):
        acc = link_load.segment_sum(
            vals[c * 1000:(c + 1) * 1000].contiguous(),
            engine._chunk_plan(chunked, c, nc), acc=acc)
    assert torch.equal(acc, want)
    # lanes: three points' plans over their stacked (3, F, P) values
    from repro_torch.netsim.carry import _stack_plan
    lanes = [(_uniform(rng, (F, P), dtype, cuda),
              rng.integers(0, K, (F, P))) for _ in range(3)]
    plans = [_seg_plan(k, K, cuda) for _, k in lanes]
    stacked = _stack_plan(plans, 1, F * P)
    got = link_load.segment_sum(torch.stack([v for v, _ in lanes]), stacked)
    assert torch.equal(got.view(3, K), torch.stack([
        ref.segment_sum_ref(v, p.offsets, p.entries)
        for (v, _), p in zip(lanes, plans)]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_many_groups_six_entries(cuda, dtype):
    """Six (vals, plan) entries of different widths in one launch (each
    at its own lanes a bucket: 1, 2 and 16 among them), each its own sum, the
    accumulating form in place, and the bottleneck epilogue on some
    entries, bit-equal to `ref.bottleneck_ref` of the plain sums."""
    rng = np.random.default_rng(3)
    items = []
    for k, K in enumerate((40, 300, 57, 130, 2000, 9)):
        F = 300 + 7 * k
        items.append((_uniform(rng, (F, 2), dtype, cuda),
                      _seg_plan(rng.integers(0, K, (F, 2)), K, cuda)))
    lanes = {link_load.segment_lanes_log2(p.offsets.numel() - 1,
                                          p.entries.numel(), p.width)
             for _, p in items}
    assert lanes == {0, 1, 4}
    build.reset_launches()
    outs = link_load.segment_sum_many(items)
    acc = tuple(torch.ones_like(o) for o in outs)
    link_load.segment_sum_many(items, acc=acc)
    caps = tuple(None if k % 3 == 1 else
                 _uniform(rng, o.shape, dtype, cuda, hi=8.0, zero_frac=0.1)
                 for k, o in enumerate(outs))
    sums, scales = link_load.segment_sum_many(items, caps=caps)
    assert build.LAUNCHES["segment_sum"] == 3
    for o, a, s, c, sc, (v, p) in zip(outs, acc, sums, caps, scales, items):
        want = ref.segment_sum_ref(v, p.offsets, p.entries)
        assert torch.equal(o, want) and torch.equal(s, want)
        assert torch.equal(a, ref.segment_sum_ref(
            v, p.offsets, p.entries, acc=torch.ones_like(o)))
        assert (sc is None) == (c is None)
        if c is not None:
            assert torch.equal(sc, ref.bottleneck_ref(c, want))


def _lens_plan(rng, lens, n_vals: int, dev):
    """A CSR plan (on `dev`) whose buckets hold `lens` entries each,
    random flat indices into `n_vals` values."""
    lens = np.asarray(lens)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    entries = rng.integers(0, n_vals, int(lens.sum())).astype(np.int32)
    return link_load.SegmentPlan(torch.as_tensor(offsets, device=dev),
                                 torch.as_tensor(entries, device=dev),
                                 int(lens.max(initial=0)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_segment_sum_at_each_lane_group(cuda, monkeypatch, dtype, G):
    """At every lanes-a-bucket G the kernel ships: buckets of 0, 1, G-1,
    G, G+1 and 3G+5 entries (several passes; buckets of one warp of
    different lengths), their sums and epilogue scales, the form that
    accumulates, and a fold over chunks whose tail is shorter, each bit
    for bit as the plain versions; three lanes' plans stacked as one
    launch too."""
    monkeypatch.setattr(link_load, "segment_lanes_log2",
                        lambda K, E, width: G.bit_length() - 1)
    rng = np.random.default_rng(G)
    lens = [0, 1, max(G - 1, 0), G, G + 1, 3 * G + 5] * 40
    rng.shuffle(lens)
    vals = _uniform(rng, (997, 2), dtype, cuda, zero_frac=0.1)
    plan = _lens_plan(rng, lens, vals.numel(), cuda)
    want = ref.segment_sum_ref(vals, plan.offsets, plan.entries)
    cap = _uniform(rng, want.shape, dtype, cuda, hi=4.0, zero_frac=0.1)
    (got,), (scale,) = link_load.segment_sum_many(((vals, plan),),
                                                  caps=(cap,))
    assert torch.equal(got, want)
    assert torch.equal(scale, ref.bottleneck_ref(cap, want))
    start = _uniform(rng, want.shape, dtype, cuda)
    acc = start.clone()
    link_load.segment_sum(vals, plan, acc=acc)
    assert torch.equal(acc, ref.segment_sum_ref(
        vals, plan.offsets, plan.entries, acc=start.clone()))
    # a fold over chunks of 300 flows (a tail of 97), the scale written
    # by the last chunk's launch
    keys = rng.integers(0, 60, (997, 2))
    keys[:200] = 5                           # one long bucket
    chunked = _seg_plan(keys, 60, cuda, 300)
    one = ref.segment_sum_ref(vals, *_seg_plan(keys, 60, cuda)[:2])
    cap = _uniform(rng, one.shape, dtype, cuda, hi=4.0)
    acc = None
    for c in range(4):
        part = (vals[c * 300:(c + 1) * 300].contiguous(),
                engine._chunk_plan(chunked, c, 4))
        if c < 3:
            acc = link_load.segment_sum_many((part,), acc=acc)
        else:
            acc, (scale,) = link_load.segment_sum_many((part,), acc=acc,
                                                       caps=(cap,))
    assert torch.equal(acc[0], one)
    assert torch.equal(scale, ref.bottleneck_ref(cap, one))
    # lanes: three plans over their stacked values
    from repro_torch.netsim.carry import _stack_plan
    lane_vals = [_uniform(rng, (997, 2), dtype, cuda) for _ in range(3)]
    plans = [_lens_plan(rng, np.roll(lens, b), 997 * 2, cuda)
             for b in range(3)]
    got = link_load.segment_sum(torch.stack(lane_vals),
                                _stack_plan(plans, 1, 997 * 2))
    assert torch.equal(got.view(3, -1), torch.stack([
        ref.segment_sum_ref(v, p.offsets, p.entries)
        for v, p in zip(lane_vals, plans)]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_mixed_empty_and_long_buckets(cuda, dtype):
    """A plan mixing empty and 80-entry buckets (the skew of a training
    schedule's pair plan) at the lanes the wrapper picks, bit for bit,
    with its epilogue."""
    rng = np.random.default_rng(80)
    lens = np.where(rng.random(4096) < 0.05, 80, 0)
    lens[rng.random(4096) < 0.02] = rng.integers(1, 80)
    vals = _uniform(rng, (5000, 2), dtype, cuda)
    plan = _lens_plan(rng, lens, vals.numel(), cuda)
    want = ref.segment_sum_ref(vals, plan.offsets, plan.entries)
    cap = _uniform(rng, want.shape, dtype, cuda, hi=100.0)
    (got,), (scale,) = link_load.segment_sum_many(((vals, plan),),
                                                  caps=(cap,))
    assert torch.equal(got, want)
    assert torch.equal(scale, ref.bottleneck_ref(cap, want))


def _mode_env(monkeypatch, mode, chunk=None):
    monkeypatch.setenv("REPRO_JX_AGG", mode)
    if chunk is None:
        monkeypatch.delenv("REPRO_JX_FLOW_CHUNK", raising=False)
    else:
        monkeypatch.setenv("REPRO_JX_FLOW_CHUNK", str(chunk))


@pytest.mark.gpu
@pytest.mark.parametrize("name,routing,slots", [
    ("fig11_degraded_leaf", "war", 60), ("fig11_degraded_leaf", "ecmp", 60),
    ("cascading_spine_loss", "ecmp", 130),
    ("ft_core_failure_resiliency", "war", 120),
    ("ft_core_failure_resiliency", "ecmp", 120),
    ("reroute_random_failures", "ecmp", 120)])
def test_gpu_sparse_equals_dense(cuda, monkeypatch, name, routing, slots):
    """float64 on the card: the sparse run equals the dense run bit for
    bit and launches segment_sum once a slot in place of
    bucket_load_bottleneck and bottleneck (ECMP) or beside
    pair_fractions (AR/WAR)."""
    spec = get_scenario(name).with_sim(slots=slots, routing=routing)
    res = {}
    for mode in ("dense", "sparse"):
        _mode_env(monkeypatch, mode)
        build.reset_launches()
        res[mode] = compile_scenario(spec).run(device=cuda)
        route = ({"bucket_load_bottleneck": slots} if routing == "ecmp"
                 else {"pair_fractions": slots})
        route["bottleneck"] = slots
        if mode == "sparse":
            # the segment sum's epilogue scales the access links and,
            # under ECMP, the fabric links: no bottleneck launch there
            route = dict(route, segment_sum=slots)
            route.pop("bucket_load_bottleneck", None)
            if routing == "ecmp":
                route.pop("bottleneck")
        assert build.LAUNCHES == dict(
            dict.fromkeys(build.KERNELS, 0), plane_split=slots,
            queue_update=slots, nic_update=slots, **route)
    for f in ("mean_goodput", "completion_slot", "total_goodput",
              "util_up_last", "blackhole_timeline"):
        a, b = getattr(res["sparse"], f), getattr(res["dense"], f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b, f)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,routing,chunk", [
    ("cascading_spine_loss", "ecmp", None),       # 2,256 flows
    ("cascading_spine_loss", "ecmp", 1000),       # 3 chunks, a tail
    ("fig11_degraded_leaf", "war", None),
    ("fig11_degraded_leaf", "war", 1000),
    ("ft_core_failure_resiliency", "ecmp", None),  # fat tree, 64 flows
    ("ft_core_failure_resiliency", "ecmp", 17),
    ("ft_core_failure_resiliency", "war", 17),
    ("reroute_random_failures", "ecmp", 17)])     # reaction
def test_sparse_captured_loop_equals_eager_loop(cuda, monkeypatch, dtype,
                                                name, routing, chunk):
    """Sparse and chunked runs: the captured loop equals the eager loop
    bit for bit with the same launches, and a chunked run equals the
    one-pass sparse run."""
    spec = get_scenario(name).with_sim(slots=120, routing=routing)
    _mode_env(monkeypatch, "sparse", chunk)
    cfg, ((eager, n_eager), (captured, n_captured)) = _eager_and_captured(
        spec, cuda, dtype)
    assert cfg.flow_chunk == (chunk or 0)
    for a, b in zip(captured, eager, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert n_captured == n_eager and n_eager["segment_sum"] > 0
    assert n_eager["bucket_load_bottleneck"] == 0
    if chunk:
        _mode_env(monkeypatch, "sparse")
        _, ((one, _), _) = _eager_and_captured(spec, cuda, dtype)
        F = len(compile_scenario(spec).flows)
        for k, (a, b) in enumerate(zip(eager, one, strict=True)):
            if k < 2:                     # per-flow outputs: chunk padded
                a = a[..., :F]
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [None, 17])
def test_sparse_batch_lanes_equal_single_runs(cuda, monkeypatch, chunk):
    """A batch of seeds under sparse aggregation and under chunks of 17
    on the card: each lane equals its point run alone."""
    _mode_env(monkeypatch, "sparse", chunk)
    points = [compile_scenario(get_scenario("fig11_degraded_leaf").with_sim(
        slots=60, routing="ecmp", seed=s)) for s in range(3)]
    got = engine.run_compiled_batch(points, device=cuda)
    for c, g in zip(points, got):
        _assert_lane_equals(g, c.run(device=cuda))


# ---------------------------------------------------------------------------
# the graph cache and the compact carry on the card
# ---------------------------------------------------------------------------

def _results_equal(got, want):
    for f in ("mean_goodput", "completion_slot", "total_goodput",
              "util_up_last", "blackhole_timeline"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a, b, f)
    assert (got.trace is None) == (want.trace is None)
    for k in (want.trace or {}):
        np.testing.assert_array_equal(got.trace[k], want.trace[k], k)


# (scenario, sim overrides of two points of one structure)
_CACHE_POINTS = [
    ("fig12_plane_flap", dict(slots=120, routing="ecmp")),
    ("reroute_random_failures", dict(slots=120)),
    ("cascading_spine_loss", dict(slots=260)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,sim", _CACHE_POINTS)
def test_gpu_rebound_loop_equals_a_fresh_capture(cuda, name, sim):
    """Seed 1 after seed 0 replays seed 0's graphs, rebound, with no
    capture, and equals seed 1 captured in an empty cache bit for
    bit; seed 0's result is unchanged; launch counts are those of a
    captured run."""
    pts = [compile_scenario(get_scenario(name).with_sim(seed=s, **sim))
           for s in (0, 1)]
    want = []
    for c in pts:
        graph.clear_graph_cache()
        build.reset_launches()
        want.append((c.run(device=cuda), dict(build.LAUNCHES)))
    graph.clear_graph_cache()
    first = pts[0].run(device=cuda)
    engine.reset_dispatch_stats()
    build.reset_launches()
    second = pts[1].run(device=cuda)
    assert engine.dispatch_stats() == {"loops": 1, "graphs": 0}
    assert graph.graph_cache_stats()["hits"] == 1
    assert dict(build.LAUNCHES) == want[1][1]
    _results_equal(second, want[1][0])
    _results_equal(first, want[0][0])


@pytest.mark.gpu
def test_gpu_warm_rerun_captures_nothing(cuda):
    """A study run twice in one process: the second run captures 0
    graphs (0.0 s of capture) and its rows equal the first's bit for
    bit."""
    from repro_torch.experiments import run_experiment
    exp = _cut_experiment("fig9_isolation", 60)
    runs = [run_experiment(exp, device=cuda) for _ in range(2)]
    fls = [rs.flight["executions"][0] for rs in runs]
    assert fls[0]["dispatch_stats"]["graphs"] > 0
    assert fls[1]["dispatch_stats"]["graphs"] == 0
    assert fls[1]["walls"]["capture_s"] == 0.0
    assert all(lp["cached"] for lp in fls[1]["pipeline"]["loops"])
    _assert_rows_close(runs[1].to_metrics(), runs[0].to_metrics(), 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
def test_gpu_two_outstanding_batches_of_one_structure(cuda, trace):
    """Two batches of one structure dispatched before either is
    finalized (the second rebinds the first's loop while its replays
    may still be queued) each equal their batch run alone."""
    from repro_torch.trace import TraceSpec
    t = dict(trace=TraceSpec(enabled=True, every=5)) if trace else {}
    batches = [[compile_scenario(get_scenario(
        "reroute_random_failures").with_sim(slots=120, seed=s, **t))
        for s in seeds] for seeds in ((0, 1), (2, 3))]
    alone = []
    for pts in batches:
        graph.clear_graph_cache()
        alone.append(engine.run_compiled_batch(pts, cuda))
    graph.clear_graph_cache()
    handles = [engine.dispatch_compiled_batch(pts, cuda) for pts in batches]
    assert graph.graph_cache_stats()["hits"] == 1
    for h, want in zip(handles, alone):
        for g, w in zip(engine.finalize_batch(h), want):
            _results_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("name,sim", [
    ("fig12_plane_flap", dict(slots=260, nic="swlb", sw_lb_delay_ms=20.0)),
    ("cascading_spine_loss", dict(slots=260, routing="ecmp")),
])
def test_gpu_compact_f32_equals_wide_f32(cuda, monkeypatch, name, sim):
    """REPRO_JX_COMPACT=1: the float32 run's probe counter is int8, and
    the run equals the wide float32 run bit for bit, captured; float64
    keeps the wide counter."""
    c = compile_scenario(get_scenario(name).with_sim(**sim))
    wide = c.run(device=cuda, dtype=torch.float32)
    monkeypatch.setenv("REPRO_JX_COMPACT", "1")
    cfg, _, ops = engine.prepare(c, cuda, torch.float32)
    assert cfg.compact_carry
    assert engine.init_carry(ops.fb, cfg).nic.probe_miss.dtype == torch.int8
    cfg64, _, ops64 = engine.prepare(c, cuda, torch.float64)
    assert engine.init_carry(ops64.fb, cfg64).nic.probe_miss.dtype == \
        torch.int32
    _results_equal(c.run(device=cuda, dtype=torch.float32), wide)


@pytest.mark.gpu
def test_gpu_eviction_releases_graphs_and_recaptures(cuda, monkeypatch):
    """At a bound of one entry, a second structure evicts the first
    (its graphs reset once the device is done); the first then captures
    anew and still equals its first run."""
    monkeypatch.setattr(graph, "GRAPH_CACHE_ENTRIES", 1)
    pts = [compile_scenario(get_scenario(name).with_sim(slots=120))
           for name in ("fig12_plane_flap", "reroute_random_failures")]
    first = pts[0].run(device=cuda)
    pts[1].run(device=cuda)
    assert graph.graph_cache_stats()["entries"] == 1
    engine.reset_dispatch_stats()
    again = pts[0].run(device=cuda)
    assert engine.dispatch_stats()["graphs"] > 0
    _results_equal(again, first)


# ---------------------------------------------------------------------------
# decode attention in the model layout, and the model forward on the card
# ---------------------------------------------------------------------------

def _ring(rng, B, S, Hkv, D, dtype, dev, layout):
    """A (B, S, Hkv, D) cache: contiguous, a head-padded view (row
    stride 2 D), or one period's slice of a stacked (2, B, S, Hkv, D)
    cache whose sequence axis holds 8 slots more than it shows."""
    if layout == "contiguous":
        return _normal(rng, (B, S, Hkv, D), dtype, dev)
    if layout == "padded-heads":
        return _normal(rng, (B, S, Hkv, 2 * D), dtype, dev)[..., :D]
    return _normal(rng, (2, B, S + 8, Hkv, D), dtype, dev)[1, :, 4:S + 4]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("layout", ["contiguous", "padded-heads",
                                    "period-slice"])
def test_decode_attention_bshd_equals_plain_version(cuda, dtype, D, G,
                                                    layout):
    """GQA ratios 1, 4 and 8 read in place, every head_dim, ring lengths
    0 (every key, uniformly), 1, S and in between, over caches of one
    chunk and of several."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(D + G)
    for S, lengths in ((300, [0, 1, 300, 257]), (1000, [999, 1000, 3, 0])):
        B, Hkv = len(lengths), 2
        q = _normal(rng, (B, 1, Hkv * G, D), dtype, cuda)
        k, v = (_ring(rng, B, S, Hkv, D, dtype, cuda, layout)
                for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        got = _launched("decode_attention",
                        lambda: ops.decode_attention_bshd(q, k, v, lens))
        assert got.shape == q.shape and got.is_contiguous()
        want = ref.decode_attention_bshd_ref(q, k, v, lens)
        tol = ATTN_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_entries_share_the_kernel(cuda, dtype):
    """The (B, H, S, D) entry is the model entry with Hkv = H: its
    contiguous tensors take the compile-time-stride instance, and the
    same values read through run-time strides (k and v as views of
    head-padded buffers) give the same bits."""
    rng = np.random.default_rng(9)
    q = _normal(rng, (3, 4, 1, 128), dtype, cuda)
    k, v = (_normal(rng, (3, 4, 700, 128), dtype, cuda) for _ in range(2))
    lens = torch.tensor([700, 5, 0], dtype=torch.int32, device=cuda)
    a = ops.decode_attention(q, k, v, lens)
    kp, vp = (torch.zeros(3, 4, 700, 136, dtype=dtype, device=cuda)
              for _ in range(2))
    kp[..., :128], vp[..., :128] = k, v
    b = ops.decode_attention_bshd(q.transpose(1, 2),
                                  kp[..., :128].transpose(1, 2),
                                  vp[..., :128].transpose(1, 2), lens)
    assert torch.equal(a.transpose(1, 2), b)


@pytest.mark.gpu
def test_decode_attention_bshd_refuses_bad_operands(cuda):
    x = torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16, device=cuda)
    q = torch.zeros(2, 1, 8, 64, dtype=torch.bfloat16, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    build.reset_launches()
    # D not the unit-stride axis, then rows 68 elements apart (not a
    # multiple of 16 bytes)
    across = torch.zeros(2, 64, 64, 4, dtype=torch.bfloat16,
                         device=cuda).transpose(2, 3)
    odd = torch.zeros(2, 64, 4, 68, dtype=torch.bfloat16,
                      device=cuda)[..., :64]
    for bad in (across, odd):
        with pytest.raises(ValueError, match="strides"):
            ops.decode_attention_bshd(q, bad, x, lens)
    with pytest.raises(ValueError, match="kv heads"):
        ops.decode_attention_bshd(q, x[:, :, :3], x[:, :, :3], lens)
    with pytest.raises(ValueError, match="head_dim"):
        y = torch.zeros(2, 64, 4, 16, dtype=torch.bfloat16, device=cuda)
        ops.decode_attention_bshd(q[..., :16].contiguous(), y, y, lens)
    with pytest.raises(ValueError, match="dtype"):
        ops.decode_attention_bshd(q, x, x, lens.long())
    assert build.LAUNCHES["decode_attention"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-12b",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                                  "jamba-v0.1-52b", "deepseek-v2-236b",
                                  "llava-next-mistral-7b"])
def test_reduced_forward_on_cuda_equals_the_cpu_forward(cuda, arch):
    """The reduced config at head_dim 64 in float32: prefill (40 tokens,
    past gemma3's 32-token window), four decode steps and the loss on
    the card through the attention kernels, each within 1e-4 of the
    port's CPU forward (plain attention) on the same weights; one
    flash_attention launch per attention layer per prefill and loss, one
    decode_attention launch per layer per step."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import (decode_step, init_caches, init_params,
                                    loss_fn, prefill_step,
                                    standard_attention_layers, tree_map)
    from repro_torch.parallel import local_ctx
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[arch].reduced(head_dim=64, dtype="float32")
    cpu_p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_p = tree_map(cpu_p, lambda a: a.to(cuda))
    rng = np.random.default_rng(1)
    B, S = 2, 40
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, S + 5)),
                        dtype=torch.int32)
    fe = None
    if cfg.frontend_tokens:
        fe = torch.tensor(rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)) * 0.02,
            dtype=torch.float32)
    n_attn = standard_attention_layers(cfg)
    ctx = local_ctx()
    runs = {}
    for dev, p in (("cpu", cpu_p), (cuda, gpu_p)):
        build.reset_launches()
        caches = init_caches(cfg, B, 64, "float32", dev)
        logits, caches = prefill_step(
            p, cfg, toks[:, :S].to(dev), ctx, caches,
            None if fe is None else fe.to(dev))
        out = [logits]
        if dev != "cpu":
            assert build.LAUNCHES["flash_attention"] == n_attn
        for i in range(4):
            logits, caches = decode_step(
                p, cfg, toks[:, S + i:S + i + 1].to(dev),
                torch.full((B,), S + i, dtype=torch.int32, device=dev),
                ctx, caches)
            out.append(logits)
        batch = {"tokens": toks[:, :S].to(dev),
                 "labels": toks[:, 1:S + 1].to(dev)}
        if fe is not None:
            batch["frontend_embeds"] = fe.to(dev)
        out.append(loss_fn(p, cfg, batch, ctx)[0][None])
        if dev != "cpu":
            assert build.LAUNCHES["flash_attention"] == 2 * n_attn
            assert build.LAUNCHES["decode_attention"] == 4 * n_attn
        runs[str(dev)] = [t.cpu() for t in out]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert bool(got.isfinite().all())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# the backward against its plain version: max abs error over the largest
# |gradient| of the plain version (float32: sums over up to 1,000 terms
# in another order; bfloat16: the gradients are rounded to bf16, 2^-9
# relative, after float32 sums)
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# the forward's log-sum-exp against its plain version, absolute: the
# bf16 kernel sums P rounded to bf16 (2^-9 relative each), so log(l)
# is off by up to about 2e-3
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}


def _bwd_close(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = max(1.0, float(w.float().abs().max()))
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * scale, (name, err, scale)


def _bwd_inputs(rng, B, Sq, Sk, Hq, Hkv, D, dtype, dev):
    q = _normal(rng, (B, Sq, Hq, D), dtype, dev)
    k, v = (_normal(rng, (B, Sk, Hkv, D), dtype, dev) for _ in range(2))
    dout = _normal(rng, (B, Sq, Hq, D), dtype, dev)
    return q, k, v, dout


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("Hq,Hkv,Sq,Sk,causal,window", [
    (4, 4, 100, 100, True, 0),                   # MHA, one ragged tile
    (8, 2, 130, 130, True, 17),                  # GQA 4, a window
    (8, 1, 70, 150, True, 0),                    # MQA, Sq < Sk
    (4, 1, 150, 70, False, 20),                  # rows that see no key
    (4, 4, 129, 257, False, 0),                  # tails past 64 and 128
    (8, 1, 257, 129, True, 33),
    # the ragged edges of the tiles: 16 rows an mma, 16-64 queries a
    # step, 32-64 keys a block
    (2, 1, 1, 1, True, 0),                       # one query, one key
    (2, 1, 16, 16, True, 0),
    (2, 1, 63, 63, True, 0),
    (2, 1, 65, 65, True, 0),
    (2, 1, 127, 127, True, 0),
    (2, 1, 129, 129, True, 0),
    (2, 1, 1, 300, False, 0),                    # one query, many keys
    (8, 1, 200, 200, True, 40)])                 # GQA 8 under a window
def test_flash_attention_bwd_equals_plain_version(cuda, dtype, D, Hq, Hkv,
                                                  Sq, Sk, causal, window):
    """The backward kernel on the forward kernel's output and
    log-sum-exp against `flash_attention_bwd_ref` on the same tensors;
    the log-sum-exp against `flash_attention_lse_ref`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq + 7 * Sk + D + Hq)
    q, k, v, dout = _bwd_inputs(rng, 2, Sq, Sk, Hq, Hkv, D, dtype, cuda)
    out, lse = _launched("flash_attention", lambda: ops.flash_attention_fwd(
        q, k, v, causal=causal, window=window))
    want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                           window=window)
    assert lse.shape == (2, Hq, Sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=LSE_TOL[dtype])
    got = _launched("flash_attention_bwd", lambda: ops.flash_attention_bwd(
        q, k, v, out, dout, lse, causal=causal, window=window))
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                       causal=causal, window=window)
    _bwd_close(got, want, dtype)


def _tp_rank_heads():
    """(Hq, Hkv, D) of one rank's attention under tensor parallelism
    (`models.attention.attn_layout`) for each standard-attention arch at
    full width over model dims 2, 4, 8 and 16: the per-rank GQA groups
    the whole configs never produce (spx-100m at 8: 2 q heads on one kv
    head, or on two)."""
    import types
    from repro_torch.configs import ARCHS
    from repro_torch.models.attention import attn_layout
    from repro_torch.parallel import ShardCtx
    out, whole = set(), set()
    for cfg in ARCHS.values():
        if cfg.use_mla or "m" in cfg.block_pattern:
            continue
        whole.add((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim))
        for tp in (2, 4, 8, 16):
            for r in range(tp):
                mesh = types.SimpleNamespace(
                    shape=(1, tp), mesh_dim_names=("data", "model"),
                    get_local_rank=lambda name, r=r: r)
                _, count, kv = attn_layout(cfg, ShardCtx(mesh=mesh))
                if count:
                    hkv = len(kv) if kv else cfg.n_kv_heads // tp
                    out.add((count, hkv, cfg.head_dim))
    return sorted(out - whole)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", _tp_rank_heads())
def test_attention_kernels_at_tp_rank_heads(cuda, dtype, Hq, Hkv, D):
    """The flash forward and backward (causal, and under a window) and
    the decode kernel at a rank's head counts, each against its plain
    version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Hq * 1000 + Hkv * 10 + D)
    for window in (0, 40):
        q, k, v, dout = _bwd_inputs(rng, 2, 130, 130, Hq, Hkv, D, dtype,
                                    cuda)
        out, lse = _launched("flash_attention", lambda: ops.flash_attention_fwd(
            q, k, v, causal=True, window=window))
        want = ref.flash_attention_bshd_ref(q, k, v, causal=True,
                                            window=window)
        tol = ATTN_TOL[dtype]
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
        got = _launched("flash_attention_bwd", lambda: ops.flash_attention_bwd(
            q, k, v, out, dout, lse, causal=True, window=window))
        _bwd_close(got, ref.flash_attention_bwd_ref(
            q, k, v, out, dout, lse, causal=True, window=window), dtype)
    q = _normal(rng, (3, 1, Hq, D), dtype, cuda)
    k, v = (_normal(rng, (3, 300, Hkv, D), dtype, cuda) for _ in range(2))
    lens = torch.tensor([1, 150, 300], dtype=torch.int32, device=cuda)
    got = _launched("decode_attention",
                    lambda: ops.decode_attention_bshd(q, k, v, lens))
    want = ref.decode_attention_bshd_ref(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_leaves_the_output_and_repeats(cuda, dtype):
    """The forward entry with its log-sum-exp gives the model entry's
    output bits; two backward launches on the same inputs are bit-equal;
    the (B, H, S, D) entry's autograd goes through the same kernels."""
    rng = np.random.default_rng(11)
    q, k, v, dout = _bwd_inputs(rng, 2, 300, 300, 8, 2, 128, dtype, cuda)
    for causal, window in ((True, 0), (True, 100), (False, 0)):
        plain = ops.flash_attention_bshd(q, k, v, causal=causal,
                                         window=window)
        out, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
        assert torch.equal(out, plain)
        g1 = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                     window=window)
        g2 = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                     window=window)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    # (B, H, S, D): MHA views of the same values
    qh, kh, vh, dh = (t.transpose(1, 2).contiguous()
                      for t in _bwd_inputs(rng, 1, 200, 200, 4, 4, 64,
                                           dtype, cuda))
    leaves = [t.clone().requires_grad_(True) for t in (qh, kh, vh)]
    build.reset_launches()
    out = ops.flash_attention(*leaves)
    out.backward(dh)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 1
    assert build.LAUNCHES["flash_attention_bwd"] == 1
    o2, lse = ops.flash_attention_fwd(*(t.transpose(1, 2).contiguous()
                                        for t in (qh, kh, vh)))
    assert torch.equal(out.detach(), o2.transpose(1, 2))
    want = ref.flash_attention_bwd_ref(
        *(t.transpose(1, 2) for t in (qh, kh, vh, out.detach(), dh)), lse)
    _bwd_close([t.grad for t in leaves],
               tuple(w.transpose(1, 2) for w in want), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_runs_the_kernels(cuda, dtype):
    """Under grad, `ops.flash_attention_bshd` launches the forward with
    its log-sum-exp and, at backward, the backward kernel: its gradients
    are the backward entry's on the same tensors.  Under no_grad and
    inference_mode the output carries no graph and gives the same bits."""
    rng = np.random.default_rng(12)
    q, k, v, dout = _bwd_inputs(rng, 2, 200, 200, 8, 4, 64, dtype, cuda)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    build.reset_launches()
    out = ops.flash_attention_bshd(qg, kg, vg, window=50)
    assert out.requires_grad
    out.backward(dout)
    torch.cuda.synchronize()
    assert build.LAUNCHES == dict(dict.fromkeys(build.KERNELS, 0),
                                  flash_attention=1, flash_attention_bwd=1)
    o2, lse = ops.flash_attention_fwd(q, k, v, window=50)
    assert torch.equal(out.detach(), o2)
    want = ops.flash_attention_bwd(q, k, v, o2, dout, lse, window=50)
    for g, w in zip((qg.grad, kg.grad, vg.grad), want):
        assert torch.equal(g, w)
    with torch.no_grad():
        o3 = ops.flash_attention_bshd(qg, kg, vg, window=50)
        assert not o3.requires_grad and torch.equal(o3, o2)
    with torch.inference_mode():
        o4 = ops.flash_attention_bshd(qg, kg, vg, window=50)
        assert not o4.requires_grad and torch.equal(o4, o2)


@pytest.mark.gpu
def test_decode_attention_refuses_grad(cuda):
    """No decode backward exists: an input that requires grad raises
    under grad and launches nothing; under no_grad it runs."""
    rng = np.random.default_rng(13)
    q = _normal(rng, (2, 1, 8, 64), torch.float32, cuda).requires_grad_(True)
    k, v = (_normal(rng, (2, 64, 2, 64), torch.float32, cuda)
            for _ in range(2))
    lens = torch.tensor([10, 64], dtype=torch.int32, device=cuda)
    build.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention_bshd(q, k, v, lens)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q.transpose(1, 2).contiguous(),
                             *(t.repeat_interleave(4, 2).transpose(1, 2)
                               .contiguous() for t in (k, v)), lens)
    assert build.LAUNCHES["decode_attention"] == 0
    with torch.no_grad():
        ops.decode_attention_bshd(q, k, v, lens)
    assert build.LAUNCHES["decode_attention"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch,remat", [("llama3-8b", "none"),
                                        ("gemma3-12b", "full"),
                                        ("phi3.5-moe-42b-a6.6b", "none")])
def test_train_step_on_cuda_equals_the_cpu_step(cuda, arch, remat):
    """A reduced config at head_dim 64, float32, through
    `make_train_step` on the card (the flash kernels forward and
    backward) and on the CPU (plain attention, autograd) from the same
    weights: the loss within 1e-4 relative and the grad norm within
    1e-3, the first moments (0.1 x the gradient after one step) within
    5e-4 of each leaf's largest, the tolerance the CPU tests hold the
    port's gradients to the reference's with; one forward launch a
    layer (two under remat "full") and one backward.  The parameters move by about lr x sign(gradient) on a
    first step, so a gradient near zero may move its weight either way
    (2 lr apart): they are held within 1e-3."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import (init_params, standard_attention_layers,
                                    tree_leaves, tree_map)
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import local_ctx
    from repro_torch.train import TrainerConfig, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        ARCHS[arch].reduced(head_dim=64, dtype="float32"), remat=remat)
    tcfg = TrainerConfig(warmup_steps=1, total_steps=4,
                         cast_params_bf16=False)
    step = make_train_step(cfg, local_ctx(), tcfg)
    cpu_p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n = standard_attention_layers(cfg)
    runs = {}
    for dev in ("cpu", cuda):
        p = tree_map(cpu_p, lambda a: a.to(dev))
        build.reset_launches()
        p2, st, m = step(p, adamw_init(p), batch, 1)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert build.LAUNCHES["flash_attention"] == \
                n * (2 if remat == "full" else 1)
            assert build.LAUNCHES["flash_attention_bwd"] == n
        runs[str(dev)] = (m, [t.cpu() for t in tree_leaves(st["m"])],
                          [t.cpu() for t in tree_leaves(p2)])
    (mc, gc, pc), (mg, gg, pg) = runs["cpu"], runs["cuda"]
    for key, rtol in (("loss", 1e-4), ("grad_norm", 1e-3)):
        assert abs(float(mg[key]) - float(mc[key])) <= \
            rtol * abs(float(mc[key])), key
    for i, (a, b) in enumerate(zip(gg, gc)):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
        assert err <= 5e-4, (i, tuple(b.shape), err)
    for a, b in zip(pg, pc):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)


@pytest.fixture
def nccl(cuda, tmp_path):
    """An NCCL process group of one rank (a `file://` store) and its
    mesh, `make_mesh_for(1, 1)`; destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_mesh_for(1, 1)
    finally:
        dist.destroy_process_group()


def _held_codec(monkeypatch, calls: dict):
    """Every codec launch through `kernels.ops` held to its plain version
    on the call's own inputs, bit for bit; `calls` counts them."""
    encode, decode = ops.int8_encode, ops.int8_decode

    def held_encode(x, noise):
        q, s = encode(x, noise)
        wq, ws = ref.int8_encode_ref(x, noise)
        assert torch.equal(q, wq) and torch.equal(s, ws)
        calls["int8_encode"] = calls.get("int8_encode", 0) + 1
        return q, s

    def held_decode(q, scale, **kw):
        out = decode(q, scale, **kw)
        assert torch.equal(out, ref.int8_decode_ref(q, scale))
        calls["int8_decode"] = calls.get("int8_decode", 0) + 1
        return out

    monkeypatch.setattr(ops, "int8_encode", held_encode)
    monkeypatch.setattr(ops, "int8_decode", held_decode)


@pytest.mark.gpu
def test_plane_allreduce_at_nccl_world_one(nccl, monkeypatch):
    """A reduced config's parameters as a gradient tree: psum and rs_ag
    return it bit for bit; rs_ag_int8 launches the encode and the decode
    once for each chunk it compresses (a chunk of two or more dims at
    world 1), each launch bit-equal to its plain version, and every
    element lies within one code step of its row of the gradient."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.collectives import _chunk_bounds, plane_allreduce
    from repro_torch.core.planes import PlaneConfig
    from repro_torch.models import init_params, tree_leaves
    from repro_torch.parallel import ShardCtx
    cfg = ARCHS["spx-100m"].reduced(dtype="float32")
    grads = init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                        device="cuda")
    group = ShardCtx(nccl).group(("data",))
    pcfg = PlaneConfig(4, 16)
    leaves = tree_leaves(grads)
    for mode in ("psum", "rs_ag"):
        got = tree_leaves(plane_allreduce(grads, group, pcfg, key=1,
                                          mode=mode))
        assert all(torch.equal(a, b) for a, b in zip(got, leaves))
    chunks = sum(len(_chunk_bounds(x.shape[0], pcfg.microchunks))
                 for x in leaves if x.ndim >= 2 and x.numel() > 16)
    calls: dict = {}
    _held_codec(monkeypatch, calls)
    build.reset_launches()
    got = tree_leaves(plane_allreduce(grads, group, pcfg, key=1,
                                      mode="rs_ag_int8"))
    torch.cuda.synchronize()
    assert calls == {"int8_encode": chunks, "int8_decode": chunks}
    assert build.LAUNCHES["int8_encode"] == chunks
    assert build.LAUNCHES["int8_decode"] == chunks
    for a, b in zip(got, leaves):
        step = b.abs().amax(-1, keepdim=True) / 127 if b.ndim >= 2 else 0
        assert bool(((a - b).abs() <= step * (1 + 1e-5)).all())


@pytest.mark.gpu
def test_dp_step_at_nccl_world_one_equals_the_step_without_a_mesh(nccl):
    """The plane axes of size 1 are dropped, as the reference drops
    them: the step over the mesh is the one-rank step, bit for bit."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params, tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import ShardCtx, local_ctx
    from repro_torch.train import TrainerConfig, make_train_step
    cfg = dataclasses.replace(
        ARCHS["llama3-8b"].reduced(head_dim=64, dtype="bfloat16"),
        remat="full")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(5),
                         device="cuda")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tcfg = TrainerConfig(warmup_steps=1, total_steps=4)
    runs = []
    for ctx in (ShardCtx(nccl), local_ctx()):
        p2, st, m = make_train_step(cfg, ctx, tcfg)(
            params, adamw_init(params), batch, 1, 9)
        runs.append(tree_leaves(p2) + tree_leaves(st["m"]) +
                    [m["loss"], m["grad_norm"]])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["dots", "kv"])
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-12b"])
def test_remat_policies_on_cuda_equal_none(cuda, arch, remat):
    """A reduced config at head_dim 64 through `make_grad_fn` on the card
    under remat "dots" and "kv" against "none": the loss and gradients
    bit for bit; the flash forward launches twice a layer (the backward
    runs it again), the backward once."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import (init_params, standard_attention_layers,
                                    tree_leaves)
    from repro_torch.parallel import local_ctx
    from repro_torch.train import TrainerConfig
    from repro_torch.train.loop import make_grad_fn
    base = ARCHS[arch].reduced(head_dim=64, dtype="bfloat16")
    params = init_params(base, torch.Generator(device="cuda").manual_seed(7),
                         device="cuda")
    rng = np.random.default_rng(8)
    toks = rng.integers(0, base.vocab, (2, 97)).astype(np.int32)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             (("tokens", toks[:, :-1]), ("labels", toks[:, 1:]))}
    n = standard_attention_layers(base)
    out = {}
    for r in ("none", remat):
        cfg = dataclasses.replace(base, remat=r)
        build.reset_launches()
        loss, grads = make_grad_fn(cfg, local_ctx(), TrainerConfig())(
            params, batch)
        torch.cuda.synchronize()
        assert build.LAUNCHES["flash_attention"] == n * (1 if r == "none"
                                                         else 2)
        assert build.LAUNCHES["flash_attention_bwd"] == n
        out[r] = [loss] + tree_leaves(grads)
    assert all(torch.equal(a, b) for a, b in zip(out["none"], out[remat]))
