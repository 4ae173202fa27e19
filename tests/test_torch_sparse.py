"""Sparse aggregation in the PyTorch port, held to its dense path and to
the JAX package's sparse path.

Under `agg_mode="sparse"` the port sums flows into host, leaf-pair and
ECMP-link buckets with the flow-ordered segment sum
(`link_load.segment_sum_many`; on the CPU its plain version) over CSR
plans built on the host, where the dense path gathers padded plans.
Each bucket adds its flows in flow order either way, so in float64 a
sparse run must equal the dense run bit for bit, and both must meet
`_assert_parity` against the reference's sparse run
(`REPRO_JX_AGG=sparse`, `CompiledScenario.run(backend="jax")` under
`jax.enable_x64(True)`) and the NumPy engine.  The mode is chosen as
the reference chooses it (`agg_mode_default`, `flow_chunk_default`):
`giga_fabric_storage` prepares as sparse in both packages.  The plain
segment sum is pinned to `np.add.at` and `jax.ops.segment_sum`.
Chunked runs, batches and megabatches have their own file
(`test_torch_chunked.py`).
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim.jx import engine as jx_engine
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import get_scenario as jx_get
from repro_torch.kernels import link_load, ref
from repro_torch.netsim import engine
from repro_torch.scenarios import compile_scenario, distill_metrics, \
    get_scenario

from test_torch_engine import _assert_parity, _chip_smoke, _split

SHAPES = [(64, 8, 8, 1), (4095, 512, 32, 1), (4096, 256, 16, 2),
          (1024, 128, 64, 4), (1024, 128, 64, 2), (2048, 64, 1024, 1),
          (2048, 64, 1025, 1), (16384, 512, 32, 4)]


@pytest.mark.parametrize("env", [None, "dense", "sparse", "other"])
def test_agg_mode_default_equals_the_reference(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("REPRO_JX_AGG", raising=False)
    else:
        monkeypatch.setenv("REPRO_JX_AGG", env)
    for shape in SHAPES:
        assert engine.agg_mode_default(*shape) == \
            jx_engine.agg_mode_default(*shape), shape


@pytest.mark.parametrize("chunk,budget", [
    (None, None), (None, "1"), (None, "64"), ("0", None), ("17", "1"),
    ("4096", None)])
def test_flow_chunk_default_equals_the_reference(monkeypatch, chunk,
                                                 budget):
    """Over flow counts, planes, modes and both dtypes (the reference's
    item size follows x64, the port's the run's dtype)."""
    for name, value in (("REPRO_JX_FLOW_CHUNK", chunk),
                        ("REPRO_JX_FLOW_BUDGET_MB", budget)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for dtype, x64 in ((torch.float64, True), (torch.float32, False)):
        with jax.enable_x64(x64):
            for F in (0, 1, 1000, 102_400, 409_600, 10**7, 10**8):
                for P in (1, 2, 4):
                    for mode in ("dense", "sparse"):
                        assert engine.flow_chunk_default(F, P, mode, dtype) \
                            == jx_engine.flow_chunk_default(F, P, mode), \
                            (F, P, mode, dtype)


def _plan(keys: np.ndarray, K: int, chunk=None):
    """A CSR plan of row-major (F, P) keys, in chunks of `chunk` flows
    (one chunk by default)."""
    F = keys.shape[0]
    chunk = chunk or max(F, 1)
    p = engine._csr([(np.arange(F), keys)], K, chunk, -(-F // chunk))
    return p._replace(offsets=torch.as_tensor(p.offsets),
                      entries=torch.as_tensor(p.entries))


@pytest.mark.parametrize("F,P,K,skew", [(500, 2, 64, False),
                                        (333, 4, 1000, False),
                                        (200, 1, 10, True), (1, 1, 3, False)])
def test_plain_segment_sum_is_np_add_at_and_segment_sum(F, P, K, skew):
    """The plain version adds each bucket's flows in flow order from
    +0.0: bit-equal to `np.add.at` and to `jax.ops.segment_sum` in
    float64 (and to `np.add.at` in float32), empty buckets +0.0; a fold
    over chunks of 17 flows, tail included, equals one call."""
    rng = np.random.default_rng(F + K)
    vals = rng.uniform(0.0, 1.0, (F, P))
    vals[rng.random((F, P)) < 0.2] = 0.0
    keys = rng.integers(0, K // 2 + 1, (F, P))          # leaves some empty
    if skew:
        keys[: F // 2] = 3
    plan = _plan(keys, K)
    for dtype, npd in ((torch.float64, np.float64),
                       (torch.float32, np.float32)):
        v = torch.tensor(vals, dtype=dtype)
        got = ref.segment_sum_ref(v, plan.offsets, plan.entries)
        want = np.zeros(K, npd)
        np.add.at(want, keys.ravel(), vals.astype(npd).ravel())
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want)
        empty = np.bincount(keys.ravel(), minlength=K) == 0
        assert empty.any()
        assert not bool(torch.signbit(got[torch.as_tensor(empty)]).any())
        assert bool((got[torch.as_tensor(empty)] == 0).all())
        # the wrapper takes CPU tensors to the plain version
        assert torch.equal(link_load.segment_sum(v, plan), got)
        # a fold over chunks of 17 flows equals one call
        chunked = _plan(keys, K, 17)
        nc = -(-F // 17)
        acc = None
        for c in range(nc):
            part = engine._chunk_plan(chunked, c, nc)
            acc = link_load.segment_sum(v[c * 17:(c + 1) * 17].contiguous(),
                                        part, acc=acc)
        assert torch.equal(acc, got)
    with jax.enable_x64(True):
        seg = jax.ops.segment_sum(jnp.asarray(vals.ravel()),
                                  jnp.asarray(keys.ravel()),
                                  num_segments=K)
        np.testing.assert_array_equal(
            ref.segment_sum_ref(torch.tensor(vals), plan.offsets,
                                plan.entries).numpy(), np.asarray(seg))


def test_segment_sum_many_groups_and_accumulates():
    """Up to MAX_SEG_GROUP entries in one call, each its own sum; with
    `acc` each bucket continues from the accumulator, in place."""
    rng = np.random.default_rng(7)
    items, wants = [], []
    for k in range(link_load.MAX_SEG_GROUP):
        vals = torch.tensor(rng.uniform(size=(40 + k, 2)))
        keys = rng.integers(0, 9 + k, (40 + k, 2))
        items.append((vals, _plan(keys, 9 + k)))
        wants.append(ref.segment_sum_ref(vals, items[-1][1].offsets,
                                         items[-1][1].entries))
    outs = link_load.segment_sum_many(items)
    assert all(torch.equal(o, w) for o, w in zip(outs, wants))
    acc = tuple(torch.ones_like(w) for w in wants)
    back = link_load.segment_sum_many(items, acc=acc)
    assert all(b is a for b, a in zip(back, acc))
    for a, (vals, plan) in zip(acc, items):
        assert torch.equal(a, ref.segment_sum_ref(
            vals, plan.offsets, plan.entries,
            acc=torch.ones(plan.offsets.numel() - 1, dtype=vals.dtype)))
    with pytest.raises(ValueError, match="1-6"):
        link_load.segment_sum_many(items + items[:1])
    with pytest.raises(ValueError, match="accumulators"):
        link_load.segment_sum_many(items[:2], acc=acc[:1])
    with pytest.raises(ValueError, match="dtype"):
        link_load.segment_sum_many([items[0], (items[1][0].float(),
                                               items[1][1])])


def test_segment_sum_epilogue_is_bottleneck_of_the_sums():
    """With `caps` the plain path returns each entry's sums, the same as
    without, and, where a cap is given, `ref.bottleneck_ref` of them,
    which equals the reference's `bottleneck_ref` of
    `jax.ops.segment_sum` in float64; a fold's last chunk scales the
    finished sums."""
    from repro.kernels import ref as jx_ref
    rng = np.random.default_rng(26)
    items = []
    for k, K in enumerate((30, 200, 7)):
        vals = torch.tensor(rng.uniform(size=(90 + k, 2)))
        items.append((vals, _plan(rng.integers(0, K, (90 + k, 2)), K)))
    plain = link_load.segment_sum_many(items)
    caps = [torch.tensor(rng.uniform(0.0, 8.0, p.offsets.numel() - 1))
            for _, p in items]
    caps[1] = None
    sums, scales = link_load.segment_sum_many(items, caps=caps)
    assert all(torch.equal(a, b) for a, b in zip(sums, plain))
    assert scales[1] is None
    for (vals, plan), s, c, sc in zip(items, sums, caps, scales):
        if c is None:
            continue
        assert torch.equal(sc, ref.bottleneck_ref(c, s))
        with jax.enable_x64(True):
            counts = np.diff(plan.offsets.numpy())
            seg = jax.ops.segment_sum(
                jnp.asarray(vals.numpy().ravel()[plan.entries.numpy()]),
                jnp.asarray(np.repeat(np.arange(counts.size), counts)),
                num_segments=counts.size)
            want = jx_ref.bottleneck_ref(jnp.asarray(c.numpy()), seg)
        np.testing.assert_array_equal(sc.numpy(), np.asarray(want))
    # a fold over chunks of 30 flows: caps on the last chunk only
    vals = torch.tensor(rng.uniform(size=(95, 2)))
    keys = rng.integers(0, 11, (95, 2))
    chunked, one = _plan(keys, 11, 30), _plan(keys, 11)
    cap = torch.tensor(rng.uniform(0.0, 8.0, 11))
    acc = None
    for c in range(4):
        part = ((vals[c * 30:(c + 1) * 30].contiguous(),
                 engine._chunk_plan(chunked, c, 4)),)
        if c < 3:
            acc = link_load.segment_sum_many(part, acc=acc)
        else:
            acc, (scale,) = link_load.segment_sum_many(part, acc=acc,
                                                       caps=(cap,))
    want = ref.segment_sum_ref(vals, one.offsets, one.entries)
    assert torch.equal(acc[0], want)
    assert torch.equal(scale, ref.bottleneck_ref(cap, want))
    with pytest.raises(ValueError, match="caps"):
        link_load.segment_sum_many(items, caps=caps[:2])
    with pytest.raises(ValueError, match="caps\\[0\\]: shape"):
        link_load.segment_sum_many(items[:1], caps=(caps[2],))


def test_segment_lanes_follow_the_plan_shape():
    """The lanes a bucket the wrapper asks of the kernel, from host-known
    plan facts only: one lane for short buckets (the giga AR pair plan),
    16 for long ones (phi3.5-moe's crowded access plan), else 2 (the
    giga access and link plans, a skewed plan of mostly empty buckets);
    with no known width, by the mean alone."""
    lanes = link_load.segment_lanes_log2
    assert lanes(131072, 204800, 9) == 0
    assert lanes(8192, 67584, 66) == 4
    for K, E, width in ((8192, 204800, 25), (16384, 409600, 47),
                        (131072, 67584, 80), (65536, 1638400, 47)):
        assert lanes(K, E, width) == 1
    assert (lanes(131072, 204800, 0), lanes(8192, 204800, 0)) == (0, 1)


def test_plans_carry_their_widest_bucket(monkeypatch):
    """`SegmentPlan.width` is the most entries of any bucket, from the
    host prep's NumPy counts: a CSR plan's over every chunk, a chunk's
    plan keeps it, lane-stacked plans take the lanes' widest, and a
    prepared sparse run's plans carry theirs onto the device.  A sparse
    ECMP run's epilogue caps (`sparse_link_cap`) are its link
    capacities in the link plan's bucket order, family after family."""
    from repro_torch.netsim.carry import _stack_plan
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 13, (100, 2))
    keys[60:90, 0] = 4                           # bucket 4: 30 and more
    plan = _plan(keys, 13, 30)
    assert plan.width == np.diff(plan.offsets.numpy()).max() >= 30
    assert isinstance(plan.width, int)
    assert engine._chunk_plan(plan, 2, 4).width == plan.width
    other = _plan(rng.integers(0, 13, (100, 2)), 13, 30)
    assert _stack_plan([other, plan], 4, 60).width == \
        max(plan.width, other.width)
    monkeypatch.setenv("REPRO_JX_AGG", "sparse")
    for name in ("fig11_degraded_leaf", "ft_core_failure_resiliency"):
        for routing in ("war", "ecmp"):
            c = compile_scenario(get_scenario(name).with_sim(
                slots=5, routing=routing))
            _, _, ops = engine.prepare(c, "cpu")
            sp = ops.sparse
            for p in (sp.src, sp.dst, sp.pair or sp.link):
                o = p.offsets.numpy().reshape(-1, p.offsets.shape[-1])
                assert p.width == np.diff(o, axis=-1).max()
            if routing != "ecmp":
                assert ops.sparse_link_cap is None
                continue
            fams = (ops.up, ops.down) + (
                (ops.up2, ops.down2) if ops.up2 is not None else ())
            n_seg = ops.up.shape[0]
            assert torch.equal(ops.sparse_link_cap, torch.cat(
                [f.reshape(n_seg, -1) for f in fams], -1))
            assert ops.sparse_link_cap.shape[-1] == \
                sp.link.offsets.shape[-1] - 1


def _runs(monkeypatch, name, slots, mode, **sim):
    """(spec, compiled, result) of the port under `mode` (float64)."""
    monkeypatch.setenv("REPRO_JX_AGG", mode)
    base, routing = _split(name)
    spec = get_scenario(base).with_sim(slots=slots, **routing, **sim)
    c = compile_scenario(spec)
    return spec, c, c.run(device="cpu")


def _ref_runs(monkeypatch, name, slots, env, **sim):
    """(spec, compiled, jax result, numpy result) of the reference with
    the environment `env`."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    base, routing = _split(name)
    spec = jx_get(base).with_sim(slots=slots, **routing, **sim)
    with jax.enable_x64(True):
        rc = jx_compile(spec)
        return spec, rc, rc.run(backend="jax"), rc.run(backend="numpy")


def _assert_same(got, want):
    """Two runs of the port, bit for bit."""
    for f in ("mean_goodput", "completion_slot", "total_goodput",
              "util_up_last"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    if want.blackhole_timeline is None:
        assert got.blackhole_timeline is None
    else:
        np.testing.assert_array_equal(got.blackhole_timeline,
                                      want.blackhole_timeline)


# (scenario, slots): a link-kill set from slot 0, a spine cascade from
# slot 100, a fat tree's core kills at slot 100, a failure reaction past
# its fault at slot 100
SPARSE_POINTS = [("fig11_degraded_leaf", 60), ("cascading_spine_loss", 130),
                 ("ft_core_failure_resiliency", 130),
                 ("reroute_random_failures", 130)]


@pytest.mark.parametrize("routing", ["ar", "war", "ecmp"])
@pytest.mark.parametrize("name,slots", SPARSE_POINTS)
def test_sparse_equals_dense_and_the_reference(monkeypatch, name, slots,
                                               routing):
    """float64: the port's sparse run equals its dense run bit for bit,
    and meets `_assert_parity` against the reference's sparse run and
    the NumPy engine."""
    name = f"{name}[{routing}]"
    _, _, dense = _runs(monkeypatch, name, slots, "dense")
    spec, c, sparse = _runs(monkeypatch, name, slots, "sparse")
    cfg, *_ = engine._prepared(c)
    assert (cfg.agg_mode, cfg.flow_chunk) == ("sparse", 0)
    _assert_same(sparse, dense)
    rspec, rc, ref_jx, ref_np = _ref_runs(monkeypatch, name, slots,
                                          {"REPRO_JX_AGG": "sparse"})
    assert jx_engine._prepared(rc)[0].agg_mode == "sparse"
    _assert_parity((spec, c, sparse), (rspec, rc, ref_jx))
    _assert_parity((spec, c, sparse), (rspec, rc, ref_np))
    if ref_jx.blackhole_timeline is not None:
        np.testing.assert_allclose(sparse.blackhole_timeline,
                                   np.asarray(ref_jx.blackhole_timeline),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,routing", [("fig11_degraded_leaf", "ar"),
                                          ("fig11_degraded_leaf", "ecmp"),
                                          ("ft_core_failure_resiliency",
                                           "war"),
                                          ("ft_core_failure_resiliency",
                                           "ecmp")])
def test_sparse_kernel_calls_per_slot(monkeypatch, name, routing):
    """A sparse slot calls segment_sum_many once (both access sums and
    the pair or link sums in one launch, which also scales the access
    links and, under ECMP, the fabric links) and never
    bucket_load_bottleneck: 4 wrapper calls a slot under ECMP (no
    bottleneck_many), 6 under AR/WAR (pair_fractions, and
    bottleneck_many for the fabric links only), each with contiguous
    tensors."""
    calls = {}
    fns = ("plane_split", "pair_fractions", "bottleneck_many",
           "bucket_load_bottleneck", "queue_update_many", "nic_update",
           "segment_sum_many")
    for fn in fns:
        def counted(*args, _fn=fn, _orig=getattr(engine, fn), **kw):
            for a in args:
                for t in (a if isinstance(a, (tuple, list)) else (a,)):
                    ts = t if isinstance(t, (tuple, list)) else (t,)
                    assert all(x.is_contiguous() for x in ts
                               if isinstance(x, torch.Tensor)), _fn
            calls[_fn] = calls.get(_fn, 0) + 1
            return _orig(*args, **kw)
        monkeypatch.setattr(engine, fn, counted)
    slots = 12
    _runs(monkeypatch, f"{name}[{routing}]", slots, "sparse")
    want = dict(plane_split=slots, segment_sum_many=slots,
                queue_update_many=slots, nic_update=slots)
    if routing != "ecmp":
        want.update(pair_fractions=slots, bottleneck_many=slots)
    assert calls == want


def test_traced_sparse_run_equals_dense(monkeypatch):
    """A trace's host_bw under sparse aggregation is a segment sum of
    the delivered goodput by source host: the whole trace equals the
    dense run's."""
    from repro_torch.trace import TraceSpec
    trace = TraceSpec(enabled=True, every=3)
    res = {}
    for mode in ("dense", "sparse"):
        monkeypatch.setenv("REPRO_JX_AGG", mode)
        c = compile_scenario(get_scenario("fig12_plane_flap").with_sim(
            slots=70, trace=trace))
        res[mode] = c.run(device="cpu")
    _assert_same(res["sparse"], res["dense"])
    assert list(res["sparse"].trace) == list(res["dense"].trace)
    for k, v in res["dense"].trace.items():
        np.testing.assert_array_equal(res["sparse"].trace[k], v, k)


def test_giga_prepares_sparse_as_the_reference(monkeypatch):
    """giga_fabric_storage (4,096 hosts) picks sparse aggregation in both
    packages, with no flow chunks at the default budget; its config
    equals the reference's field by field, `compact_carry` included,
    with `REPRO_JX_COMPACT` unset and set."""
    c = compile_scenario(get_scenario("giga_fabric_storage"))
    rc = jx_compile(jx_get("giga_fabric_storage"))
    for compact in (None, "1"):
        if compact is None:
            monkeypatch.delenv("REPRO_JX_COMPACT", raising=False)
        else:
            monkeypatch.setenv("REPRO_JX_COMPACT", compact)
        cfg, *_ = engine._prepared(c)
        with jax.enable_x64(True):
            rcfg = jx_engine._prepared(rc)[0]
        assert (cfg.agg_mode, cfg.flow_chunk) == ("sparse", 0)
        assert cfg.compact_carry == rcfg.compact_carry == bool(compact)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name


@pytest.mark.slow
def test_giga_sparse_equals_golden_and_numpy():
    """giga_fabric_storage under its own mode (sparse) and routing
    (ECMP, 102,400 flows, 60 slots): the plain path against the NumPy
    engine and the golden row, as the dense run was held."""
    spec = get_scenario("giga_fabric_storage")
    c = compile_scenario(spec)
    assert engine._prepared(c)[0].agg_mode == "sparse"
    got = c.run(device="cpu")
    rspec = jx_get("giga_fabric_storage")
    rc = jx_compile(rspec)
    with jax.enable_x64(True):
        ref_np = rc.run(backend="numpy")
    _assert_parity((spec, c, got), (rspec, rc, ref_np))
    golden = json.loads((Path(__file__).parent / "golden" /
                         "scenarios.json").read_text())
    _chip_smoke().assert_golden(spec.name, distill_metrics(spec, c, got),
                                golden)
