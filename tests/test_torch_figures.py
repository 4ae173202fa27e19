"""The host helpers of the reference's figure-1 and fig14 benchmarks,
copied into the port (NumPy in both packages), against the reference:
each must equal it exactly on the same inputs, and the random ones draw
for draw from the same seed (so the reference's noisy statistical
checks are not repeated here: the comparison is exact).

  * `workloads.all2all_cct_us`, `ring_collective_cct_us` and
    `bus_bandwidth_gbps` on a grid (Fig 1a);
  * `queuesim.jsq_delay_sim` on a few seeds (Fig 1b);
  * both fabric kinds' capacity arrays, `path_capacity`, and
    `maxflow_matrix` / `leaf_pair_maxflow` per plane and summed, after
    each fault method and after `random_link_failures` from fixed
    seeds (Fig 1c);
  * `fault_tolerance.concurrent_failure_pmf` and `links_down_at` on
    `poisson_flaps` events (Fig 14).
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import fault_tolerance as jx_ft
from repro.netsim import queuesim as jx_queuesim
from repro.netsim import topology as jx_topology
from repro.netsim import workloads as jx_workloads
from repro_torch.core import fault_tolerance
from repro_torch.netsim import queuesim, topology, workloads

SIZES = (1 << 10, 3 << 19, 4 << 20, 1 << 26, 1e9 + 7)
RANKS = (2, 8, 128, 1000)


@pytest.mark.parametrize("message_bytes", SIZES)
def test_cct_and_bus_bandwidth_equal_the_reference(message_bytes):
    for n, bw, lat, chunk in itertools.product(
            RANKS, (100.0, 400.0, 800.0), (0.0, 1.5, 10.0),
            (1, 1 << 20, 4 << 20)):
        args = (message_bytes, n, bw, lat)
        a2a = workloads.all2all_cct_us(*args, chunk_bytes=chunk)
        assert a2a == jx_workloads.all2all_cct_us(*args, chunk_bytes=chunk)
        assert workloads.all2all_cct_us(*args) == \
            jx_workloads.all2all_cct_us(*args)
        ring = workloads.ring_collective_cct_us(*args)
        assert ring == jx_workloads.ring_collective_cct_us(*args)
        for cct in (a2a, ring, 0.0):
            for kind in ("all2all", "allgather"):
                assert workloads.bus_bandwidth_gbps(
                    message_bytes, cct, n, kind) == \
                    jx_workloads.bus_bandwidth_gbps(message_bytes, cct, n,
                                                    kind)


@pytest.mark.parametrize("seed,delay_ns,load", [(0, 0.0, 0.9),
                                                (1, 100.0, 0.9),
                                                (2, 1000.0, 0.95),
                                                (3, 2500.0, 0.7)])
def test_jsq_delay_sim_equals_the_reference(seed, delay_ns, load):
    kw = dict(n_ports=64, load=load, decision_delay_ns=delay_ns,
              slots=3000, seed=seed)
    got = queuesim.jsq_delay_sim(**kw)
    assert isinstance(got, queuesim.QueueSimResult)
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jx_queuesim.jsq_delay_sim(**kw))


def _fabrics(kind):
    """(port fabric, reference fabric) of one shape: parallel links and
    capacities other than 1, so a failure takes a unit off a bundle."""
    if kind == "leaf_spine":
        args = (6, 4, 3)
        kw = dict(n_planes=3, parallel_links=2, link_cap=1.5,
                  access_cap=2.0)
        return topology.LeafSpine(*args, **kw), \
            jx_topology.LeafSpine(*args, **kw)
    args = (3, 2, 2, 6, 2)
    kw = dict(n_planes=2, parallel_links=2, link_cap=1.0,
              core_link_cap=3.0, access_cap=2.0)
    return topology.FatTree(*args, **kw), jx_topology.FatTree(*args, **kw)


def _assert_fabric_equal(t, r):
    for f in ("up", "down", "up2", "down2", "access"):
        if hasattr(r, f):
            np.testing.assert_array_equal(getattr(t, f), getattr(r, f), f)
    assert t.n_paths == r.n_paths
    L = r.n_leaves
    src = np.repeat(np.arange(L), L)
    dst = np.tile(np.arange(L), L)
    np.testing.assert_array_equal(t.path_capacity(src, dst),
                                  r.path_capacity(src, dst))
    for plane in [None] + list(range(r.n_planes)):
        m = topology.maxflow_matrix(t, plane)
        np.testing.assert_array_equal(m, jx_topology.maxflow_matrix(r, plane))
        for l1, l2 in itertools.product(range(L), repeat=2):
            got = topology.leaf_pair_maxflow(t, l1, l2, plane)
            assert got == jx_topology.leaf_pair_maxflow(r, l1, l2, plane)
            assert np.isclose(got, m[l1, l2])


def _faults(kind):
    """(method, args) of every fault method of `kind`, in the order
    applied."""
    common = [("fail_uplink", (1, 2, 1)), ("fail_uplink", (0, 3, 0, 0.5)),
              ("trim_leaf_uplinks", (1, 4, 0.25)), ("fail_access", (0, 5)),
              ("fail_access", (1, 7)), ("restore_access", (0, 5))]
    if kind == "leaf_spine":
        return common
    return common + [("fail_core_link", (1, 2, 5)),
                     ("fail_core_link", (0, 0, 3, 0.5)),
                     ("fail_agg", (0, 1, 1))]


@pytest.mark.parametrize("kind", ["leaf_spine", "fat_tree"])
def test_fault_methods_and_maxflow_equal_the_reference(kind):
    t, r = _fabrics(kind)
    _assert_fabric_equal(t, r)
    for method, args in _faults(kind):
        getattr(t, method)(*args)
        getattr(r, method)(*args)
        _assert_fabric_equal(t, r)
    if kind == "fat_tree":
        assert t.cores_per_agg == r.cores_per_agg
        np.testing.assert_array_equal(t.agg_of_path, r.agg_of_path)
        np.testing.assert_array_equal(t.pod_of_leaf, r.pod_of_leaf)


@pytest.mark.parametrize("kind", ["leaf_spine", "fat_tree"])
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_random_link_failures_draw_as_the_reference(kind, seed, frac):
    """The same seed fails the same links; a copy is independent of its
    original."""
    t, r = _fabrics(kind)
    kept = t.copy()
    rng_t, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    t.random_link_failures(rng_t, frac)
    r.random_link_failures(rng_r, frac)
    _assert_fabric_equal(t, r)
    assert rng_t.random() == rng_r.random()
    assert not np.array_equal(kept.up, t.up)
    _assert_fabric_equal(kept, _fabrics(kind)[1])
    again = t.copy()
    _assert_fabric_equal(again, r.copy())
    again.fail_access(0, 0)
    assert t.access[0, 0] == r.access[0, 0]


@pytest.mark.parametrize("rate,duration", [(10.0, 10.0), (1.0, 0.5),
                                           (600.0, 2.0), (0.0, 10.0)])
def test_concurrent_failure_pmf_equals_the_reference(rate, duration):
    for max_k in (0, 4, 10, 25):
        np.testing.assert_array_equal(
            fault_tolerance.concurrent_failure_pmf(rate, duration, max_k),
            jx_ft.concurrent_failure_pmf(rate, duration, max_k))


@pytest.mark.parametrize("seed", [0, 3])
def test_links_down_at_equals_the_reference(seed):
    args = (64, 10.0, 10.0, 600.0)
    events = fault_tolerance.poisson_flaps(np.random.default_rng(seed),
                                           *args)
    ref = jx_ft.poisson_flaps(np.random.default_rng(seed), *args)
    assert [dataclasses.astuple(e) for e in events] == \
        [dataclasses.astuple(e) for e in ref]
    times = np.linspace(0.0, 600.0, 241).tolist() + \
        [e.t_down for e in ref[:20]] + [e.t_up for e in ref[:20]]
    assert any(fault_tolerance.links_down_at(events, t) for t in times)
    for t in times:
        assert fault_tolerance.links_down_at(events, t) == \
            jx_ft.links_down_at(ref, t)
