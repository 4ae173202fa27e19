"""Workload builders (§6.1): RDMA bisection, All2All, one-to-many bursts,
ring collectives.  Draw for draw the same as the reference builders, so a
seed yields the same flow list in both packages.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .fabric import Flow
from .topology import LeafSpine


def bisection_pairs(t: LeafSpine, hosts: Sequence[int],
                    rng: np.random.Generator,
                    group: str = "main") -> List[Flow]:
    """Worst-case pairing: every pair crosses the spine (src and dst on
    different leaves), full line-rate demand."""
    hosts = list(hosts)
    by_leaf = {}
    for h in hosts:
        by_leaf.setdefault(t.leaf_of(h), []).append(h)
    leaves = sorted(by_leaf)
    flows = []
    half = len(leaves) // 2
    left = [h for l in leaves[:half] for h in by_leaf[l]]
    right = [h for l in leaves[half:] for h in by_leaf[l]]
    n = min(len(left), len(right))
    lperm = rng.permutation(left)[:n]
    rperm = rng.permutation(right)[:n]
    for a, b in zip(lperm, rperm):
        flows.append(Flow(int(a), int(b), 1.0, group=group))
        flows.append(Flow(int(b), int(a), 1.0, group=group))
    return flows


def all2all(t: LeafSpine, hosts: Sequence[int], group: str = "main",
            bytes_per_pair: float = np.inf) -> List[Flow]:
    hosts = list(hosts)
    n = len(hosts)
    flows = []
    # ordered pairs; per-flow demand = line_rate / (n-1)
    d = 1.0 / max(n - 1, 1)
    for a in hosts:
        for b in hosts:
            if a != b:
                flows.append(Flow(int(a), int(b), d, bytes_per_pair,
                                  group=group))
    return flows


def one_to_many(t: LeafSpine, srcs: Sequence[int], dsts: Sequence[int],
                group: str = "main",
                bytes_per_flow: float = np.inf) -> List[Flow]:
    d = 1.0 / max(len(dsts), 1)
    return [Flow(int(a), int(b), d, bytes_per_flow, group=group)
            for a in srcs for b in dsts]


def ring_neighbors(hosts: Sequence[int], group: str = "main",
                   bytes_per_hop: float = np.inf) -> List[Flow]:
    """Ring AllGather/ReduceScatter traffic: each rank streams to its
    successor."""
    hosts = list(hosts)
    return [Flow(int(hosts[i]), int(hosts[(i + 1) % len(hosts)]), 1.0,
                 bytes_per_hop, group=group)
            for i in range(len(hosts))]
