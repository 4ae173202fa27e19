"""Workload builders (§6.1): RDMA bisection, All2All, one-to-many bursts,
ring collectives.  Draw for draw the same as the reference builders, so a
seed yields the same flow list in both packages.  Beside them the
analytic completion-time and bus-bandwidth helpers of Fig 1a, copies of
the reference's.
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


# ---------------------------------------------------------------------------
# analytic CCT helpers (Fig 1a)
# ---------------------------------------------------------------------------

def all2all_cct_us(message_bytes: float, n_ranks: int, bw_gbps: float,
                   latency_us: float, chunk_bytes: float = 4 << 20
                   ) -> float:
    """All2All completion time: each rank sends (n-1)/n of the message
    in dependent chunk rounds, and pays the latency once a round."""
    payload = message_bytes * (n_ranks - 1) / n_ranks
    wire_us = payload * 8.0 / (bw_gbps * 1e3)
    rounds = max(1, int(np.ceil(payload / max(chunk_bytes, 1))))
    return wire_us + rounds * latency_us


def ring_collective_cct_us(message_bytes: float, n_ranks: int,
                           bw_gbps: float, latency_us: float) -> float:
    """Ring AllGather: (n-1) dependent steps of message/n each."""
    step_bytes = message_bytes / n_ranks
    step_us = step_bytes * 8.0 / (bw_gbps * 1e3) + latency_us
    return (n_ranks - 1) * step_us


def bus_bandwidth_gbps(message_bytes: float, cct_us: float,
                       n_ranks: int, kind: str = "all2all") -> float:
    """NCCL's bus-bandwidth normalization."""
    factor = (n_ranks - 1) / n_ranks
    return message_bytes * 8.0 * factor / max(cct_us * 1e3, 1e-9)
