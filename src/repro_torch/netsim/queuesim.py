"""Slot-accurate single-switch queue microsimulation (Fig 1b): per-packet
JSQ over N egress ports with a stale queue view (the load-balancing
decision delay), in 100 ns slots.  A copy of the reference's
`repro/netsim/queuesim.py`, draw for draw, so that a seed gives the same
result in both packages; host NumPy, as there.

At a delay near 0 JSQ keeps queues near empty; at ~1 us they grow ~5x;
by ~2.5 us decisions are effectively random and queues saturate.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class QueueSimResult:
    mean_queue: float
    p99_queue: float
    mean_delay_us: float


def jsq_delay_sim(n_ports: int = 256, load: float = 0.9,
                  decision_delay_ns: float = 100.0,
                  slot_ns: float = 100.0, slots: int = 200_000,
                  seed: int = 0, nbins: int = 16,
                  qmax_pkts: float = 64.0) -> QueueSimResult:
    """Each slot: Poisson(load * n_ports) packet arrivals go to the ports
    of the least quantized queue as seen `decision_delay` ago (a random
    one among them each); each port drains one packet a slot."""
    rng = np.random.default_rng(seed)
    delay_slots = max(0, int(round(decision_delay_ns / slot_ns)))
    q = np.zeros(n_ports)
    hist = [q.copy() for _ in range(delay_slots + 1)]
    samples = []
    lam = load * n_ports
    for t in range(slots):
        stale = hist[0]
        n_arr = rng.poisson(lam)
        if n_arr:
            qb = np.floor(np.clip(stale / qmax_pkts, 0, 1 - 1e-9) * nbins)
            # JSQ among the min-bin ports, random tie-break
            min_ports = np.flatnonzero(qb == qb.min())
            picks = rng.integers(0, len(min_ports), n_arr)
            np.add.at(q, min_ports[picks], 1.0)
        q = np.maximum(q - 1.0, 0.0)
        hist.append(q.copy())
        hist.pop(0)
        if t > slots // 4:
            samples.append(q.mean())
    samples = np.asarray(samples)
    mean_q = float(samples.mean())
    p99 = float(np.quantile(samples, 0.99))
    return QueueSimResult(mean_queue=mean_q, p99_queue=p99,
                          mean_delay_us=mean_q * slot_ns / 1000.0)
