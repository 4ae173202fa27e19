"""High-frequency telemetry analyses (§5) over a captured trace: per-port
bandwidth histograms and their classification, and straggler detection.
A copy of the reference's `core/telemetry.py` functions that
`trace.trace_summary` calls (NumPy only), held to them by array
equality in the tests.

  * §5.2 — healthy ranks blocked on a straggler show a *bi-modal* BW
    histogram (line rate or idle); the straggler itself fluctuates
    mid-range.
  * §5.3 — HFT time series (100 µs – 10 ms sampling) expose transient BW
    drops that standard polling misses.
"""
from __future__ import annotations

from typing import List

import numpy as np


def bw_histogram(samples: np.ndarray, nbins: int = 20) -> np.ndarray:
    """Per-µs BW samples normalized to line rate -> histogram (nbins,)."""
    h, _ = np.histogram(np.clip(samples, 0.0, 1.0), bins=nbins,
                        range=(0.0, 1.0))
    return h.astype(np.float64)


def classify_histogram(hist: np.ndarray,
                       edge_frac: float = 0.15) -> str:
    """'healthy-blocked' = bi-modal (idle | line rate) — a rank stalled on
    someone else; 'straggler' = mass in the mid-range — the slow rank
    itself; 'line-rate' = top-bin dominated."""
    n = hist.shape[0]
    total = hist.sum()
    if total <= 0:
        return "idle"            # no samples / no mass: nothing flowed
    # the edge windows are clamped to disjoint halves: with
    # nbins < 1/edge_frac they would overlap, double-count the shared
    # bins and drive `mid` negative
    k = max(1, min(int(n * edge_frac), n // 2)) if n > 1 else 1
    low, high = hist[:k].sum() / total, hist[-k:].sum() / total
    if n == 1:                   # single bin is both edges; all mass "mid"
        low = high = 0.0
    mid = max(0.0, 1.0 - low - high)
    if high > 0.85:
        return "line-rate"
    if mid < 0.25 and low > 0.05 and high > 0.05:
        return "healthy-blocked"
    if mid >= 0.25:
        return "straggler"
    return "idle" if low > 0.85 else "healthy-blocked"


def find_stragglers(per_rank_samples: np.ndarray) -> List[int]:
    """per_rank_samples: (ranks, T) normalized BW.  Returns straggler
    ids."""
    out = []
    for r in range(per_rank_samples.shape[0]):
        if classify_histogram(bw_histogram(per_rank_samples[r])) == \
                "straggler":
            out.append(r)
    return out
