"""High-Frequency Telemetry (§5): per-µs bandwidth histograms and their
classification, straggler detection, symmetry groups, and the train
loop's HFT ring buffer and step-time tracker.  A copy of the reference's
`core/telemetry.py` (NumPy only), held to it in the tests
(`scenarios/runner.py` imports `symmetry_check` from here).

  * §5.1 — AR traffic is structurally uniform; any symmetry-group outlier
    flags a fault or misconfiguration.
  * §5.2 — healthy ranks blocked on a straggler show a *bi-modal* BW
    histogram (line rate or idle); the straggler itself fluctuates
    mid-range.
  * §5.3 — HFT time series (100 µs – 10 ms sampling) expose transient BW
    drops that standard polling misses.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List

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


# ---------------------------------------------------------------------------
# symmetry groups (§5.1)
# ---------------------------------------------------------------------------

@dataclass
class SymmetryReport:
    group: str
    uniform: bool
    cv: float                 # coefficient of variation
    outliers: List[int]


def symmetry_check(group: str, port_bw: np.ndarray,
                   cv_tol: float = 0.05, z_tol: float = 3.0
                   ) -> SymmetryReport:
    """AR produces structurally uniform load across a symmetry group (leaf
    uplinks, rails, planes); deviations indicate faults/misconfig."""
    bw = np.asarray(port_bw, np.float64)
    mu = bw.mean()
    sd = bw.std()
    cv = sd / mu if mu > 0 else 0.0
    z = np.abs(bw - mu) / max(sd, 1e-12)
    outliers = [int(i) for i in np.nonzero((z > z_tol) & (sd > 1e-9))[0]]
    return SymmetryReport(group=group, uniform=cv <= cv_tol, cv=float(cv),
                          outliers=outliers)


# ---------------------------------------------------------------------------
# HFT ring buffer + step-time straggler tracking (framework level)
# ---------------------------------------------------------------------------

@dataclass
class HFTBuffer:
    """Time-series telemetry at 100µs–10ms-equivalent cadence (here: per
    train-loop event)."""
    capacity: int = 4096
    records: Deque = field(default_factory=deque)

    def record(self, t: float, metrics: Dict[str, float]) -> None:
        self.records.append((t, dict(metrics)))
        while len(self.records) > self.capacity:
            self.records.popleft()

    def series(self, key: str) -> np.ndarray:
        return np.array([(t, m[key]) for t, m in self.records
                         if key in m])

    def drops(self, key: str, frac: float = 0.5) -> List[float]:
        """Timestamps where the metric transiently drops below frac×median
        (the §5.3 daemon-interference signature)."""
        s = self.series(key)
        if s.shape[0] < 4:
            return []
        med = np.median(s[:, 1])
        return [float(t) for t, v in s if v < frac * med]


class StepTimeTracker:
    """EWMA per-host step times -> straggler mitigation signal."""

    def __init__(self, n_hosts: int, ewma: float = 0.7,
                 threshold: float = 1.3):
        self.ewma = np.zeros(n_hosts)
        self.alpha = ewma
        self.threshold = threshold
        self.count = 0

    def update(self, step_times: np.ndarray) -> List[int]:
        st = np.asarray(step_times, np.float64)
        if self.count == 0:
            self.ewma = st.copy()
        else:
            self.ewma = self.alpha * self.ewma + (1 - self.alpha) * st
        self.count += 1
        med = np.median(self.ewma)
        return [int(i) for i in
                np.nonzero(self.ewma > self.threshold * med)[0]]
