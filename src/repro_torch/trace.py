"""High-frequency trace capture (§5.3): what the slot engine records per
slot, and what falls out of it.

`TraceSpec` is the paper's 100 µs – 10 ms sampling knob: which per-slot
signals to keep (`fields`, canonical order `TRACE_FIELDS`) and at what
decimation (`every`, in slots), so the recorded slots are
`range(0, slots, every)`.  It rides inside `SimSpec`/`SimConfig`, so
scenario specs carry it.

A captured trace is a plain dict of NumPy arrays (T = recorded slots,
H hosts, P planes, L leaves, U uplinks per leaf, F flows):

    slot      (T,)          recorded slot indices
    host_bw   (T, H, P)     per-host per-plane delivered goodput
                            (stall-masked, fabric-rate units)
    util      (T, P, L, U)  stage-A uplink utilization
    queue     (T, P, L, U)  stage-A uplink queue depth (after the update)
    ecn       (T, F, P)     per-flow per-plane ECN mark
    eligible  (T, F, P)     per-flow plane eligibility (the SPX failover
                            mask: a flip is a reroute or failover event)

`trace_summary` runs the §5 analyses (`core.telemetry`) and gives the
derived metric columns `hft_transient_drops`, `straggler_ranks` and
`bimodal_frac`; `trace_to_npz`/`trace_to_perfetto` export raw traces
(Perfetto and `chrome://tracing` open the JSON directly).  The analyses
and exporters are copies of the reference's `repro/trace.py`.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.telemetry import bw_histogram, classify_histogram, \
    find_stragglers

# Canonical field order of a captured trace: the engine builds and the
# batch paths unpack fields in this order, never in dict order.
TRACE_FIELDS: Tuple[str, ...] = ("host_bw", "util", "queue", "ecn",
                                 "eligible")

# Fields whose second axis (after time) is the flow axis; the megabatch
# path pads flows to pow2 buckets and strips these back to the true count.
FLOW_AXIS_FIELDS = frozenset(("ecn", "eligible"))

# A port whose time-mean normalized goodput is below this never carried
# traffic; it is left out of the bi-modal census.
ACTIVE_PORT_THRESH = 0.01


@dataclass(frozen=True)
class TraceSpec:
    """What to record per slot (`fields`), at what decimation (`every`,
    in slots)."""
    enabled: bool = False
    every: int = 1
    fields: Tuple[str, ...] = TRACE_FIELDS

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    def active_fields(self) -> Tuple[str, ...]:
        """Requested fields in canonical order (capture order)."""
        return tuple(f for f in TRACE_FIELDS if f in self.fields)

    def validate(self) -> None:
        if self.every < 1:
            raise ValueError(f"trace.every must be >= 1, got {self.every}")
        unknown = sorted(set(self.fields) - set(TRACE_FIELDS))
        if unknown:
            raise ValueError(
                f"unknown trace fields {unknown}; valid: {TRACE_FIELDS}")
        if self.enabled and not self.active_fields():
            raise ValueError("trace enabled with no fields selected")

    def recorded_slots(self, n_slots: int) -> np.ndarray:
        return np.arange(0, n_slots, self.every, dtype=np.int64)


# ---------------------------------------------------------------------------
# §5 analyses over a captured trace
# ---------------------------------------------------------------------------

def trace_summary(trace: Optional[Dict[str, np.ndarray]],
                  access_cap: float, n_planes: int) -> Dict[str, object]:
    """Derived metric columns from a captured trace.

    * `bimodal_frac` — fraction of active (host, plane) ports whose
      normalized BW histogram classifies "healthy-blocked" (§5.2's
      bi-modal signature: line rate or idle, stalled on someone else).
    * `straggler_ranks` — hosts whose host-level series classifies
      "straggler" (mid-range mass: the slow rank itself).
    * `hft_transient_drops` — recorded slots where aggregate goodput
      fell below half its median (§5.3's transient-drop signature);
      -1 when no usable trace.
    """
    out: Dict[str, object] = {"hft_transient_drops": -1,
                              "straggler_ranks": (),
                              "bimodal_frac": float("nan")}
    if not trace:
        return out
    hb = np.asarray(trace.get("host_bw", np.empty((0, 0, 0))), np.float64)
    if hb.ndim != 3 or hb.shape[0] < 2 or hb.size == 0:
        return out
    line = max(float(access_cap), 1e-12)
    port = hb / line                                   # (T, H, P)
    host = hb.sum(axis=2) / (line * max(n_planes, 1))  # (T, H)

    active = port.mean(axis=0) > ACTIVE_PORT_THRESH    # (H, P)
    port_classes: Dict[str, int] = {}
    n_bimodal = 0
    for h, p in zip(*np.nonzero(active)):
        cls = classify_histogram(bw_histogram(port[:, h, p]))
        port_classes[cls] = port_classes.get(cls, 0) + 1
        if cls == "healthy-blocked":
            n_bimodal += 1
    n_active = int(active.sum())

    agg = hb.sum(axis=(1, 2))
    drops = 0
    if agg.shape[0] >= 4:
        med = float(np.median(agg))
        if med > 1e-12:
            drops = int((agg < 0.5 * med).sum())

    out["hft_transient_drops"] = drops
    out["straggler_ranks"] = tuple(find_stragglers(host.T))
    out["bimodal_frac"] = (n_bimodal / n_active if n_active
                           else float("nan"))
    out["port_classes"] = port_classes
    return out


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def trace_to_npz(path: str, trace: Dict[str, np.ndarray],
                 slot_us: float = 1.0, label: str = "sim") -> None:
    """Compressed npz of the raw trace arrays plus slot_us metadata."""
    payload = {k: np.asarray(v) for k, v in trace.items()}
    payload["slot_us"] = np.float64(slot_us)
    payload["label"] = np.str_(label)
    np.savez_compressed(path, **payload)


def _counter(events, name, ts_us, value):
    events.append({"name": name, "ph": "C", "ts": float(ts_us),
                   "pid": 0, "args": {"value": float(value)}})


def trace_to_perfetto(path: str, trace: Dict[str, np.ndarray],
                      slot_us: float = 1.0, label: str = "sim") -> None:
    """Chrome-trace / Perfetto JSON timeline of the fabric reacting.

    Counter tracks: per-host goodput, per-plane mean utilization and
    queue depth, fabric-wide ECN mark rate.  Instant events mark every
    plane-eligibility flip (the SPX failover / reroute signal).
    """
    slots = np.asarray(trace.get("slot", ()), np.int64)
    events = []
    hb = trace.get("host_bw")
    if hb is not None:
        hb = np.asarray(hb, np.float64)
        for t, s in enumerate(slots[:hb.shape[0]]):
            ts = float(s) * slot_us
            for h in range(hb.shape[1]):
                _counter(events, f"host{h}.goodput", ts, hb[t, h].sum())
    for key, fmt in (("util", "plane{p}.util"),
                     ("queue", "plane{p}.queue")):
        arr = trace.get(key)
        if arr is None:
            continue
        arr = np.asarray(arr, np.float64)
        for t, s in enumerate(slots[:arr.shape[0]]):
            ts = float(s) * slot_us
            for p in range(arr.shape[1]):
                _counter(events, fmt.format(p=p), ts, arr[t, p].mean())
    ecn = trace.get("ecn")
    if ecn is not None:
        ecn = np.asarray(ecn, np.float64)
        for t, s in enumerate(slots[:ecn.shape[0]]):
            _counter(events, "fabric.ecn_rate", float(s) * slot_us,
                     ecn[t].mean())
    elig = trace.get("eligible")
    if elig is not None and np.asarray(elig).shape[0] > 1:
        elig = np.asarray(elig, bool)
        flips = elig[1:] != elig[:-1]                  # (T-1, F, P)
        for t, f, p in zip(*np.nonzero(flips)):
            gained = bool(elig[t + 1, f, p])
            events.append({
                "name": (f"flow{f}.plane{p} "
                         f"{'restored' if gained else 'failover'}"),
                "ph": "i", "ts": float(slots[t + 1]) * slot_us,
                "pid": 0, "tid": 0, "s": "g"})
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"label": label, "slot_us": slot_us,
                         "recorded_slots": int(slots.shape[0])}}
    with open(path, "w") as fh:
        json.dump(doc, fh)
