"""Flows and the fabric constants of the fluid model.

Each slot the NIC splits a flow's offered rate over planes, routing
splits each plane's rate over spines (AR/WAR: quantized-JSQ fractions
re-balanced every slot), link loads scale delivery down to capacity,
queues integrate the excess, and ECN/RTT signals feed the NIC's rate
control.  The slot itself is `netsim.engine._slot_step`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

ECN_QUEUE_THRESH = 3.0
AR_TEMPERATURE = 0.25
JSQ_BINS = 16
Q_CAP = 64.0


@dataclass
class Flow:
    src: int
    dst: int
    demand: float = 1.0          # offered rate cap (line rate = 1.0)
    bytes_total: float = np.inf  # in rate*slot units (CCT workloads)
    group: str = "main"
    start_slot: int = 0
    phase: int = 0               # demand-timeline lane (0 = always-on)


@dataclass
class FlowArrays:
    src: np.ndarray
    dst: np.ndarray
    src_leaf: np.ndarray
    dst_leaf: np.ndarray
    demand: np.ndarray
    bytes_total: np.ndarray
    group: np.ndarray            # int-coded
    groups: List[str]
    start_slot: np.ndarray = None
    phase: np.ndarray = None     # demand-timeline lane per flow

    @classmethod
    def build(cls, flows: List[Flow], t) -> "FlowArrays":
        """`t` is any fabric/spec exposing `hosts_per_leaf`."""
        src = np.array([f.src for f in flows], np.int64)
        dst = np.array([f.dst for f in flows], np.int64)
        names = sorted({f.group for f in flows})
        gmap = {g: i for i, g in enumerate(names)}
        return cls(
            src=src, dst=dst,
            src_leaf=src // t.hosts_per_leaf,
            dst_leaf=dst // t.hosts_per_leaf,
            demand=np.array([f.demand for f in flows]),
            bytes_total=np.array([f.bytes_total for f in flows]),
            group=np.array([gmap[f.group] for f in flows], np.int64),
            groups=names,
            start_slot=np.array([f.start_slot for f in flows], np.int64),
            phase=np.array([f.phase for f in flows], np.int64))

    def __len__(self) -> int:
        return self.src.shape[0]
