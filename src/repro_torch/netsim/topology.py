"""Fabric shapes as data: the multi-plane leaf-spine and the 3-tier
fat-tree.

Link capacities are normalized to 1.0 = one port at line rate; parallel
links between switches appear as capacity > 1 on an edge, and every plane
is an independent copy joined only at the host NIC.  The slot engine
reads fault effects from a capacity timeline (`netsim.events`), so these
classes carry the pristine capacity arrays and the shape helpers only.
The fat-tree slot engine is not ported yet; `FatTree` exists so that
every registry topology builds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

import numpy as np


@dataclass
class LeafSpine:
    n_leaves: int
    n_spines: int
    hosts_per_leaf: int
    n_planes: int = 1
    parallel_links: int = 1
    link_cap: float = 1.0
    access_cap: float = 1.0

    kind = "leaf_spine"

    up: np.ndarray = field(init=False)      # (P, L, S) leaf->spine
    down: np.ndarray = field(init=False)    # (P, S, L) spine->leaf
    access: np.ndarray = field(init=False)  # (P, H) host<->leaf

    def __post_init__(self):
        P, L, S = self.n_planes, self.n_leaves, self.n_spines
        cap = self.link_cap * self.parallel_links
        self.up = np.full((P, L, S), cap, np.float64)
        self.down = np.full((P, S, L), cap, np.float64)
        self.access = np.full((P, self.n_hosts), self.access_cap,
                              np.float64)

    @property
    def n_hosts(self) -> int:
        return self.n_leaves * self.hosts_per_leaf

    def leaf_of(self, host: int) -> int:
        return host // self.hosts_per_leaf


@dataclass
class FatTree:
    """3-tier leaf–agg–core fat-tree.  Core `j` attaches to agg
    `j // (n_cores // n_aggs)` in every pod, so the path axis is the core
    index.  `core_link_cap` <= 0 inherits the stage-A uplink capacity."""
    n_pods: int
    leaves_per_pod: int
    n_aggs: int                  # agg switches per pod
    n_cores: int                 # core switches, total
    hosts_per_leaf: int
    n_planes: int = 1
    parallel_links: int = 1
    link_cap: float = 1.0        # leaf<->agg discrete link
    core_link_cap: float = 0.0   # pod<->core link; <= 0 -> uplink_cap
    access_cap: float = 1.0

    kind = "fat_tree"

    up: np.ndarray = field(init=False)      # (P, L, A) leaf->agg (local a)
    down: np.ndarray = field(init=False)    # (P, A, L) agg->leaf
    up2: np.ndarray = field(init=False)     # (P, pods, C) agg->core
    down2: np.ndarray = field(init=False)   # (P, pods, C) core->agg
    access: np.ndarray = field(init=False)  # (P, H)

    def __post_init__(self):
        if self.n_pods < 2:
            raise ValueError("FatTree requires n_pods >= 2 "
                             "(use LeafSpine for a single-stage fabric)")
        if self.n_cores % self.n_aggs != 0 or self.n_cores < self.n_aggs:
            raise ValueError(
                f"n_cores ({self.n_cores}) must be a positive multiple "
                f"of n_aggs ({self.n_aggs})")
        P, L, A = self.n_planes, self.n_leaves, self.n_aggs
        cap = self.link_cap * self.parallel_links
        self.up = np.full((P, L, A), cap, np.float64)
        self.down = np.full((P, A, L), cap, np.float64)
        ccap = self.core_cap
        self.up2 = np.full((P, self.n_pods, self.n_cores), ccap,
                           np.float64)
        self.down2 = np.full((P, self.n_pods, self.n_cores), ccap,
                             np.float64)
        self.access = np.full((P, self.n_hosts), self.access_cap,
                              np.float64)

    @property
    def n_leaves(self) -> int:
        return self.n_pods * self.leaves_per_pod

    @property
    def n_hosts(self) -> int:
        return self.n_leaves * self.hosts_per_leaf

    @property
    def core_cap(self) -> float:
        return (self.core_link_cap if self.core_link_cap > 0
                else self.link_cap * self.parallel_links)

    def leaf_of(self, host: int) -> int:
        return host // self.hosts_per_leaf


Fabric = Union[LeafSpine, FatTree]
