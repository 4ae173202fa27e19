"""Fabric shapes as data: the multi-plane leaf-spine and the 3-tier
fat-tree.

Link capacities are normalized to 1.0 = one port at line rate; parallel
links between switches appear as capacity > 1 on an edge, and every plane
is an independent copy joined only at the host NIC.  The slot engine
reads fault effects from a capacity timeline (`netsim.events`), so it
uses these classes for their shapes and pristine capacity arrays; the
host-side helpers of the figure benchmarks are here too, copies of the
reference's (`repro/netsim/topology.py`): each kind's `path_capacity`,
its fault injection (the capacity arrays edited in place, and
`random_link_failures` draw for draw, so a seed fails the same links in
both packages) and `copy`, and the exact leaf-pair max-flow
(`leaf_pair_maxflow`, `maxflow_matrix`: a min-cut across the stages,
summed over planes).  Beside them the fast-reroute backup table that
failure reaction walks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

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

    @property
    def n_paths(self) -> int:
        """Size of the per-(leaf pair) routing-choice axis."""
        return self.n_spines

    def leaf_of(self, host: int) -> int:
        return host // self.hosts_per_leaf

    def path_capacity(self, src_leaf: np.ndarray, dst_leaf: np.ndarray
                      ) -> np.ndarray:
        """(F, P, J) min capacity along each path for each leaf pair."""
        cap = np.minimum(self.up[:, src_leaf, :],
                         np.swapaxes(self.down, 1, 2)[:, dst_leaf, :])
        return cap.transpose(1, 0, 2)

    # ---- fault injection -------------------------------------------------
    def fail_uplink(self, plane: int, leaf: int, spine: int,
                    frac: float = 1.0) -> None:
        self.up[plane, leaf, spine] *= (1.0 - frac)
        self.down[plane, spine, leaf] *= (1.0 - frac)

    def trim_leaf_uplinks(self, plane: int, leaf: int,
                          keep_frac: float) -> None:
        """Reduce a leaf's uplink capacity to `keep_frac` (Fig 16)."""
        self.up[plane, leaf, :] *= keep_frac
        self.down[plane, :, leaf] *= keep_frac

    def fail_access(self, plane: int, host: int) -> None:
        self.access[plane, host] = 0.0

    def restore_access(self, plane: int, host: int) -> None:
        self.access[plane, host] = self.access_cap

    def random_link_failures(self, rng: np.random.Generator,
                             frac: float) -> None:
        """Uniform random fabric link failures (Fig 1c): each (leaf,
        spine) link of each plane loses one discrete link with
        probability `frac` (floor 0)."""
        for p in range(self.n_planes):
            mask = rng.random((self.n_leaves, self.n_spines)) < frac
            unit = self.link_cap
            self.up[p] = np.maximum(self.up[p] - mask * unit, 0.0)
            self.down[p] = np.maximum(self.down[p] - mask.T * unit, 0.0)

    def copy(self) -> "LeafSpine":
        t = LeafSpine(self.n_leaves, self.n_spines, self.hosts_per_leaf,
                      self.n_planes, self.parallel_links, self.link_cap,
                      self.access_cap)
        t.up = self.up.copy()
        t.down = self.down.copy()
        t.access = self.access.copy()
        return t


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
    def n_paths(self) -> int:
        return self.n_cores

    @property
    def cores_per_agg(self) -> int:
        return self.n_cores // self.n_aggs

    @property
    def core_cap(self) -> float:
        return (self.core_link_cap if self.core_link_cap > 0
                else self.link_cap * self.parallel_links)

    @property
    def agg_of_path(self) -> np.ndarray:
        """(C,) local agg index serving path (= core) j, in every pod."""
        return np.arange(self.n_cores) // self.cores_per_agg

    @property
    def pod_of_leaf(self) -> np.ndarray:
        return np.arange(self.n_leaves) // self.leaves_per_pod

    def leaf_of(self, host: int) -> int:
        return host // self.hosts_per_leaf

    def path_capacity(self, src_leaf: np.ndarray, dst_leaf: np.ndarray
                      ) -> np.ndarray:
        """(F, P, J) min capacity along each path: stage A on both ends,
        and the pod<->core hops when the pair crosses pods."""
        src_leaf = np.asarray(src_leaf)
        dst_leaf = np.asarray(dst_leaf)
        aj = self.agg_of_path
        capA = np.minimum(self.up[:, src_leaf, :][:, :, aj],
                          self.down[:, aj, :][:, :, dst_leaf]
                          .transpose(0, 2, 1))            # (P, F, J)
        pod_s = self.pod_of_leaf[src_leaf]
        pod_d = self.pod_of_leaf[dst_leaf]
        capB = np.minimum(self.up2[:, pod_s, :],
                          self.down2[:, pod_d, :])        # (P, F, J)
        cross = (pod_s != pod_d)[None, :, None]
        return np.where(cross, np.minimum(capA, capB),
                        capA).transpose(1, 0, 2)

    # ---- fault injection -------------------------------------------------
    def fail_uplink(self, plane: int, leaf: int, agg: int,
                    frac: float = 1.0) -> None:
        """Kill `frac` of a stage-A (leaf, local agg) link."""
        self.up[plane, leaf, agg] *= (1.0 - frac)
        self.down[plane, agg, leaf] *= (1.0 - frac)

    def fail_core_link(self, plane: int, pod: int, core: int,
                       frac: float = 1.0) -> None:
        """Kill `frac` of a stage-B (pod, core) link pair."""
        self.up2[plane, pod, core] *= (1.0 - frac)
        self.down2[plane, pod, core] *= (1.0 - frac)

    def fail_agg(self, plane: int, pod: int, agg: int) -> None:
        """Whole-switch loss: the agg's leaf links and core links die."""
        lo, hi = pod * self.leaves_per_pod, (pod + 1) * self.leaves_per_pod
        self.up[plane, lo:hi, agg] = 0.0
        self.down[plane, agg, lo:hi] = 0.0
        cores = np.flatnonzero(self.agg_of_path == agg)
        self.up2[plane, pod, cores] = 0.0
        self.down2[plane, pod, cores] = 0.0

    def trim_leaf_uplinks(self, plane: int, leaf: int,
                          keep_frac: float) -> None:
        self.up[plane, leaf, :] *= keep_frac
        self.down[plane, :, leaf] *= keep_frac

    def fail_access(self, plane: int, host: int) -> None:
        self.access[plane, host] = 0.0

    def restore_access(self, plane: int, host: int) -> None:
        self.access[plane, host] = self.access_cap

    def random_link_failures(self, rng: np.random.Generator,
                             frac: float) -> None:
        """Uniform random failures over both stages: every leaf-agg and
        every pod-core link loses one discrete link with probability
        `frac` (floor 0)."""
        for p in range(self.n_planes):
            mask = rng.random((self.n_leaves, self.n_aggs)) < frac
            unit = self.link_cap
            self.up[p] = np.maximum(self.up[p] - mask * unit, 0.0)
            self.down[p] = np.maximum(self.down[p] - mask.T * unit, 0.0)
            mask2 = rng.random((self.n_pods, self.n_cores)) < frac
            unit2 = self.core_cap
            self.up2[p] = np.maximum(self.up2[p] - mask2 * unit2, 0.0)
            self.down2[p] = np.maximum(self.down2[p] - mask2 * unit2, 0.0)

    def copy(self) -> "FatTree":
        t = FatTree(self.n_pods, self.leaves_per_pod, self.n_aggs,
                    self.n_cores, self.hosts_per_leaf, self.n_planes,
                    self.parallel_links, self.link_cap,
                    self.core_link_cap, self.access_cap)
        t.up = self.up.copy()
        t.down = self.down.copy()
        t.up2 = self.up2.copy()
        t.down2 = self.down2.copy()
        t.access = self.access.copy()
        return t


Fabric = Union[LeafSpine, FatTree]


def backup_path_table(kind: str, n_paths: int,
                      cores_per_agg: int = 1) -> np.ndarray:
    """(J,) precomputed fast-reroute successor per path index, from the
    fabric's shape alone.  The successor chain is a single cycle over
    all J paths, so `sim.backup_reassign`'s walk reaches every alive
    path.

    leaf_spine: the next spine, `(j + 1) % S`.

    fat_tree: a core under the next agg first (`j + cpa`, keeping the
    offset within the agg), since a stage-A (leaf, agg) failure takes
    out that agg's whole core bundle; the last agg wraps to agg 0 with
    the offset stepped (`(j % cpa + 1) % cpa`), which joins the agg
    chains into one J-cycle."""
    if kind == "leaf_spine":
        return ((np.arange(n_paths) + 1) % n_paths).astype(np.int32)
    j = np.arange(n_paths)
    cpa = cores_per_agg
    wrap = j >= n_paths - cpa                 # cores under the last agg
    return np.where(wrap, (j % cpa + 1) % cpa, j + cpa).astype(np.int32)


# ---------------------------------------------------------------------------
# max-flow as min-cut across stages
# ---------------------------------------------------------------------------

def _planes(t: Fabric, plane: Optional[int]) -> List[int]:
    return list(range(t.n_planes)) if plane is None else [plane]


def leaf_pair_maxflow(t: Fabric, l1: int, l2: int,
                      plane: Optional[int] = None) -> float:
    """Max flow leaf->leaf through the fabric, summed over every plane
    (`plane=None`; planes are disconnected copies joined at the NIC, so
    max-flow adds across them) or on one plane.

    leaf_spine: the sum over spines of min(up, down).
    fat_tree: the exact min-cut of the series-parallel layered graph:
    per agg, the leaf-facing bottleneck caps its parallel core bundle,
    sum_a min(min(up1, down1), sum_{j in a} min(up2, down2)) for a
    cross-pod pair; an intra-pod pair never leaves stage A."""
    total = 0.0
    for p in _planes(t, plane):
        if t.kind == "leaf_spine":
            total += float(np.sum(np.minimum(t.up[p, l1, :],
                                             t.down[p, :, l2])))
            continue
        capA = np.minimum(t.up[p, l1, :], t.down[p, :, l2])   # (A,)
        pod1 = int(t.pod_of_leaf[l1])
        pod2 = int(t.pod_of_leaf[l2])
        if pod1 == pod2:
            total += float(capA.sum())
            continue
        capB = np.minimum(t.up2[p, pod1, :], t.down2[p, pod2, :])  # (C,)
        bundle = capB.reshape(t.n_aggs, t.cores_per_agg).sum(1)
        total += float(np.minimum(capA, bundle).sum())
    return total


def maxflow_matrix(t: Fabric, plane: Optional[int] = None) -> np.ndarray:
    """(L, L) leaf-pair max-flow (Fig 1c), summed over planes
    (`plane=None`) or on one plane."""
    L = t.n_leaves
    out = np.zeros((L, L))
    for p in _planes(t, plane):
        if t.kind == "leaf_spine":
            up = t.up[p]                     # (L, S)
            down = t.down[p]                 # (S, L)
            out += np.minimum(up[:, None, :],
                              down.T[None, :, :]).sum(-1)
            continue
        capA = np.minimum(t.up[p][:, None, :],
                          t.down[p].T[None, :, :])        # (L, L, A)
        pods = t.pod_of_leaf
        # stage B varies per (pod, pod) only: bundle by pod, then gather
        # per leaf pair ((pods, pods, A), not (L, L, C))
        capB_pod = np.minimum(t.up2[p][:, None, :],
                              t.down2[p][None, :, :])     # (pods, pods, C)
        bundle_pod = capB_pod.reshape(t.n_pods, t.n_pods, t.n_aggs,
                                      t.cores_per_agg).sum(-1)
        bundle = bundle_pod[pods[:, None], pods[None, :]]  # (L, L, A)
        cross = pods[:, None] != pods[None, :]
        out += np.where(cross[:, :, None],
                        np.minimum(capA, bundle), capA).sum(-1)
    return out
