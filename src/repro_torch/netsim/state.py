"""Slot-engine state as NamedTuples of tensors.

`FlowBatch` is the static flow population, `NicCarry` the per-(flow,
plane) NIC control state, and `SimCarry` everything one slot hands to
the next: fabric queues, NIC state, transfer progress and the
post-warmup goodput accumulator.  All tensors live on one explicit
device; floats are float64 (parity mode) or float32 (fast mode).  A
batch of points of one structure gives every field a leading lane axis
(`carry.stack_operands`); the shapes below are one point's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fabric import FlowArrays


class FlowBatch(NamedTuple):
    src: torch.Tensor          # (F,) int64
    dst: torch.Tensor          # (F,) int64
    src_leaf: torch.Tensor     # (F,) int64
    dst_leaf: torch.Tensor     # (F,) int64
    demand: torch.Tensor       # (F,) float
    bytes_total: torch.Tensor  # (F,) float (inf = open-loop)
    start_slot: torch.Tensor   # (F,) int64
    same_leaf: torch.Tensor    # (F,) bool
    phase: torch.Tensor        # (F,) int64 demand-timeline lane

    @classmethod
    def from_arrays(cls, fa: FlowArrays, device: torch.device,
                    dtype: torch.dtype) -> "FlowBatch":
        """`fa` is a `FlowArrays` or anything with its array fields."""
        def ints(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        def floats(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        src_leaf, dst_leaf = ints(fa.src_leaf), ints(fa.dst_leaf)
        return cls(src=ints(fa.src), dst=ints(fa.dst), src_leaf=src_leaf,
                   dst_leaf=dst_leaf, demand=floats(fa.demand),
                   bytes_total=floats(fa.bytes_total),
                   start_slot=ints(fa.start_slot),
                   same_leaf=src_leaf == dst_leaf, phase=ints(fa.phase))


class NicCarry(NamedTuple):
    rate: torch.Tensor          # (F, P) allowances
    alpha: torch.Tensor         # (F, P) dcqcn alpha
    probe_miss: torch.Tensor    # (F, P) int32
    eligible: torch.Tensor      # (F, P) bool
    pending_fail: torch.Tensor  # (F, P) int64 (swlb delayed reaction)


class SimCarry(NamedTuple):
    """Stage-A queues (`q_up`/`q_down`: leaf↔spine on leaf_spine,
    leaf↔agg on fat_tree) plus the per-flow state; on a fat tree also
    the stage-B pod↔core queues `q2_up`/`q2_down`, which are None on
    leaf_spine (no placeholder for the slot to carry)."""
    q_up: torch.Tensor          # (P, L, S|A) queue, slot*cap units
    q_down: torch.Tensor        # (P, S|A, L)
    nic: NicCarry
    remaining: torch.Tensor     # (F,)
    done: torch.Tensor          # (F,) bool
    completion: torch.Tensor    # (F,) int64, -1 = unfinished
    goodput_sum: torch.Tensor   # (F,) sum of achieved over counted frames
    util_up: torch.Tensor       # (P, L, S|A) last slot's uplink utilization
    q2_up: Optional[torch.Tensor] = None     # (P, pods, C) fat_tree
    q2_down: Optional[torch.Tensor] = None   # (P, pods, C) fat_tree


def init_carry(fb: FlowBatch, cfg) -> SimCarry:
    """The carry before slot 0; a lane-stacked `fb` ((B, F) fields)
    gives every field the same leading lane axis."""
    lead, F = tuple(fb.demand.shape[:-1]), fb.demand.shape[-1]
    P, L, S = cfg.n_planes, cfg.n_leaves, cfg.n_up
    fat = cfg.kind == "fat_tree"
    dtype, device = fb.demand.dtype, fb.demand.device

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    nic = NicCarry(
        rate=torch.ones(lead + (F, P), dtype=dtype, device=device),
        alpha=zeros(F, P),
        probe_miss=zeros(F, P, dt=torch.int32),
        eligible=torch.ones(lead + (F, P), dtype=torch.bool,
                            device=device),
        pending_fail=zeros(F, P, dt=torch.int64))
    return SimCarry(
        q_up=zeros(P, L, S), q_down=zeros(P, S, L), nic=nic,
        remaining=fb.bytes_total.clone(), done=zeros(F, dt=torch.bool),
        completion=torch.full(lead + (F,), -1, dtype=torch.int64,
                              device=device),
        goodput_sum=zeros(F), util_up=zeros(P, L, S),
        q2_up=zeros(P, cfg.n_pods, cfg.n_cores) if fat else None,
        q2_down=zeros(P, cfg.n_pods, cfg.n_cores) if fat else None)
