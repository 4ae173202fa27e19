"""Carrying slot-engine state across packages.

`operands_from_numpy` turns host-prepared NumPy operands (the flow
arrays, the flow→bucket aggregation plans, the per-segment capacity
snapshots, the slot→segment map and the ECMP assignment) into the
tensors `_slot_step` reads; `carry_from_numpy` turns a
`SimCarry`-shaped state of NumPy arrays into the engine's carry.  Both
take the reference engine's arrays as they are, so its state after slot
*k* can be handed to this engine's `_slot_step` and slot *k+1* compared
alone — the tool for finding where two trajectories fork.
`run_compiled` builds its own operands through the same function.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .state import FlowBatch, NicCarry, SimCarry


class SlotOperands(NamedTuple):
    """Everything the slot step reads besides the carry.  Capacity
    snapshots are already scaled to absolute capacity; `acc` is
    host-major so a flow gathers its (P,) row directly."""
    fb: FlowBatch
    pair_idx: torch.Tensor     # (F,) src_leaf * L + dst_leaf
    agg_src: torch.Tensor      # (H, Cs) flows by src host, padded with F
    agg_dst: torch.Tensor      # (H, Cd) flows by dst host
    agg_pair: torch.Tensor     # (L*L, Cp) flows by (src leaf, dst leaf)
    up: torch.Tensor           # (n_seg, P, L, S)
    down: torch.Tensor         # (n_seg, P, S, L)
    acc: torch.Tensor          # (n_seg, H, P)
    esr: torch.Tensor          # (F, 1) bool: ESR's extra cut applies
    seg_id: np.ndarray         # (T,) host-side slot -> segment
    # ECMP: the spine of each (flow, plane) per segment, the link-bucket
    # plans (`engine.AggPerms.ecmp_load`, int32 for the kernel), the
    # stacked up|down link capacities in the plans' row order, and each
    # flow's up / down link as a flat index into (P, L, S) / (P, S, L)
    assign: torch.Tensor       # (n_seg, F, P) int32
    ecmp_load: torch.Tensor    # (n_seg, P, 2*L*S, Cu) int32
    link_cap: torch.Tensor     # (n_seg, P, 2*L*S)
    ecmp_up: torch.Tensor      # (n_seg, F, P) int64
    ecmp_down: torch.Tensor    # (n_seg, F, P) int64


def operands_from_numpy(cfg, flows, aggs, seg_up: np.ndarray,
                        seg_down: np.ndarray, seg_acc: np.ndarray,
                        seg_id: np.ndarray, *, assign=None, device, dtype
                        ) -> SlotOperands:
    """`flows` has the `FlowArrays` fields (src, dst, src_leaf, dst_leaf,
    demand, bytes_total, start_slot); `aggs` has `src`/`dst`/`pair`/
    `ecmp_load` gather plans; `seg_up`/`seg_down`/`seg_acc` are
    (n_seg, ...) capacity multipliers; `seg_id` maps each slot to its
    segment; `assign` is the (n_seg, F, P) ECMP assignment (required
    under ECMP; AR/WAR default to the zero placeholder)."""
    device = torch.device(device)
    fb = FlowBatch.from_arrays(flows, device, dtype)
    F = fb.src.shape[0]
    P, L, S = cfg.n_planes, cfg.n_leaves, cfg.n_spines
    if assign is None:
        if cfg.routing == "ecmp":
            raise ValueError("ECMP operands need the assignment segments")
        assign = np.zeros((1, F, P), np.int32)
    assign = np.asarray(assign).astype(np.int64)
    planes = np.arange(P)[None, None, :]
    src_leaf = np.asarray(flows.src_leaf)[None, :, None]
    dst_leaf = np.asarray(flows.dst_leaf)[None, :, None]

    def plan(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    def caps(a, scale):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=device) * scale

    acc = np.ascontiguousarray(np.swapaxes(np.asarray(seg_acc), 1, 2))
    n_seg = np.asarray(seg_up).shape[0]
    link = np.concatenate([np.reshape(seg_up, (n_seg, P, L * S)),
                           np.reshape(seg_down, (n_seg, P, S * L))], -1)
    return SlotOperands(
        fb=fb, pair_idx=fb.src_leaf * cfg.n_leaves + fb.dst_leaf,
        agg_src=plan(aggs.src), agg_dst=plan(aggs.dst),
        agg_pair=plan(aggs.pair),
        up=caps(seg_up, cfg.uplink_cap), down=caps(seg_down, cfg.uplink_cap),
        acc=caps(acc, cfg.access_cap),
        esr=torch.full((F, 1), cfg.nic == "esr", dtype=torch.bool,
                       device=device),
        seg_id=np.asarray(seg_id, np.int64),
        assign=torch.as_tensor(assign, dtype=torch.int32, device=device),
        ecmp_load=torch.as_tensor(np.asarray(aggs.ecmp_load),
                                  dtype=torch.int32, device=device),
        link_cap=caps(link, cfg.uplink_cap),
        ecmp_up=plan((planes * L + src_leaf) * S + assign),
        ecmp_down=plan((planes * S + assign) * L + dst_leaf))


def carry_from_numpy(carry, *, device, dtype) -> SimCarry:
    """`carry` has the `SimCarry` fields (and `carry.nic` the `NicCarry`
    ones) as arrays; extra fields (the reference's fat-tree queues) are
    ignored."""
    device = torch.device(device)

    # copies: the source arrays may be read-only views of another
    # framework's buffers
    def floats(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def ints(a, dt):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    nic = carry.nic
    return SimCarry(
        q_up=floats(carry.q_up), q_down=floats(carry.q_down),
        nic=NicCarry(rate=floats(nic.rate), alpha=floats(nic.alpha),
                     probe_miss=ints(nic.probe_miss, torch.int32),
                     eligible=ints(nic.eligible, torch.bool),
                     pending_fail=ints(nic.pending_fail, torch.int64)),
        remaining=floats(carry.remaining), done=ints(carry.done, torch.bool),
        completion=ints(carry.completion, torch.int64),
        goodput_sum=floats(carry.goodput_sum),
        util_up=floats(carry.util_up))
