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

`stack_operands` stacks the operands of several points of one structure
(the same fabric, flow count and segment map) into one lane-stacked
batch, the slot engine's counterpart of the reference's `vmap`.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.link_load import SegmentPlan

from .state import FlowBatch, NicCarry, SimCarry


class SparsePlans(NamedTuple):
    """The CSR plans of sparse aggregation (`link_load.SegmentPlan`:
    int32 offsets and entries; NumPy arrays from the host prep, tensors
    in `SlotOperands`).  Buckets are chunk-major: the flows go through
    the slot in chunks of `chunk` flows (one chunk, `chunk` = F, without
    `EngineConfig.flow_chunk`), and each chunk's plan lists its buckets'
    entries in flow order as flat indices into that chunk's (chunk, P)
    values (a batch's: into its lanes' (B, chunk, P) values, each lane's
    buckets after the one before).  `n_in` is how many leading flows
    the per-slot totals sum over (the flows before chunk padding)."""
    src: SegmentPlan              # offered by (src host, plane)
    dst: SegmentPlan              # offered by (dst host, plane)
    pair: Optional[SegmentPlan]   # AR/WAR: fabric rate by (plane, pair)
    # ECMP: fabric rate by link, per segment ((n_seg, ...) offsets and
    # entries): stage-A up, stage-A down, and on a fat tree stage-B up
    # and down, each family (P, ...) plane-major
    link: Optional[SegmentPlan]
    chunk: int
    n_in: int


class SlotOperands(NamedTuple):
    """Everything the slot step reads besides the carry.  Capacity
    snapshots are already scaled to absolute capacity; `acc` is
    host-major so a flow gathers its (P,) row directly.  Stage A is
    leaf↔spine on leaf_spine and leaf↔agg on fat_tree (`U` = spines or
    aggs); the fat-tree fields are None on leaf_spine."""
    fb: FlowBatch
    pair_idx: torch.Tensor     # (F,) src_leaf * L + dst_leaf
    agg_src: torch.Tensor      # (H, Cs) flows by src host, padded with F
    agg_dst: torch.Tensor      # (H, Cd) flows by dst host
    agg_pair: torch.Tensor     # (L*L, Cp) flows by (src leaf, dst leaf)
    up: torch.Tensor           # (n_seg, P, L, U)
    down: torch.Tensor         # (n_seg, P, U, L)
    acc: torch.Tensor          # (n_seg, H, P)
    esr: torch.Tensor          # (F, 1) bool: ESR's extra cut applies
    seg_id: np.ndarray         # (T,) host-side slot -> segment
    # ECMP: the path of each (flow, plane) per segment, the link-bucket
    # plans (`engine.AggPerms.ecmp_load`, int32 for the kernel), the
    # stacked link capacities in the plans' row order, and each flow's
    # stage-A up / down link as a flat index into (P, L, U) / (P, U, L)
    assign: torch.Tensor       # (n_seg, F, P) int32
    ecmp_load: torch.Tensor    # (n_seg, P, rows, Cu) int32
    link_cap: torch.Tensor     # (n_seg, P, rows)
    ecmp_up: torch.Tensor      # (n_seg, F, P) int64
    ecmp_down: torch.Tensor    # (n_seg, F, P) int64
    # fat tree: the pod↔core capacities, the static path→agg and
    # leaf→pod maps, which leaf pairs and flows cross pods, and (ECMP)
    # each flow's stage-B up / down link as a flat index into
    # (P, pods, C)
    up2: Optional[torch.Tensor] = None       # (n_seg, P, pods, C)
    down2: Optional[torch.Tensor] = None     # (n_seg, P, pods, C)
    path_agg: Optional[torch.Tensor] = None  # (C,) int64: core -> agg
    leaf_pod: Optional[torch.Tensor] = None  # (L,) int64: leaf -> pod
    cross_pair: Optional[torch.Tensor] = None  # (L, L) bool
    cross: Optional[torch.Tensor] = None     # (F, 1) bool
    ecmp_up2: Optional[torch.Tensor] = None  # (n_seg, F, P) int64
    ecmp_down2: Optional[torch.Tensor] = None
    # failure reaction: the routing-visible (detection-lagged) view of
    # up, down, up2 and down2; the physical tensors themselves when the
    # reaction is off
    vup: Optional[torch.Tensor] = None
    vdown: Optional[torch.Tensor] = None
    vup2: Optional[torch.Tensor] = None
    vdown2: Optional[torch.Tensor] = None
    # schedule workloads (`cfg.n_phases` > 0): each segment's demand
    # multiplier of every timeline lane; a flow's demand is scaled by
    # its lane's (`fb.phase`) value
    dem: Optional[torch.Tensor] = None       # (n_seg, K)
    # sparse aggregation (`cfg.agg_mode == "sparse"`): the segment-sum
    # plans, which replace the `agg_*` and `ecmp_load` gather plans
    # (inert placeholders then), and under ECMP the link capacities in
    # the link plan's bucket order (family-major: stage-A up (P, L, U),
    # down (P, U, L), then stage B's), which the segment sum's
    # bottleneck epilogue reads
    sparse: Optional[SparsePlans] = None
    sparse_link_cap: Optional[torch.Tensor] = None   # (n_seg, rows)


def operands_from_numpy(cfg, flows, aggs, seg_up: np.ndarray,
                        seg_down: np.ndarray, seg_acc: np.ndarray,
                        seg_id: np.ndarray, *, assign=None, seg_up2=None,
                        seg_down2=None, vis=None, seg_dem=None,
                        sparse=None, device, dtype) -> SlotOperands:
    """`flows` has the `FlowArrays` fields (src, dst, src_leaf, dst_leaf,
    demand, bytes_total, start_slot, phase); `aggs` has `src`/`dst`/`pair`/
    `ecmp_load` gather plans; `seg_up`/`seg_down`/`seg_acc` (and, on a
    fat tree, `seg_up2`/`seg_down2`) are (n_seg, ...) capacity
    multipliers; `seg_id` maps each slot to its segment; `assign` is the
    (n_seg, F, P) ECMP assignment (required under ECMP; AR/WAR default
    to the zero placeholder); `vis` is the (up, down, up2, down2)
    routing-visible multipliers of a failure reaction (None: routing
    sees the physical fabric); `seg_dem` is the (n_seg, K) demand
    multipliers of a schedule run (`cfg.n_phases` > 0, else None);
    `sparse` the `SparsePlans` of NumPy arrays of a sparse run (else
    None)."""
    device = torch.device(device)
    fb = FlowBatch.from_arrays(flows, device, dtype)
    F = fb.src.shape[0]
    P, L, U = cfg.n_planes, cfg.n_leaves, cfg.n_up
    fat = cfg.kind == "fat_tree"
    if assign is None:
        if cfg.routing == "ecmp":
            raise ValueError("ECMP operands need the assignment segments")
        assign = np.zeros((1, F, P), np.int32)
    assign = np.asarray(assign).astype(np.int64)
    planes = np.arange(P)[None, None, :]
    src_leaf = np.asarray(flows.src_leaf)[None, :, None]
    dst_leaf = np.asarray(flows.dst_leaf)[None, :, None]
    a_of = assign // cfg.cores_per_agg             # the path's agg (or spine)

    def plan(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    def caps(a, scale):
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=device) * scale

    acc = np.ascontiguousarray(np.swapaxes(np.asarray(seg_acc), 1, 2))
    up, down = caps(seg_up, cfg.uplink_cap), caps(seg_down, cfg.uplink_cap)
    stages = [up, down]
    ft = {}
    if fat:
        pods, C, lpp = cfg.n_pods, cfg.n_cores, cfg.leaves_per_pod
        ft = dict(up2=caps(seg_up2, cfg.core_cap),
                  down2=caps(seg_down2, cfg.core_cap))
        stages += [ft["up2"], ft["down2"]]
        pol = np.arange(L) // lpp
        cross = np.asarray(flows.src_leaf) // lpp != \
            np.asarray(flows.dst_leaf) // lpp
        ft.update(
            path_agg=plan(np.arange(C) // cfg.cores_per_agg),
            leaf_pod=plan(pol),
            cross_pair=torch.as_tensor(pol[:, None] != pol[None, :],
                                       device=device),
            cross=torch.as_tensor(cross[:, None], device=device),
            ecmp_up2=plan((planes * pods + src_leaf // lpp) * C + assign),
            ecmp_down2=plan((planes * pods + dst_leaf // lpp) * C
                            + assign))
    n_seg = up.shape[0]
    vup, vdown, vup2, vdown2 = (
        (up, down, ft.get("up2"), ft.get("down2")) if vis is None else
        (caps(vis[0], cfg.uplink_cap), caps(vis[1], cfg.uplink_cap),
         caps(vis[2], cfg.core_cap) if fat else None,
         caps(vis[3], cfg.core_cap) if fat else None))
    return SlotOperands(
        fb=fb, pair_idx=fb.src_leaf * cfg.n_leaves + fb.dst_leaf,
        agg_src=plan(aggs.src), agg_dst=plan(aggs.dst),
        agg_pair=plan(aggs.pair), up=up, down=down,
        acc=caps(acc, cfg.access_cap),
        esr=torch.full((F, 1), cfg.nic == "esr", dtype=torch.bool,
                       device=device),
        seg_id=np.asarray(seg_id, np.int64),
        assign=torch.as_tensor(assign, dtype=torch.int32, device=device),
        ecmp_load=torch.as_tensor(np.asarray(aggs.ecmp_load),
                                  dtype=torch.int32, device=device),
        link_cap=torch.cat([s.reshape(n_seg, P, -1) for s in stages], -1),
        ecmp_up=plan((planes * L + src_leaf) * U + a_of),
        ecmp_down=plan((planes * U + a_of) * L + dst_leaf),
        vup=vup, vdown=vdown, vup2=vup2, vdown2=vdown2,
        dem=None if seg_dem is None else torch.as_tensor(
            np.asarray(seg_dem), dtype=dtype, device=device),
        sparse=None if sparse is None else _plans_to(sparse, device),
        sparse_link_cap=None if sparse is None or cfg.routing != "ecmp"
        else torch.cat([s.reshape(n_seg, -1) for s in stages], -1), **ft)


def _plans_to(plans: SparsePlans, device) -> SparsePlans:
    """`plans`' NumPy arrays as int32 tensors on `device`."""
    def to(plan):
        def to_dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                   device=device)
        return None if plan is None else plan._replace(
            offsets=to_dev(plan.offsets), entries=to_dev(plan.entries))
    return plans._replace(src=to(plans.src), dst=to(plans.dst),
                          pair=to(plans.pair), link=to(plans.link))


def carry_from_numpy(carry, *, device, dtype) -> SimCarry:
    """`carry` has the `SimCarry` fields (and `carry.nic` the `NicCarry`
    ones) as arrays.  The stage-B queues `q2_up`/`q2_down` come across
    from a fat-tree carry (a pod axis of at least 2); the reference's
    (P, 1, 1) leaf-spine placeholders stay behind as None."""
    device = torch.device(device)

    # copies: the source arrays may be read-only views of another
    # framework's buffers
    def floats(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def ints(a, dt):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    nic = carry.nic
    q2_up = getattr(carry, "q2_up", None)
    fat = q2_up is not None and np.shape(q2_up)[1] > 1
    return SimCarry(
        q_up=floats(carry.q_up), q_down=floats(carry.q_down),
        nic=NicCarry(rate=floats(nic.rate), alpha=floats(nic.alpha),
                     probe_miss=ints(nic.probe_miss, torch.int32),
                     eligible=ints(nic.eligible, torch.bool),
                     pending_fail=ints(nic.pending_fail, torch.int64)),
        remaining=floats(carry.remaining), done=ints(carry.done, torch.bool),
        completion=ints(carry.completion, torch.int64),
        goodput_sum=floats(carry.goodput_sum),
        util_up=floats(carry.util_up),
        q2_up=floats(q2_up) if fat else None,
        q2_down=floats(carry.q2_down) if fat else None)


# SlotOperands fields with a leading segment axis; the lane axis of a
# stacked batch comes second, so `ops.up[seg]` is the segment's (B, ...)
_PER_SEGMENT = ("up", "down", "acc", "assign", "ecmp_load", "link_cap",
                "ecmp_up", "ecmp_down", "up2", "down2", "ecmp_up2",
                "ecmp_down2", "vup", "vdown", "vup2", "vdown2", "dem",
                "sparse_link_cap")
# fields the lanes share (the fabric's static maps)
_SHARED = ("path_agg", "leaf_pod", "cross_pair")


def stack_operands(lanes: Sequence[SlotOperands], cfg) -> SlotOperands:
    """One batch of the points' operands (each from `operands_from_numpy`
    for one `cfg`, on the segments of one `seg_id`, with plans of one
    width).  Per-flow and per-host fields gain a leading lane axis B,
    per-segment ones a lane axis after the segment's.  The slot's
    gathers read the lanes' tensors stacked as one table, so the index
    fields carry each lane's offset: `fb.src`/`fb.dst` into (B·H, P)
    rows, `pair_idx` into (B·L·L, P), the `agg_*` plans into (B·(F+1),
    P) (each lane's pad reads its own zero row) and `ecmp_up*`/
    `ecmp_down*` into the flattened (B, P, ...) link tensors.  The ECMP
    load plans keep per-lane flow indices: `bucket_load_bottleneck`
    takes the lane axis itself.  The sparse plans become one plan over
    the lanes' values stacked (`_stack_plan`)."""
    lanes = list(lanes)
    first = lanes[0]
    for k, ops in enumerate(lanes):
        if not np.array_equal(ops.seg_id, first.seg_id):
            raise ValueError(f"lane {k}: another segment map")
    F = first.fb.src.shape[0]
    P, L, H = cfg.n_planes, cfg.n_leaves, cfg.n_hosts
    per_lane = {"src": H, "dst": H, "pair_idx": L * L, "agg_src": F + 1,
                "agg_dst": F + 1, "agg_pair": F + 1,
                "ecmp_up": P * L * cfg.n_up, "ecmp_down": P * L * cfg.n_up,
                "ecmp_up2": P * cfg.n_pods * cfg.n_cores,
                "ecmp_down2": P * cfg.n_pods * cfg.n_cores}

    def stack(name, ts: List[torch.Tensor], dim: int):
        if name in per_lane:
            ts = [t + b * per_lane[name] for b, t in enumerate(ts)]
        return torch.stack(ts, dim)

    fb = FlowBatch(*(stack(name, [getattr(o.fb, name) for o in lanes], 0)
                     for name in FlowBatch._fields))
    out = {}
    if first.sparse is not None:
        out["sparse"] = _stack_sparse([o.sparse for o in lanes], F, P)
    for name in SlotOperands._fields:
        vals = [getattr(o, name) for o in lanes]
        if name in ("fb", "seg_id", "sparse") or vals[0] is None:
            continue
        if name in _SHARED:
            out[name] = vals[0]
        elif name in _PER_SEGMENT:
            # a view that is its physical field (no failure reaction)
            # stays that field, not a copy
            phys = name[1:] if name.startswith("v") else None
            if phys and all(v is getattr(o, phys) for v, o in
                            zip(vals, lanes)):
                out[name] = out[phys]
            else:
                out[name] = stack(name, vals, 1)
        else:
            out[name] = stack(name, vals, 0)
    return first._replace(fb=fb, **out)



def _stack_plan(plans: Sequence[SegmentPlan], n_chunks: int,
                stride: int) -> SegmentPlan:
    """The lanes' chunk-major plans as one plan over their (B, chunk, P)
    values: chunk by chunk, lane b's buckets after lane b - 1's, its
    entries offset by `b * stride` (a lane's chunk of values).  Only
    the offsets visit the host.  Its width is the lanes' widest."""
    offs = [p.offsets.cpu().long() for p in plans]
    K = (offs[0].numel() - 1) // n_chunks
    o_parts, e_parts, pos = [torch.zeros(1, dtype=torch.int64)], [], 0
    for c in range(n_chunks):
        for b, (o, p) in enumerate(zip(offs, plans)):
            o = o[c * K:(c + 1) * K + 1]
            lo, hi = int(o[0]), int(o[-1])
            o_parts.append(o[1:] - lo + pos)
            e_parts.append(p.entries[lo:hi] + b * stride)
            pos += hi - lo
    dev = plans[0].entries.device
    return SegmentPlan(torch.cat(o_parts).to(torch.int32).to(dev),
                       torch.cat(e_parts).to(torch.int32),
                       max(p.width for p in plans))


def _stack_sparse(lanes: Sequence[SparsePlans], F: int,
                  P: int) -> SparsePlans:
    """The lanes' sparse plans over their (B, F, P) values stacked
    (`_stack_plan`); the ECMP link plans segment by segment."""
    first = lanes[0]
    for k, sp in enumerate(lanes):
        if (sp.chunk, sp.n_in) != (first.chunk, first.n_in):
            raise ValueError(f"lane {k}: plans of another chunking")
    nc, stride = F // first.chunk, first.chunk * P

    def stack(plans):
        return _stack_plan(plans, nc, stride)

    link = None
    if first.link is not None:
        segs = [stack([SegmentPlan(sp.link.offsets[g], sp.link.entries[g],
                                   sp.link.width) for sp in lanes])
                for g in range(first.link.offsets.shape[0])]
        link = SegmentPlan(torch.stack([x.offsets for x in segs]),
                           torch.stack([x.entries for x in segs]),
                           max(x.width for x in segs))
    return first._replace(
        src=stack([sp.src for sp in lanes]),
        dst=stack([sp.dst for sp in lanes]),
        pair=None if first.pair is None else stack([sp.pair for sp in lanes]),
        link=link)
