"""The slot engine: one fluid-network slot as a function of
`(SimCarry, t)`, run in a Python loop over slots.

One slot reproduces, operation for operation, the reference engine's
static-dispatch slot on a leaf-spine fabric under AR, weighted AR or
ECMP:

  PLB plane split -> routing (AR/WAR: spine fractions from the queue
  carry; ECMP: the hashed spine of each (flow, plane) from the
  assignment replay) -> per-link bottleneck scaling -> queue/ECN/RTT
  evolution -> NIC control update (`spx|dcqcn|global|esr|swlb`) ->
  loss-stall masking -> transfer completion.

The per-slot hot spots go through the `repro_torch.kernels` wrappers
(hand-written CUDA on the GPU, the plain PyTorch versions on the CPU).
Faults arrive as a piecewise-constant capacity timeline (`events.py`)
compressed to per-segment snapshots, and ECMP's path assignment as one
table per segment; the slot→segment map stays on the host, so the loop
never waits for the device.

Every sum that feeds the queue integrators (flows into host, leaf-pair
and ECMP link buckets, pair rates times fractions into link loads) runs
left to right in flow order, as the NumPy engine's `np.add.at` does; the
short plane and spine sums run left to right too.  The CPU and GPU runs
therefore differ only where `exp` does.

The fat-tree fabric, failure reaction, traces and schedule phases are
later slices of the port and raise `NotImplementedError`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.jsq_route import pair_fractions
from repro_torch.kernels.link_load import bottleneck_many, \
    bucket_load_bottleneck
from repro_torch.kernels.plb_select import plane_split
from repro_torch.kernels.queue_ecn import nic_update, queue_update_many
from repro_torch.kernels.ref import lsum, sdiv

from .carry import SlotOperands, operands_from_numpy
from .cc import (DCQCN_AI, DCQCN_ALPHA_G, MIN_RATE, PROBE_TIMEOUT, SPX_AI,
                 SPX_MD, SPX_RTT_GAIN, TARGET_RTT_US)
from .events import FaultTimeline, compile_fault_timeline, \
    ecmp_assign_segments
from .fabric import AR_TEMPERATURE, ECN_QUEUE_THRESH, JSQ_BINS, Q_CAP, \
    FlowArrays
from .sim import SimConfig
from .state import NicCarry, SimCarry, init_carry

_EPS = 1e-12
_SPLIT_MODE = {"spx": "spx", "dcqcn": "dcqcn", "global": "agg",
               "esr": "agg", "swlb": "swlb"}


@dataclass(frozen=True)
class EngineConfig:
    """Static simulation parameters: sim knobs, fabric shape and the
    fluid-model constants."""
    slots: int
    slot_us: float
    routing: str
    nic: str
    base_rtt_us: float
    warmup_frac: float
    record_every: int
    sw_lb_delay_slots: int
    n_planes: int
    n_leaves: int
    n_spines: int
    n_hosts: int
    uplink_cap: float
    access_cap: float
    target_rtt_us: float = TARGET_RTT_US
    probe_timeout: int = PROBE_TIMEOUT
    ecn_queue_thresh: float = ECN_QUEUE_THRESH
    ar_temperature: float = AR_TEMPERATURE
    jsq_bins: int = JSQ_BINS
    q_cap: float = Q_CAP

    @classmethod
    def from_sim(cls, cfg: SimConfig, topo) -> "EngineConfig":
        """`topo` is a `TopologySpec` (or anything with its shape
        attributes).  Raises `NotImplementedError` outside the slice."""
        if getattr(topo, "kind", "leaf_spine") != "leaf_spine":
            raise NotImplementedError(
                "fat-tree fabrics arrive with the fat-tree slice of the "
                "port")
        if cfg.routing not in ("ar", "war", "ecmp"):
            raise ValueError(f"unknown routing {cfg.routing!r}")
        if cfg.trace.enabled:
            raise NotImplementedError(
                "traces arrive with the trace slice of the port")
        return cls(
            slots=cfg.slots, slot_us=cfg.slot_us, routing=cfg.routing,
            nic=cfg.nic, base_rtt_us=cfg.base_rtt_us,
            warmup_frac=cfg.warmup_frac, record_every=cfg.record_every,
            sw_lb_delay_slots=cfg.sw_lb_delay_slots(),
            n_planes=topo.n_planes, n_leaves=topo.n_leaves,
            n_spines=topo.n_spines, n_hosts=topo.n_hosts,
            uplink_cap=topo.link_cap * topo.parallel_links,
            access_cap=topo.access_cap)

    def frames(self) -> Tuple[int, int]:
        """(recorded frames, first post-warmup frame)."""
        r = self.record_every
        n_rec = (self.slots + r - 1) // r
        return n_rec, int(n_rec * self.warmup_frac)


@dataclass
class EngineResult:
    """Distilled run output, the fields `scenarios.runner` reads (the
    shape of the reference engine's result)."""
    mean_goodput: np.ndarray     # (F,) post-warmup average
    completion_slot: np.ndarray  # (F,) -1 = unfinished
    total_goodput: np.ndarray    # (T_rec,) summed over flows per frame
    util_up_last: np.ndarray     # (P, L, S)
    groups: List[str]
    group_of: np.ndarray
    slot_us: float
    device: str


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run the plain PyTorch path")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


# ---------------------------------------------------------------------------
# NIC: plane split + control update
# ---------------------------------------------------------------------------

def _plane_split(cfg: EngineConfig, nic: NicCarry,
                 demand: torch.Tensor) -> torch.Tensor:
    return plane_split(nic.rate, nic.eligible, demand,
                       mode=_SPLIT_MODE[cfg.nic], min_rate=MIN_RATE)


def _probe_common(cfg: EngineConfig, nic: NicCarry, probe_ok):
    # saturate at the timeout: `dead` is unchanged (>= comparison)
    bump = torch.clamp_max(nic.probe_miss + 1, cfg.probe_timeout)
    probe_miss = torch.where(probe_ok, 0, bump)
    return probe_miss, probe_miss >= cfg.probe_timeout


def _probe_basic(cfg, nic: NicCarry, rate, probe_ok, slot: int) -> NicCarry:
    probe_miss, dead = _probe_common(cfg, nic, probe_ok)
    eligible = ~dead
    just_back = eligible & ~nic.eligible
    rate = torch.where(just_back, 0.5, rate)
    rate = torch.where(eligible, rate, MIN_RATE)
    return NicCarry(rate=rate, alpha=nic.alpha, probe_miss=probe_miss,
                    eligible=eligible, pending_fail=nic.pending_fail)


def _probe_swlb(cfg, nic: NicCarry, rate, probe_ok, slot: int) -> NicCarry:
    if cfg.sw_lb_delay_slots <= 0:
        return _probe_basic(cfg, nic, rate, probe_ok, slot)
    probe_miss, dead = _probe_common(cfg, nic, probe_ok)
    eligible, pending = nic.eligible, nic.pending_fail
    newly = dead & eligible & (pending == 0)
    pending = torch.where(newly, slot + cfg.sw_lb_delay_slots, pending)
    fire = (pending > 0) & (slot >= pending)
    eligible = eligible & ~(fire & dead)
    eligible = eligible | (~dead & ~eligible)
    pending = torch.where(dead, pending, 0)
    rate = torch.where(eligible, rate, MIN_RATE)
    return NicCarry(rate=rate, alpha=nic.alpha, probe_miss=probe_miss,
                    eligible=eligible, pending_fail=pending)


def _upd_rate(cfg: EngineConfig, mode: str, nic: NicCarry, qmean, esr):
    """RTT/ECN derivation + one CC rate branch through the `nic_update`
    kernel.  Returns `(rtt, ecn, rate, alpha)`."""
    return nic_update(
        qmean, nic.rate, nic.alpha, esr, mode=mode,
        base_rtt_us=cfg.base_rtt_us, slot_us=cfg.slot_us,
        ecn_thresh=cfg.ecn_queue_thresh, target_rtt_us=cfg.target_rtt_us,
        min_rate=MIN_RATE, md=SPX_MD, ai=SPX_AI, rtt_gain=SPX_RTT_GAIN,
        dcqcn_ai=DCQCN_AI, alpha_g=DCQCN_ALPHA_G)


def _upd_dcqcn(cfg, nic, qmean, probe_ok, slot, esr):
    rtt, ecn, rate, alpha = _upd_rate(cfg, "dcqcn", nic, qmean, esr)
    return nic._replace(rate=rate, alpha=alpha), rtt, ecn


def _upd_agg(cfg, nic, qmean, probe_ok, slot, esr):
    """'global'/'esr': one aggregate CC context across planes."""
    rtt, ecn, rate, _ = _upd_rate(cfg, "agg", nic, qmean, esr)
    return _probe_basic(cfg, nic, rate, probe_ok, slot), rtt, ecn


def _upd_spx(cfg, nic, qmean, probe_ok, slot, esr):
    rtt, ecn, rate, _ = _upd_rate(cfg, "spx", nic, qmean, esr)
    return _probe_basic(cfg, nic, rate, probe_ok, slot), rtt, ecn


def _upd_swlb(cfg, nic, qmean, probe_ok, slot, esr):
    # swlb shares spx's per-plane AIMD law; only the probe path differs
    rtt, ecn, rate, _ = _upd_rate(cfg, "spx", nic, qmean, esr)
    return _probe_swlb(cfg, nic, rate, probe_ok, slot), rtt, ecn


_NIC_UPDATE = {"spx": _upd_spx, "dcqcn": _upd_dcqcn, "global": _upd_agg,
               "esr": _upd_agg, "swlb": _upd_swlb}


def _nic_update(cfg: EngineConfig, nic: NicCarry, qmean, probe_ok,
                slot: int, esr) -> Tuple[NicCarry, torch.Tensor,
                                         torch.Tensor]:
    """NIC control update (pre-stall rates).  Returns the new NIC state
    plus rtt/ecn."""
    return _NIC_UPDATE[cfg.nic](cfg, nic, qmean, probe_ok, slot, esr)


# ---------------------------------------------------------------------------
# routing fractions and link loads
# ---------------------------------------------------------------------------

def _pair_fractions(cfg: EngineConfig, q, cap, down, use_war: bool):
    """(P, L_src, L_dst, S) spine split; WAR folds in remote weights
    (healthy down-capacity of each spine toward the dst leaf)."""
    w = cap
    if use_war:
        rw = down / down.amax(1, keepdim=True).clamp_min(1e-9)
        w = (w * rw.transpose(1, 2)[:, None, :, :]).contiguous()
    return pair_fractions(q, cap, w, nbins=cfg.jsq_bins,
                          temperature=cfg.ar_temperature, qmax=8.0)


def _perm_matrix(keys: np.ndarray, n_buckets: int, width: int,
                 pad: int) -> np.ndarray:
    """(n_buckets, width) flow indices grouped by key, flow order
    preserved within a bucket, padded with `pad`."""
    perm = np.full((n_buckets, width), pad, np.int32)
    keys = np.asarray(keys)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    counts = np.bincount(sk, minlength=n_buckets)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.arange(len(sk)) - starts[sk]
    perm[sk, ranks] = order
    return perm


def _seg_sum(vals: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """vals (F, P), perm (K, C) -> (K, P) bucket sums, each bucket's
    flows added left to right in flow order (pad rows add exact 0.0)."""
    pad = torch.cat([vals, vals.new_zeros((1, vals.shape[1]))], 0)
    return lsum(pad[perm].transpose(1, 2))


def _pair_rate_sum(cfg: EngineConfig, fabric_rate: torch.Tensor,
                   perm: torch.Tensor) -> torch.Tensor:
    """(P, L, L) offered rate summed by (src-leaf, dst-leaf) pair."""
    P, L = cfg.n_planes, cfg.n_leaves
    return _seg_sum(fabric_rate, perm).T.reshape(P, L, L)


def _route_pair(cfg: EngineConfig, carry: SimCarry, fabric_rate, up, down,
                ops: SlotOperands, use_war: bool):
    """AR / weighted-AR, up to the link loads: leaf-pair spine
    fractions, the pair queues they were scored on, and the up and down
    link loads.  `_pair_through` finishes the routing once the loads
    are scaled."""
    # kernel operands are contiguous whatever layout broadcasting picks
    cap = torch.minimum(up[:, :, None, :],
                        down.transpose(1, 2)[:, None, :, :]).contiguous()
    q = (carry.q_up[:, :, None, :] +
         carry.q_down.transpose(1, 2)[:, None, :, :]).contiguous()
    pair = _pair_fractions(cfg, q, cap, down, use_war)
    rate_pair = _pair_rate_sum(cfg, fabric_rate, ops.agg_pair)
    contrib = rate_pair[..., None] * pair                  # (P, L, L, S)
    # einsum("plm,plms->pls") / ("plm,plms->psm") as ordered sums
    load_up = lsum(contrib.permute(0, 1, 3, 2))            # (P, L, S)
    load_down = lsum(contrib.permute(0, 3, 2, 1))          # (P, S, L)
    return pair, q, load_up, load_down


def _pair_through(cfg: EngineConfig, fabric_rate, pair, q, f_up, f_down,
                  ops: SlotOperands):
    """AR / weighted-AR, from the links' bottleneck scales: the per-flow
    fabric throughput and mean path queue."""
    P, L = cfg.n_planes, cfg.n_leaves
    scale_pair = torch.minimum(f_up[:, :, None, :],
                               f_down.transpose(1, 2)[:, None, :, :])
    path_scale = lsum(pair * scale_pair).reshape(P, L * L)
    through = fabric_rate * path_scale[:, ops.pair_idx].T
    qmean = lsum(pair * q).reshape(P, L * L)[:, ops.pair_idx].T
    return through, qmean


def _route_ecmp(cfg: EngineConfig, carry: SimCarry, fabric_rate,
                ops: SlotOperands, seg: int):
    """ECMP: each (flow, plane) rides the spine of this segment's
    assignment.  One `bucket_load_bottleneck` launch sums the flows of
    every up and down link bucket in flow order and scales them; each
    flow then reads the fractions and queues of its two links."""
    P, L, S = cfg.n_planes, cfg.n_leaves, cfg.n_spines
    LS = L * S
    loads, fracs = bucket_load_bottleneck(
        fabric_rate, ops.ecmp_load[seg], ops.link_cap[seg], eps=_EPS)
    load_up = loads[:, :LS].reshape(P, L, S).contiguous()
    load_down = loads[:, LS:].reshape(P, S, L).contiguous()
    up_idx, down_idx = ops.ecmp_up[seg], ops.ecmp_down[seg]   # (F, P)
    scale_f = torch.minimum(
        torch.take(fracs[:, :LS], up_idx),
        torch.take(fracs[:, LS:], down_idx))
    through = fabric_rate * scale_f
    qmean = torch.take(carry.q_up, up_idx) + \
        torch.take(carry.q_down, down_idx)
    return load_up, load_down, through, qmean


# ---------------------------------------------------------------------------
# one slot
# ---------------------------------------------------------------------------

def _slot_step(cfg: EngineConfig, ops: SlotOperands, carry: SimCarry,
               t: int) -> Tuple[SimCarry, torch.Tensor]:
    """Slot `t`: returns the next carry and this slot's total goodput
    (a 0-d tensor on the device)."""
    seg = int(ops.seg_id[t])
    up, down, acc = ops.up[seg], ops.down[seg], ops.acc[seg]
    fb = ops.fb

    demand = torch.where(carry.done | (t < fb.start_slot), 0.0, fb.demand)
    offered = _plane_split(cfg, carry.nic, demand)        # (F, P)
    same_leaf = fb.same_leaf[:, None]
    fabric_rate = torch.where(same_leaf, 0.0, offered)

    # every link scale of the slot in one bottleneck launch: the access
    # links', and under AR/WAR the fabric links' too (ECMP's come from
    # bucket_load_bottleneck)
    load_acc_tx = _seg_sum(offered, ops.agg_src)          # (H, P)
    load_acc_rx = _seg_sum(offered, ops.agg_dst)
    access = ((acc, load_acc_tx), (acc, load_acc_rx))
    if cfg.routing == "ecmp":
        load_up, load_down, through, qmean = _route_ecmp(
            cfg, carry, fabric_rate, ops, seg)
        f_acc_tx, f_acc_rx = bottleneck_many(access, eps=_EPS)
    else:
        pair, q, load_up, load_down = _route_pair(
            cfg, carry, fabric_rate, up, down, ops, cfg.routing == "war")
        f_up, f_down, f_acc_tx, f_acc_rx = bottleneck_many(
            ((up, load_up), (down, load_down)) + access, eps=_EPS)
        through, qmean = _pair_through(cfg, fabric_rate, pair, q, f_up,
                                       f_down, ops)
    # access liveness doubles as the RTT probe result: a plane is
    # reachable iff both endpoints' access links on it are up
    alive = (acc[fb.src] > _EPS) & (acc[fb.dst] > _EPS)   # (F, P)

    local = torch.where(same_leaf, offered, 0.0)
    acc_scale = torch.minimum(f_acc_tx[fb.src], f_acc_rx[fb.dst])
    achieved_pp = torch.where(alive, (through + local) * acc_scale, 0.0)
    qmean = torch.where(same_leaf, 0.0, qmean).contiguous()

    # both link directions in one queue_update launch; only the up
    # links' utilization is kept
    (q_up, util), (q_down, _) = queue_update_many(
        ((carry.q_up, load_up, up), (carry.q_down, load_down, down)),
        q_cap=cfg.q_cap, eps=_EPS)

    nic, rtt, _ = _nic_update(cfg, carry.nic, qmean, alive, t, ops.esr)

    # packet-loss stall + completion
    stalled = ((offered > 1e-9) & (achieved_pp <= 1e-9)).any(1)
    achieved = torch.where(stalled, 0.0, lsum(achieved_pp))
    remaining = carry.remaining - achieved
    newly = ~carry.done & (remaining <= 0)
    w = offered.clamp_min(_EPS)
    qdelay = sdiv(lsum(rtt * w) / lsum(w) - cfg.base_rtt_us, cfg.slot_us)
    completion = torch.where(
        newly, t + torch.ceil(qdelay).to(torch.int64), carry.completion)

    # post-warmup accumulation (adding the reference's 0.0 on uncounted
    # slots is the identity, so those slots skip the add)
    r = cfg.record_every
    n_rec, w0 = cfg.frames()
    counted = t % r == 0 and (t // r >= w0 or n_rec <= w0)
    goodput_sum = carry.goodput_sum + achieved if counted \
        else carry.goodput_sum

    new_carry = SimCarry(
        q_up=q_up, q_down=q_down, nic=nic, remaining=remaining,
        done=carry.done | newly, completion=completion,
        goodput_sum=goodput_sum, util_up=util)
    return new_carry, achieved.sum()


def _simulate(cfg: EngineConfig, ops: SlotOperands,
              carry0: Optional[SimCarry] = None):
    """Run every slot.  Nothing in the loop reads device values on the
    host, so the host only queues work.  Returns `(mean goodput,
    completion, per-slot totals, last util)` as device tensors."""
    carry = init_carry(ops.fb, cfg) if carry0 is None else carry0
    totals = ops.fb.demand.new_empty(cfg.slots)
    for t in range(cfg.slots):
        carry, totals[t] = _slot_step(cfg, ops, carry, t)
    n_rec, w0 = cfg.frames()
    frames = (n_rec - w0) if n_rec > w0 else n_rec
    return (sdiv(carry.goodput_sum, frames), carry.completion, totals,
            carry.util_up)


# ---------------------------------------------------------------------------
# host preparation and entry points
# ---------------------------------------------------------------------------

class AggPerms(NamedTuple):
    """Flow→bucket gather plans: flow indices padded with F (the index
    of an appended zero row), flow order kept within each bucket."""
    src: np.ndarray         # (H, Cs) flows by src host
    dst: np.ndarray         # (H, Cd) flows by dst host
    pair: np.ndarray        # (L*L, Cp) flows by (src_leaf, dst_leaf)
    # (n_seg, P, 2*L*S, Cu) flows by ECMP link: L*S up buckets
    # (src_leaf*S + spine), then S*L down buckets (spine*L + dst_leaf);
    # a (1, P, 1, 1) placeholder of F under AR/WAR
    ecmp_load: np.ndarray


def _prepared(compiled) -> Tuple[EngineConfig, FlowArrays, FaultTimeline]:
    spec = compiled.spec
    cfg = EngineConfig.from_sim(compiled.cfg, spec.topo)
    fa = FlowArrays.build(compiled.flows, compiled.topo)
    return cfg, fa, compile_fault_timeline(spec)


def _seg_id(boundaries, slots: int) -> np.ndarray:
    """(T,) index of the capacity segment governing each slot."""
    return (np.searchsorted(np.asarray(list(boundaries)),
                            np.arange(slots), side="right") - 1) \
        .astype(np.int32)


def _seg_caps(tl: FaultTimeline, boundaries
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compress a dense timeline to its boundary snapshots ((n_seg, ...)
    each); `_seg_id` re-expands them per slot."""
    b = list(boundaries)
    return tl.up[b], tl.down[b], tl.access[b]


def _assign_for(cfg: EngineConfig, fa: FlowArrays, tl: FaultTimeline,
                seed: int, boundaries) -> np.ndarray:
    """(n_seg, F, P) int32 ECMP spine per (flow, plane) and capacity
    segment; a (1, F, P) zero placeholder under AR/WAR."""
    if cfg.routing == "ecmp":
        return ecmp_assign_segments(
            fa.src_leaf, fa.dst_leaf, tl, seed, cfg.n_spines, boundaries,
            uplink_cap=cfg.uplink_cap)
    return np.zeros((1, len(fa), cfg.n_planes), np.int32)


def _agg_widths(cfg: EngineConfig, fa: FlowArrays,
                assign: np.ndarray) -> Tuple[int, int, int, int]:
    """Largest bucket of each aggregation axis (the plan widths): src
    host, dst host, leaf pair, and ECMP link over every (segment,
    plane) assignment (1 under AR/WAR)."""
    def w(keys, n):
        return max(1, int(np.bincount(keys, minlength=n).max()))
    H, L, S, P = cfg.n_hosts, cfg.n_leaves, cfg.n_spines, cfg.n_planes
    wu = 1
    if cfg.routing == "ecmp":
        for g in range(assign.shape[0]):
            for p in range(P):
                wu = max(wu,
                         w(fa.src_leaf * S + assign[g][:, p], L * S),
                         w(assign[g][:, p] * L + fa.dst_leaf, S * L))
    return (w(fa.src, H), w(fa.dst, H),
            w(fa.src_leaf * L + fa.dst_leaf, L * L), wu)


def _ecmp_load_plan(cfg: EngineConfig, fa: FlowArrays, assign: np.ndarray,
                    wu: int, pad: int) -> np.ndarray:
    """(n_seg, P, 2*L*S, wu) ECMP link-bucket plan (see `AggPerms`)."""
    P, L, S = cfg.n_planes, cfg.n_leaves, cfg.n_spines

    def plane(g, p):
        return np.concatenate([
            _perm_matrix(fa.src_leaf * S + assign[g][:, p], L * S, wu, pad),
            _perm_matrix(assign[g][:, p] * L + fa.dst_leaf, S * L, wu,
                         pad)])

    return np.stack([np.stack([plane(g, p) for p in range(P)])
                     for g in range(assign.shape[0])])


def _aggs_for(cfg: EngineConfig, fa: FlowArrays, assign: np.ndarray,
              widths: Tuple[int, int, int, int]) -> AggPerms:
    ws, wd, wp, wu = widths
    H, L, P, F = cfg.n_hosts, cfg.n_leaves, cfg.n_planes, len(fa)
    if cfg.routing == "ecmp":
        load = _ecmp_load_plan(cfg, fa, assign, wu, F)
    else:
        load = np.full((1, P, 1, 1), F, np.int32)
    return AggPerms(
        src=_perm_matrix(fa.src, H, ws, F),
        dst=_perm_matrix(fa.dst, H, wd, F),
        pair=_perm_matrix(fa.src_leaf * L + fa.dst_leaf, L * L, wp, F),
        ecmp_load=load)


def prepare(compiled, device=None, dtype=torch.float64
            ) -> Tuple[EngineConfig, FlowArrays, SlotOperands]:
    """Host prep of one `CompiledScenario`: the config, the flow arrays
    and the slot operands on `device`."""
    device = resolve_device(device)
    cfg, fa, tl = _prepared(compiled)
    boundaries = tuple(tl.change_slots())
    assign = _assign_for(cfg, fa, tl, compiled.cfg.seed, boundaries)
    up, down, acc = _seg_caps(tl, boundaries)
    ops = operands_from_numpy(
        cfg, fa, _aggs_for(cfg, fa, assign, _agg_widths(cfg, fa, assign)),
        up, down, acc, _seg_id(boundaries, cfg.slots), assign=assign,
        device=device, dtype=dtype)
    return cfg, fa, ops


def _wrap(cfg: EngineConfig, fa: FlowArrays, out,
          device: torch.device) -> EngineResult:
    mean_goodput, completion, totals, util = \
        (o.cpu().numpy() for o in out)
    return EngineResult(
        mean_goodput=mean_goodput,
        completion_slot=completion.astype(np.int64),
        total_goodput=totals[::cfg.record_every], util_up_last=util,
        groups=fa.groups, group_of=fa.group, slot_us=cfg.slot_us,
        device=str(device))


def run_compiled(compiled, device=None, dtype=None) -> EngineResult:
    """Simulate one `CompiledScenario`.  `device` defaults to CUDA (and
    raises without a GPU); `device="cpu"` runs the plain path.  `dtype`
    is float64 (parity mode, the default) or float32 (fast mode)."""
    cfg, fa, ops = prepare(compiled, device,
                           torch.float64 if dtype is None else dtype)
    return _wrap(cfg, fa, _simulate(cfg, ops), ops.fb.src.device)
