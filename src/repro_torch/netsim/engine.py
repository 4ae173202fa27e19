"""The slot engine: one fluid-network slot as a function of
`(SimCarry, t)`, run in a loop over slots.

One slot reproduces, operation for operation, the reference engine's
static-dispatch slot on a leaf-spine or a 3-tier fat-tree fabric under
AR, weighted AR or ECMP:

  PLB plane split -> routing (AR/WAR: path fractions from the queue
  carry; ECMP: the hashed path of each (flow, plane) from the
  assignment replay) -> per-link bottleneck scaling -> queue/ECN/RTT
  evolution -> NIC control update (`spx|dcqcn|global|esr|swlb`) ->
  loss-stall masking -> transfer completion.

The path axis is the spine on a leaf-spine and the core on a fat tree,
where a path composes stage A (leaf↔agg, the agg serving the core) with
stage B (pod↔core) for leaf pairs in different pods.  Under failure
reaction, AR/WAR score paths against the routing-visible (lagged)
capacities and deliver on the physical ones, ECMP's assignment replay
steers by the visible timeline, and every slot also reports the bytes
offered onto physically dead paths (the blackhole series).  With a
`TraceSpec` enabled the slot also emits the reference's trace signals
(`_trace_fields`), recorded at the slots `range(0, slots, every)`.

The per-slot hot spots go through the `repro_torch.kernels` wrappers
(hand-written CUDA on the GPU, the plain PyTorch versions on the CPU).
Faults arrive as a piecewise-constant capacity timeline (`events.py`)
compressed to per-segment snapshots, and ECMP's path assignment as one
table per segment; the slot→segment map stays on the host, so the loop
never waits for the device.

A slot takes one point or a batch of points of one structure (the
counterpart of the reference's `vmap`): every operand and carry field
then has a leading lane axis, the slot's code addresses axes from the
end, and its gathers read lane-stacked tensors through flat indices
that carry each lane's offset (`carry.stack_operands`).  Each lane adds
its own values in the same order as the point alone, so per-flow
outputs and the carry are bit-equal lane for lane; the per-slot totals
are one reduction per lane, whose tree the reduction kernel may pick by
shape.  `run_compiled_batch` runs points that differ only in seed,
faults and flows; `megabatch.py` groups a grid into such batches.

On CUDA the loop replays captured CUDA graphs (`graph.py`, the
counterpart of the reference's `_jitted`): one slot is a function of
device state only, with the slot `t` a device tensor.  The CPU runs the
eager Python loop, as does `_simulate(..., _eager=True)` on CUDA, which
exists to compare the two.

Every sum that feeds the queue integrators (flows into host, leaf-pair
and ECMP link buckets, pair rates times fractions into link loads) runs
left to right in flow order, as the NumPy engine's `np.add.at` does; the
short plane and spine sums run left to right too.  The CPU and GPU runs
therefore differ only where `exp` does.

Flows reach their buckets in one of the reference's two aggregation
modes (`EngineConfig.agg_mode`, picked by `agg_mode_default`): dense,
padded gather plans summed by `lsum` (and ECMP's links by
`bucket_load_bottleneck`), or sparse, flow-ordered segment sums over
CSR plans (`_sparse_plans`; one `segment_sum_many` launch a slot), the
giga-scale path, whose plans grow with the flows, not with
`L²·paths·planes`.  Both add a bucket's flows in flow order, so they
agree bit for bit.  Under sparse aggregation `EngineConfig.flow_chunk`
may stream the flows through the slot in chunks (`chunked.py`); the
slot is split into `_offered`, `_sums`, `_links` and `_flows` so that
both share every line.

Schedule workloads (training-step collectives, `repro_torch.comms`)
add a demand timeline: the slots where any of its lanes changes value
(`phase_boundaries`) join the capacity segments, each segment carries
every lane's multiplier (`_seg_dem`), and the slot scales each flow's
demand by its lane's value right after the start/done mask, as the
reference does.  Without a schedule (`EngineConfig.n_phases == 0`) the
multiply is not in the slot at all.
"""
from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass, replace
from functools import partial
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.jsq_route import pair_fractions
from repro_torch.kernels.link_load import SegmentPlan, bottleneck_many, \
    bucket_load_bottleneck, segment_sum_many
from repro_torch.kernels.plb_select import plane_split
from repro_torch.kernels.queue_ecn import nic_update, queue_update_many
from repro_torch.kernels.ref import lsum, sdiv

from repro_torch.scenarios.spec import reaction_lag
from repro_torch.trace import FLOW_AXIS_FIELDS, TraceSpec

from .carry import SlotOperands, SparsePlans, operands_from_numpy, \
    stack_operands
from .cc import (DCQCN_AI, DCQCN_ALPHA_G, MIN_RATE, PROBE_TIMEOUT, SPX_AI,
                 SPX_MD, SPX_RTT_GAIN, TARGET_RTT_US)
from .events import (FaultTimeline, compile_fault_timeline,
                     ecmp_assign_segments, lagged_timeline)
from .fabric import AR_TEMPERATURE, ECN_QUEUE_THRESH, JSQ_BINS, Q_CAP, \
    FlowArrays
from .graph import SlotLoop
from .sim import SimConfig
from .state import NicCarry, SimCarry, init_carry

_EPS = 1e-12
_SPLIT_MODE = {"spx": "spx", "dcqcn": "dcqcn", "global": "agg",
               "esr": "agg", "swlb": "swlb"}


def _env_flag(name: str) -> Optional[bool]:
    """The boolean environment variable `name` (1/true/t/yes/y/on,
    any case), or None when it is unset (the reference's
    `jx/engine.py::_env_flag`)."""
    env = os.environ.get(name)
    if env is None:
        return None
    return env.lower() in ("1", "true", "t", "yes", "y", "on")


def agg_mode_default(n_hosts: int, n_leaves: int, n_paths: int,
                     n_planes: int) -> str:
    """The flow-aggregation mode for a fabric shape, as the reference
    picks it (`repro/netsim/jx/engine.py::agg_mode_default`): dense
    gather plans at registry shapes, sparse (flow-ordered segment sums
    over CSR plans) once the dense ECMP plans' `2·L²·paths·planes` rows
    a segment, not the flows, would set the memory.
    `REPRO_JX_AGG=dense|sparse` overrides, in both packages."""
    env = os.environ.get("REPRO_JX_AGG")
    if env in ("dense", "sparse"):
        return env
    big = (n_hosts >= 4096 or
           n_leaves * n_leaves * n_paths * n_planes > (1 << 22))
    return "sparse" if big else "dense"


# live (flow, plane) arrays of a slot's per-flow working set in the
# chunk-length estimate: the 5 NIC carry fields and the offered,
# fabric-rate, throughput, queue, achieved, RTT and ECN intermediates
_FLOW_WORKING_ARRAYS = 12


def flow_chunk_default(n_flows: int, n_planes: int, agg_mode: str,
                       dtype: torch.dtype = torch.float64) -> int:
    """Flows a chunk when the slot streams its flow axis in chunks, or
    0 for one pass over every flow, as the reference picks it
    (`flow_chunk_default`), with the item size of the run's `dtype`.
    Chunks start once the per-flow working set
    (`_FLOW_WORKING_ARRAYS` (F, P) arrays) passes
    `REPRO_JX_FLOW_BUDGET_MB` (default 8192), and only under sparse
    aggregation; `REPRO_JX_FLOW_CHUNK=<n>` forces a chunk length (0: no
    chunks) whatever the mode (a caller that takes it makes the run
    sparse)."""
    env = os.environ.get("REPRO_JX_FLOW_CHUNK")
    if env is not None:
        return max(0, int(env))
    if agg_mode != "sparse" or n_flows <= 0:
        return 0
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_flow = max(1, n_planes) * itemsize * _FLOW_WORKING_ARRAYS
    budget = float(os.environ.get("REPRO_JX_FLOW_BUDGET_MB", 8192))
    if n_flows * per_flow <= budget * 2**20:
        return 0
    chunk = int(budget * 2**20 // per_flow)
    # a power of two, at least 1024
    chunk = max(1024, 1 << max(0, chunk.bit_length() - 1))
    return min(chunk, n_flows)


@dataclass(frozen=True)
class EngineConfig:
    """Static simulation parameters: sim knobs, fabric shape and the
    fluid-model constants.  `react` marks a run under failure reaction
    (routing steers by the visible view; each slot reports its
    blackholed bytes); `n_phases` > 0 marks a schedule run with that
    many demand-timeline lanes (the reference's `JxConfig.n_phases`).
    `agg_mode` is how flows are summed into buckets: "dense" (padded
    gather plans) or "sparse" (flow-ordered segment sums over CSR plans,
    the giga-scale path); `flow_chunk` > 0 (sparse only) streams the
    flow axis through the slot in chunks of that many flows
    (`chunked.py`), bit-identical to one pass."""
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
    kind: str = "leaf_spine"
    n_pods: int = 1
    n_aggs: int = 1
    n_cores: int = 1
    core_cap: float = 1.0
    target_rtt_us: float = TARGET_RTT_US
    probe_timeout: int = PROBE_TIMEOUT
    ecn_queue_thresh: float = ECN_QUEUE_THRESH
    ar_temperature: float = AR_TEMPERATURE
    jsq_bins: int = JSQ_BINS
    q_cap: float = Q_CAP
    agg_mode: str = "dense"
    flow_chunk: int = 0
    n_phases: int = 0
    react: bool = False

    @property
    def n_paths(self) -> int:
        """Routing choices per (leaf pair, plane): spines on leaf_spine,
        cores on fat_tree."""
        return self.n_spines if self.kind == "leaf_spine" else self.n_cores

    @property
    def n_up(self) -> int:
        """Stage-A links per leaf: spines, or the pod's aggs."""
        return self.n_spines if self.kind == "leaf_spine" else self.n_aggs

    @property
    def cores_per_agg(self) -> int:
        return self.n_cores // self.n_aggs

    @property
    def leaves_per_pod(self) -> int:
        return self.n_leaves // self.n_pods

    @classmethod
    def from_sim(cls, cfg: SimConfig, topo) -> "EngineConfig":
        """`topo` is a `TopologySpec` (or anything with its shape
        attributes).  The aggregation mode is the fabric's
        (`agg_mode_default`).  Raises `ValueError` on an unknown
        routing."""
        fat = getattr(topo, "kind", "leaf_spine") == "fat_tree"
        if cfg.routing not in ("ar", "war", "ecmp"):
            raise ValueError(f"unknown routing {cfg.routing!r}")
        return cls(
            slots=cfg.slots, slot_us=cfg.slot_us, routing=cfg.routing,
            nic=cfg.nic, base_rtt_us=cfg.base_rtt_us,
            warmup_frac=cfg.warmup_frac, record_every=cfg.record_every,
            sw_lb_delay_slots=cfg.sw_lb_delay_slots(),
            n_planes=topo.n_planes, n_leaves=topo.n_leaves,
            n_spines=topo.n_spines, n_hosts=topo.n_hosts,
            uplink_cap=topo.link_cap * topo.parallel_links,
            access_cap=topo.access_cap,
            kind="fat_tree" if fat else "leaf_spine",
            n_pods=topo.n_pods if fat else 1,
            n_aggs=topo.n_aggs if fat else 1,
            n_cores=topo.n_cores if fat else 1,
            core_cap=topo.core_cap if fat else 1.0,
            agg_mode=agg_mode_default(
                topo.n_hosts, topo.n_leaves,
                topo.n_cores if fat else topo.n_spines, topo.n_planes))

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
    util_up_last: np.ndarray     # (P, L, S|A)
    groups: List[str]
    group_of: np.ndarray
    slot_us: float
    device: str
    # failure reaction only: (T,) bytes offered onto physically dead
    # paths each slot (None without a reaction)
    blackhole_timeline: Optional[np.ndarray] = None
    # with a trace enabled: `slot` (the recorded slots) and each active
    # field of `trace.TRACE_FIELDS`, (T_rec, ...) each (None without)
    trace: Optional[Dict[str, np.ndarray]] = None


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
    """The (..., F, P) offered split: a batch's lanes go to the kernel
    as one (B·F, P) flow axis (views; a point's tensors as they are)."""
    P = nic.rate.shape[-1]
    return plane_split(nic.rate.reshape(-1, P),
                       nic.eligible.reshape(-1, P), demand.reshape(-1),
                       mode=_SPLIT_MODE[cfg.nic],
                       min_rate=MIN_RATE).view(nic.rate.shape)


def _probe_common(cfg: EngineConfig, nic: NicCarry, probe_ok):
    # saturate at the timeout: `dead` is unchanged (>= comparison)
    bump = torch.clamp_max(nic.probe_miss + 1, cfg.probe_timeout)
    probe_miss = torch.where(probe_ok, 0, bump)
    return probe_miss, probe_miss >= cfg.probe_timeout


def _probe_basic(cfg, nic: NicCarry, rate, probe_ok, slot) -> NicCarry:
    probe_miss, dead = _probe_common(cfg, nic, probe_ok)
    eligible = ~dead
    just_back = eligible & ~nic.eligible
    rate = torch.where(just_back, 0.5, rate)
    rate = torch.where(eligible, rate, MIN_RATE)
    return NicCarry(rate=rate, alpha=nic.alpha, probe_miss=probe_miss,
                    eligible=eligible, pending_fail=nic.pending_fail)


def _probe_swlb(cfg, nic: NicCarry, rate, probe_ok, slot) -> NicCarry:
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
    kernel (a batch's lanes as one (B·F, P) flow axis).  Returns
    `(rtt, ecn, rate, alpha)`."""
    P = qmean.shape[-1]
    outs = nic_update(
        qmean.reshape(-1, P), nic.rate.reshape(-1, P),
        nic.alpha.reshape(-1, P), esr.reshape(-1, 1), mode=mode,
        base_rtt_us=cfg.base_rtt_us, slot_us=cfg.slot_us,
        ecn_thresh=cfg.ecn_queue_thresh, target_rtt_us=cfg.target_rtt_us,
        min_rate=MIN_RATE, md=SPX_MD, ai=SPX_AI, rtt_gain=SPX_RTT_GAIN,
        dcqcn_ai=DCQCN_AI, alpha_g=DCQCN_ALPHA_G)
    return tuple(o.view(qmean.shape) for o in outs)


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


def _nic_update(cfg: EngineConfig, nic: NicCarry, qmean, probe_ok, slot,
                esr) -> Tuple[NicCarry, torch.Tensor, torch.Tensor]:
    """NIC control update (pre-stall rates).  Returns the new NIC state
    plus rtt/ecn.  `slot` is a Python int or a 0-d device tensor."""
    return _NIC_UPDATE[cfg.nic](cfg, nic, qmean, probe_ok, slot, esr)


# ---------------------------------------------------------------------------
# routing fractions and link loads
# ---------------------------------------------------------------------------

def _pair_fractions(cfg: EngineConfig, q, cap, eff, use_war: bool):
    """(..., P, L_src, L_dst, J) path split; WAR folds in remote
    weights: `eff` (..., P, J, L), each path's healthy capacity toward
    the dst leaf, over its best path's."""
    w = cap
    if use_war:
        rw = eff / eff.amax(-2, keepdim=True).clamp_min(1e-9)
        w = (w * rw.transpose(-1, -2).unsqueeze(-3)).contiguous()
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


def _masked_perm_matrix(keys: np.ndarray, mask: np.ndarray,
                        n_buckets: int, width: int,
                        pad: int) -> np.ndarray:
    """`_perm_matrix` over only the flows where `mask`: the fat tree's
    stage-B plans leave out intra-pod flows, which never touch a core
    link (the reference's other paths add an exact 0.0 for them, so
    leaving them out is bit-equivalent).  Flow order is kept within
    buckets."""
    perm = np.full((n_buckets, width), pad, np.int32)
    idx = np.flatnonzero(mask)
    sub = np.asarray(keys)[idx]
    order = np.argsort(sub, kind="stable")
    sk = sub[order]
    counts = np.bincount(sk, minlength=n_buckets)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.arange(len(sk)) - starts[sk]
    perm[sk, ranks] = idx[order]
    return perm


def _seg_sum(vals: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """vals (..., F, P), perm (..., K, C) -> (..., K, P) bucket sums,
    each bucket's flows added left to right in flow order (pad entries
    add exact 0.0).  A lane-stacked `perm` indexes the lanes' rows
    stacked as one (B·(F+1), P) table (each lane's pad reads its own
    zero row)."""
    P = vals.shape[-1]
    pad = torch.cat([vals, vals.new_zeros(vals.shape[:-2] + (1, P))], -2)
    return lsum(pad.reshape(-1, P)[perm].transpose(-1, -2))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The (..., F, P) rows of (..., N, P) `x` at the flat indices `idx`
    (..., F) into its lanes' rows stacked as one (B·N, P) table."""
    return x.reshape(-1, x.shape[-1])[idx]


def _lane_total(x: torch.Tensor, nd: int) -> torch.Tensor:
    """Sum of the trailing `nd` axes: a 0-d tensor for a point, one
    reduction per lane for a batch."""
    return x.sum() if x.dim() == nd else x.flatten(-nd).sum(-1)


def _pair_rate_sum(cfg: EngineConfig, fabric_rate: torch.Tensor,
                   perm: torch.Tensor) -> torch.Tensor:
    """(..., P, L, L) offered rate summed by (src-leaf, dst-leaf)
    pair."""
    P, L = cfg.n_planes, cfg.n_leaves
    return _seg_sum(fabric_rate, perm).transpose(-1, -2).reshape(
        fabric_rate.shape[:-2] + (P, L, L))


def _chunk_plan(plan: SegmentPlan, chunk: int, n_chunks: int
                ) -> SegmentPlan:
    """Chunk `chunk` of `n_chunks`' buckets of a chunk-major plan (its
    offsets stay positions in the whole `entries`)."""
    if n_chunks == 1:
        return plan
    K = (plan.offsets.shape[-1] - 1) // n_chunks
    return plan._replace(offsets=plan.offsets[chunk * K:(chunk + 1) * K + 1])


def _sparse_sums(cfg: EngineConfig, ops: SlotOperands, offered, fabric_rate,
                 seg: int, chunk: int = 0, acc=None) -> Tuple:
    """The slot's flow sums under sparse aggregation, one segment-sum
    launch: `offered` by (src host, plane) and by (dst host, plane), and
    `fabric_rate` by (plane, leaf pair) under AR/WAR or by ECMP link
    (this segment's plan) — of chunk `chunk` of the flows (`offered`
    and `fabric_rate` that chunk's), added to the sums `acc` of the
    chunks before it when given.  Returns `(sums, scales)`, flat, a
    lane's buckets after another's (`_shape_sums` views them): the
    launch of the last chunk (the only one without chunks) also scales
    the access sums by the access capacities and, under ECMP, the link
    sums by the link capacities (the kernel's bottleneck epilogue;
    `scales` is None before the last chunk, and its third entry None
    under AR/WAR)."""
    sp = ops.sparse
    nc = ops.fb.demand.shape[-1] // sp.chunk
    third = sp.pair if sp.link is None else sp.link._replace(
        offsets=sp.link.offsets[seg], entries=sp.link.entries[seg])
    items = ((offered, _chunk_plan(sp.src, chunk, nc)),
             (offered, _chunk_plan(sp.dst, chunk, nc)),
             (fabric_rate, _chunk_plan(third, chunk, nc)))
    if chunk != nc - 1:
        return segment_sum_many(items, acc=acc), None
    acc_cap = ops.acc[seg].reshape(-1)
    link_cap = None if sp.link is None else \
        ops.sparse_link_cap[seg].reshape(-1)
    return segment_sum_many(items, acc=acc,
                            caps=(acc_cap, acc_cap, link_cap), eps=_EPS)


def _shape_sums(cfg: EngineConfig, lead: tuple, sums, scales) -> Tuple:
    """`_sparse_sums`' flat sums and scales as the slot's: the two
    access loads (..., H, P), then the pair rates (..., P, L, L) or the
    ECMP link loads, family after family, (..., rows); the scales
    alike (the access scales, then the ECMP link scales or None)."""
    H, P, L = cfg.n_hosts, cfg.n_planes, cfg.n_leaves
    shape = (P, L, L) if cfg.routing != "ecmp" else (-1,)
    shapes = (lead + (H, P), lead + (H, P), lead + shape)
    return tuple(None if x is None else x.view(sh)
                 for xs in (sums, scales) for x, sh in zip(xs, shapes))


def _sums(cfg: EngineConfig, ops: SlotOperands, offered, fabric_rate,
          seg: int) -> Tuple:
    """The slot's flow sums, each bucket's flows added in flow order:
    the access loads by src and by dst host ((..., H, P) each), then the
    pair rates ((..., P, L, L), AR/WAR) or, under sparse aggregation,
    the ECMP link loads; dense ECMP sums its links in
    `bucket_load_bottleneck` (None here).  Under sparse aggregation
    three scales follow (`_shape_sums`): the access scales and, under
    ECMP, the link scales, from the same launch."""
    if cfg.agg_mode == "sparse":
        return _shape_sums(cfg, tuple(offered.shape[:-2]), *_sparse_sums(
            cfg, ops, offered, fabric_rate, seg))
    pair = None if cfg.routing == "ecmp" else \
        _pair_rate_sum(cfg, fabric_rate, ops.agg_pair)
    return (_seg_sum(offered, ops.agg_src), _seg_sum(offered, ops.agg_dst),
            pair)


def _pair(up_l, down_l, cross=None, up_b=None, down_b=None):
    """(..., P, L_src, L_dst, J) pair view of per-path link values: the
    minimum of the src leaf's up value and the dst leaf's down value
    (`up_l`, `down_l`: (..., P, L, J) each), composed by `min` with the
    stage-B values (`up_b`, `down_b`, (..., P, L, J) by leaf) where
    `cross` ((L, L, 1) bool) marks a fat tree's cross-pod pairs."""
    a = torch.minimum(up_l.unsqueeze(-2), down_l.unsqueeze(-3))
    if cross is None:
        return a
    b = torch.minimum(up_b.unsqueeze(-2), down_b.unsqueeze(-3))
    return torch.where(cross, torch.minimum(a, b), a)


class _FatTreeView(NamedTuple):
    """Per-path (..., P, L, J) operands of a fat tree (a slot's caps or
    scales by leaf and core): stage A through the core's agg, stage B
    through the leaf's pod."""
    up: torch.Tensor           # src leaf -> agg of core j
    down: torch.Tensor         # agg of core j -> dst leaf, as (P, L, J)
    up2: torch.Tensor          # pod of the src leaf -> core j
    down2: torch.Tensor        # core j -> pod of the dst leaf


def _ft_view(ops: SlotOperands, up, down, up2, down2) -> _FatTreeView:
    aj, pol = ops.path_agg, ops.leaf_pod
    return _FatTreeView(up.index_select(-1, aj),
                        down.index_select(-2, aj).transpose(-1, -2),
                        up2.index_select(-2, pol),
                        down2.index_select(-2, pol))


def _ft_pair(ops: SlotOperands, v: _FatTreeView):
    return _pair(v.up, v.down, ops.cross_pair[:, :, None], v.up2, v.down2)


def _route_pair(cfg: EngineConfig, carry: SimCarry, rate_pair, up, down,
                upv, downv, use_war: bool):
    """AR / weighted-AR on a leaf-spine, up to the link loads: leaf-pair
    spine fractions (scored on the visible capacities `upv`/`downv`),
    the pair queues they were scored on, the up and down link loads of
    the pair rates `rate_pair` and, under failure reaction, the rate
    steered onto physically dead paths.  `_pair_tables` finishes the
    routing once the loads are scaled."""
    # kernel operands are contiguous whatever layout broadcasting picks
    cap = _pair(upv, downv.transpose(-1, -2)).contiguous()
    q = _pair_sum(carry.q_up, carry.q_down.transpose(-1, -2))
    pair = _pair_fractions(cfg, q, cap, downv, use_war)
    contrib = rate_pair[..., None] * pair               # (..., P, L, L, S)
    # einsum("plm,plms->pls") / ("plm,plms->psm") as ordered sums
    load_up = lsum(contrib.transpose(-1, -2))           # (..., P, L, S)
    load_down = lsum(contrib.transpose(-3, -1))         # (..., P, S, L)
    bh = None
    if cfg.react:
        bh = _blackholed(contrib, _pair(up, down.transpose(-1, -2)))
    return pair, q, (load_up, load_down), bh


def _route_pair_ft(cfg: EngineConfig, carry: SimCarry, rate_pair,
                   phys: _FatTreeView, vis: _FatTreeView,
                   ops: SlotOperands, use_war: bool):
    """Fat-tree AR / weighted-AR, up to the link loads: the pair split
    runs over the core axis, scored on the visible capacities and the
    pair queues (stage A through each core's agg, plus stage B for
    cross-pod pairs); the stage-A loads sum a leaf's cores by agg, the
    stage-B loads a pod's leaves by core (cross-pod rate only)."""
    P, L, A = cfg.n_planes, cfg.n_leaves, cfg.n_aggs
    J, cpa = cfg.n_paths, cfg.cores_per_agg
    pods, lpp = cfg.n_pods, cfg.leaves_per_pod
    lead = rate_pair.shape[:-3]
    cross = ops.cross_pair[:, :, None]
    cap = _ft_pair(ops, vis).contiguous()
    aj, pol = ops.path_agg, ops.leaf_pod
    qA = _pair_sum(carry.q_up.index_select(-1, aj),
                   carry.q_down.index_select(-2, aj).transpose(-1, -2))
    qB = _pair_sum(carry.q2_up.index_select(-2, pol),
                   carry.q2_down.index_select(-2, pol))
    q = (qA + torch.where(cross, qB, 0.0)).contiguous()
    # remote weights from each core's healthy capacity toward the dst
    # leaf, both stages
    eff = torch.minimum(vis.down, vis.down2).transpose(-1, -2)  # (P, J, L)
    pair = _pair_fractions(cfg, q, cap, eff, use_war)
    contrib = rate_pair[..., None] * pair               # (..., P, L, L, J)
    # einsum("plm,plmj->plj") / ("plm,plmj->pmj") as ordered sums, then
    # the cores of an agg (stage A) and the leaves of a pod (stage B)
    load_up = lsum(lsum(contrib.transpose(-1, -2))
                   .reshape(lead + (P, L, A, cpa)))
    load_down = lsum(lsum(contrib.movedim(-3, -1))
                     .reshape(lead + (P, L, A, cpa))) \
        .transpose(-1, -2).contiguous()
    contribx = (rate_pair * ops.cross_pair)[..., None] * pair
    loadB_up = lsum(lsum(contribx.transpose(-1, -2))
                    .reshape(lead + (P, pods, lpp, J)).transpose(-1, -2))
    loadB_down = lsum(lsum(contribx.movedim(-3, -1))
                      .reshape(lead + (P, pods, lpp, J)).transpose(-1, -2))
    bh = _blackholed(contrib, _ft_pair(ops, phys)) if cfg.react else None
    return pair, q, (load_up, load_down, loadB_up, loadB_down), bh


def _pair_sum(up_l, down_l):
    """(..., P, L_src, L_dst, J) sum of the src leaf's up and the dst
    leaf's down value of each path ((..., P, L, J) each), contiguous."""
    return (up_l.unsqueeze(-2) + down_l.unsqueeze(-3)).contiguous()


def _blackholed(contrib, cap) -> torch.Tensor:
    """Rate the pair split steered onto paths whose physical capacity
    `cap` is dead, summed per lane (no per-flow path tensor)."""
    return _lane_total(contrib * (cap <= _EPS), 4)


def _pair_tables(cfg: EngineConfig, pair, q, scale_pair):
    """AR / weighted-AR, from the (..., P, L, L, J) path scales: each
    leaf pair's fabric scale and mean path queue as rows of (B·L·L, P)
    tables, which each flow reads at its leaf pair (`pair_idx`)."""
    lead = pair.shape[:-4]
    P, LL = cfg.n_planes, cfg.n_leaves * cfg.n_leaves
    path_scale = lsum(pair * scale_pair).reshape(lead + (P, LL))
    q_tab = lsum(pair * q).reshape(lead + (P, LL))
    return (path_scale.transpose(-1, -2).reshape(-1, P),
            q_tab.transpose(-1, -2).reshape(-1, P))


def _ecmp_link_families(cfg: EngineConfig, x) -> Tuple:
    """Views of (..., rows) ECMP link values, family after family:
    stage-A up (..., P, L, U) and down (..., P, U, L), and on a fat
    tree stage-B up and down (..., P, pods, C)."""
    P, L, U = cfg.n_planes, cfg.n_leaves, cfg.n_up
    lead = x.shape[:-1]
    LU = P * L * U
    out = (x[..., :LU].view(lead + (P, L, U)),
           x[..., LU:2 * LU].view(lead + (P, U, L)))
    if cfg.kind == "fat_tree":
        B = P * cfg.n_pods * cfg.n_cores
        shape = lead + (P, cfg.n_pods, cfg.n_cores)
        out += (x[..., 2 * LU:2 * LU + B].view(shape),
                x[..., 2 * LU + B:].view(shape))
    return out


class _Links(NamedTuple):
    """A slot's link-level state, from its flows' summed rates: what
    each flow reads back (`tables`: under AR/WAR the leaf pairs' path
    scale and queue tables, under ECMP the link scales of stage A's up
    and down links and, on a fat tree, stage B's), the access scales,
    the updated queues and stage A's up-link utilization, and under
    AR/WAR with failure reaction the blackholed rate."""
    tables: Tuple
    f_acc_tx: torch.Tensor
    f_acc_rx: torch.Tensor
    q_up: torch.Tensor
    q_down: torch.Tensor
    util: torch.Tensor
    q2_up: Optional[torch.Tensor]
    q2_down: Optional[torch.Tensor]
    bh: Optional[torch.Tensor]


def _links(cfg: EngineConfig, ops: SlotOperands, carry: SimCarry, seg: int,
           sums, fabric_rate=None) -> _Links:
    """The link half of a slot in capacity segment `seg`: routing, link
    loads and their bottleneck scales (every scale of the slot in one
    bottleneck launch: the access links', and the fabric links' unless
    dense ECMP's bucket_load_bottleneck gives them; under sparse
    aggregation the segment sum's epilogue gave the access scales and,
    under ECMP, the link scales, so ECMP makes no bottleneck launch and
    AR/WAR scale only the fabric links), then every queue in one
    queue_update launch.  `sums` is `_sums`' (dense ECMP also needs the
    flows' `fabric_rate`); reads only the old carry's queues."""
    fat = cfg.kind == "fat_tree"
    up, down, acc = ops.up[seg], ops.down[seg], ops.acc[seg]
    up2, down2 = (ops.up2[seg], ops.down2[seg]) if fat else (None, None)
    tx, rx, third, *scaled = sums
    # sparse: the sums' launch scaled the access links (and under ECMP
    # the fabric links); else the bottleneck launch scales them
    access = () if scaled else ((acc, tx), (acc, rx))
    acc_scales = tuple(scaled[:2])
    links = (up, down) + ((up2, down2) if fat else ())
    bh = None
    if cfg.routing == "ecmp" and cfg.agg_mode == "dense":
        # one launch sums the flows of every link bucket in flow order
        # and scales them (a batch's lanes in the same launch)
        loads, fracs = bucket_load_bottleneck(
            fabric_rate, ops.ecmp_load[seg], ops.link_cap[seg], eps=_EPS)
        # the plan's rows, by plane: stage A's up and down links, then
        # on a fat tree stage B's
        LU = cfg.n_leaves * cfg.n_up
        o = [0, LU, 2 * LU] + ([2 * LU + cfg.n_pods * cfg.n_cores,
                                fracs.shape[-1]] if fat else [])
        spans = list(zip(o[:-1], o[1:]))
        tables = tuple(fracs[..., a:b] for a, b in spans)
        loads = tuple(loads[..., a:b].reshape(x.shape).contiguous()
                      for (a, b), x in zip(spans, links))
        f_acc_tx, f_acc_rx = bottleneck_many(access, eps=_EPS)
    elif cfg.routing == "ecmp":
        f_acc_tx, f_acc_rx, link_scale = scaled
        loads = tuple(x.contiguous()
                      for x in _ecmp_link_families(cfg, third))
        tables = _ecmp_link_families(cfg, link_scale)
    else:
        use_war = cfg.routing == "war"
        if fat:
            phys = _ft_view(ops, up, down, up2, down2)
            vis = _ft_view(ops, ops.vup[seg], ops.vdown[seg],
                           ops.vup2[seg], ops.vdown2[seg])
            pair, q, loads, bh = _route_pair_ft(
                cfg, carry, third, phys, vis, ops, use_war)
        else:
            pair, q, loads, bh = _route_pair(
                cfg, carry, third, up, down, ops.vup[seg], ops.vdown[seg],
                use_war)
        *scales, f_acc_tx, f_acc_rx = bottleneck_many(
            tuple(zip(links, loads)) + access, eps=_EPS) + acc_scales
        if fat:
            scale_pair = _ft_pair(ops, _ft_view(ops, *scales))
        else:
            scale_pair = _pair(scales[0], scales[1].transpose(-1, -2))
        tables = _pair_tables(cfg, pair, q, scale_pair)
    # every link queue in one queue_update launch (stage A's up and
    # down links, and on a fat tree stage B's); only stage A's up links'
    # utilization is kept
    queues = (carry.q_up, carry.q_down) + \
        ((carry.q2_up, carry.q2_down) if fat else ())
    (q_up, util), (q_down, _), *stage_b = queue_update_many(
        tuple(zip(queues, loads, links)), q_cap=cfg.q_cap, eps=_EPS)
    q2_up, q2_down = (q for q, _ in stage_b) if fat else (None, None)
    return _Links(tuple(tables), f_acc_tx, f_acc_rx, q_up, q_down, util,
                  q2_up, q2_down, bh)


def _ecmp_flows(cfg: EngineConfig, ops: SlotOperands, carry: SimCarry,
                fabric_rate, seg: int, scales):
    """ECMP, per (flow, plane) of `ops`' flows: the fabric throughput
    on this segment's assigned path (the least of its links' scales;
    stage B's too for a fat tree's cross-pod flows), the path's mean
    queue from the old carry and, under failure reaction, the rate on a
    physically dead path.  Flows read every link value through flat
    indices into the (..., P, ...) link tensors."""
    up_idx, down_idx = ops.ecmp_up[seg], ops.ecmp_down[seg]   # (.., F, P)
    scale_f = torch.minimum(torch.take(scales[0], up_idx),
                            torch.take(scales[1], down_idx))
    qmean = torch.take(carry.q_up, up_idx) + \
        torch.take(carry.q_down, down_idx)
    cap_f = None
    if cfg.react:
        cap_f = torch.minimum(torch.take(ops.up[seg], up_idx),
                              torch.take(ops.down[seg], down_idx))
    if cfg.kind == "fat_tree":
        up2_idx, down2_idx = ops.ecmp_up2[seg], ops.ecmp_down2[seg]
        scale_b = torch.minimum(torch.take(scales[2], up2_idx),
                                torch.take(scales[3], down2_idx))
        scale_f = torch.where(ops.cross, torch.minimum(scale_f, scale_b),
                              scale_f)
        qmean = qmean + torch.where(
            ops.cross, torch.take(carry.q2_up, up2_idx)
            + torch.take(carry.q2_down, down2_idx), 0.0)
        if cfg.react:
            cap_b = torch.minimum(torch.take(ops.up2[seg], up2_idx),
                                  torch.take(ops.down2[seg], down2_idx))
            cap_f = torch.where(ops.cross, torch.minimum(cap_f, cap_b),
                                cap_f)
    bh = None if cap_f is None else fabric_rate * (cap_f <= _EPS)
    return fabric_rate * scale_f, qmean, bh


# ---------------------------------------------------------------------------
# one slot
# ---------------------------------------------------------------------------

def _counted(cfg: EngineConfig, t: int) -> bool:
    """Whether slot `t` adds to the post-warmup goodput sum."""
    r = cfg.record_every
    n_rec, w0 = cfg.frames()
    return t % r == 0 and (t // r >= w0 or n_rec <= w0)


def _slot_step(cfg: EngineConfig, ops: SlotOperands, carry: SimCarry,
               t: int, trace: Optional[TraceSpec] = None):
    """Slot `t`: returns the next carry and this slot's total goodput
    (a 0-d tensor on the device, one per lane for a batch), under
    failure reaction its blackholed total too, and with `trace` enabled
    its trace fields."""
    return _slot(cfg, ops, carry, t, int(ops.seg_id[t]), _counted(cfg, t),
                 trace)


def _traced(trace: Optional[TraceSpec]) -> Tuple[str, ...]:
    """The fields a run records: none without an enabled trace."""
    return trace.active_fields() if trace is not None and trace.enabled \
        else ()


def _offered(cfg: EngineConfig, ops: SlotOperands, carry: SimCarry, t,
             seg: int):
    """`(offered, fabric_rate)` (..., F, P) of the flows of `ops` and
    `carry` (a run's, or one chunk's): each flow's demand, zero before
    its start and once done (a schedule run's scaled by its lane's
    multiplier), split over the planes; the fabric rate is zero for a
    flow within one leaf."""
    fb = ops.fb
    demand = torch.where(carry.done | (t < fb.start_slot), 0.0, fb.demand)
    if cfg.n_phases:
        # schedule workloads: the segment's multiplier of each flow's
        # demand-timeline lane (lane 0 is the always-1.0 lane)
        demand = demand * ops.dem[seg].gather(-1, fb.phase)
    offered = _plane_split(cfg, carry.nic, demand)        # (..., F, P)
    return offered, torch.where(fb.same_leaf[..., None], 0.0, offered)


class _Flows(NamedTuple):
    """The per-flow half of a slot for some flows: their next carry
    fields, achieved goodput, and what a trace or the blackhole series
    reads (`bh`: ECMP's rate on dead paths, (..., F, P); None
    otherwise)."""
    nic: NicCarry
    remaining: torch.Tensor
    done: torch.Tensor
    completion: torch.Tensor
    goodput_sum: torch.Tensor
    achieved: torch.Tensor
    achieved_pp: torch.Tensor
    stalled: torch.Tensor
    ecn: torch.Tensor
    bh: Optional[torch.Tensor]


def _flows(cfg: EngineConfig, ops: SlotOperands, carry: SimCarry, t,
           seg: int, counted, offered, fabric_rate,
           links: _Links) -> _Flows:
    """The per-flow half of a slot for the flows of `ops` and `carry` (a
    run's, or one chunk's; `carry`'s queues are the old ones): fabric
    throughput and path queue, access scaling, the NIC update, loss
    stalls, completion and the post-warmup goodput sum.  Every step is
    per flow, so a chunk's flows get what they get in one pass."""
    fb = ops.fb
    acc = ops.acc[seg]
    if cfg.routing == "ecmp":
        through, qmean, bh = _ecmp_flows(cfg, ops, carry, fabric_rate, seg,
                                         links.tables)
    else:
        scale, q_tab = links.tables
        through = fabric_rate * scale[ops.pair_idx]
        qmean, bh = q_tab[ops.pair_idx], None
    # access liveness doubles as the RTT probe result: a plane is
    # reachable iff both endpoints' access links on it are up
    alive = (_rows(acc, fb.src) > _EPS) & (_rows(acc, fb.dst) > _EPS)
    same_leaf = fb.same_leaf[..., None]
    local = torch.where(same_leaf, offered, 0.0)
    acc_scale = torch.minimum(_rows(links.f_acc_tx, fb.src),
                              _rows(links.f_acc_rx, fb.dst))
    achieved_pp = torch.where(alive, (through + local) * acc_scale, 0.0)
    qmean = torch.where(same_leaf, 0.0, qmean).contiguous()

    nic, rtt, ecn = _nic_update(cfg, carry.nic, qmean, alive, t, ops.esr)

    # packet-loss stall + completion
    stalled = ((offered > 1e-9) & (achieved_pp <= 1e-9)).any(-1)
    achieved = torch.where(stalled, 0.0, lsum(achieved_pp))
    remaining = carry.remaining - achieved
    newly = ~carry.done & (remaining <= 0)
    w = offered.clamp_min(_EPS)
    qdelay = sdiv(lsum(rtt * w) / lsum(w) - cfg.base_rtt_us, cfg.slot_us)
    completion = torch.where(
        newly, t + torch.ceil(qdelay).to(torch.int64), carry.completion)

    # post-warmup accumulation: the reference adds 0.0 on uncounted
    # slots, the identity on this non-negative sum, so the eager loop
    # skips the add there
    if isinstance(counted, torch.Tensor):
        goodput_sum = carry.goodput_sum + torch.where(counted, achieved,
                                                      0.0)
    elif counted:
        goodput_sum = carry.goodput_sum + achieved
    else:
        goodput_sum = carry.goodput_sum
    return _Flows(nic, remaining, carry.done | newly, completion,
                  goodput_sum, achieved, achieved_pp, stalled, ecn, bh)


def _next_carry(links: _Links, fl: _Flows) -> SimCarry:
    return SimCarry(
        q_up=links.q_up, q_down=links.q_down, nic=fl.nic,
        remaining=fl.remaining, done=fl.done, completion=fl.completion,
        goodput_sum=fl.goodput_sum, util_up=links.util, q2_up=links.q2_up,
        q2_down=links.q2_down)


def _slot(cfg: EngineConfig, ops: SlotOperands, carry: SimCarry, t,
          seg: int, counted, trace: Optional[TraceSpec] = None):
    """One slot in capacity segment `seg`.  `t` and `counted` are host
    values (the eager loop: a Python int and bool) or device tensors
    (`SlotLoop`: the 0-d slot and a (1,) bool), which enter the slot's
    arithmetic the same way.  Returns `(next carry, total)`, then under
    failure reaction the blackholed total, then with `trace` enabled its
    active fields in `TRACE_FIELDS` order (`_trace_fields`).  With
    `cfg.flow_chunk` the flows go through in chunks (`chunked.slot`)."""
    if cfg.flow_chunk:
        from . import chunked
        return chunked.slot(cfg, ops, carry, t, seg, counted)
    offered, fabric_rate = _offered(cfg, ops, carry, t, seg)
    links = _links(cfg, ops, carry, seg,
                   _sums(cfg, ops, offered, fabric_rate, seg), fabric_rate)
    fl = _flows(cfg, ops, carry, t, seg, counted, offered, fabric_rate,
                links)
    outs = (_lane_total(fl.achieved, 1),)
    if cfg.react:
        outs += (links.bh if fl.bh is None else _lane_total(fl.bh, 2),)
    fields = _traced(trace)
    if fields:
        outs += _trace_fields(fields, cfg, ops, fl, links)
    return (_next_carry(links, fl),) + outs


def _trace_fields(fields: Sequence[str], cfg: EngineConfig,
                  ops: SlotOperands, fl: _Flows, links: _Links) -> Tuple:
    """The reference's per-slot trace signals, only those in `fields`:
    `host_bw` the delivered (stall-masked) goodput summed by source host
    in flow order, `util` and `queue` the stage-A uplinks' utilization
    and queue after the update, `ecn` the NIC update's marks and
    `eligible` the new plane eligibility."""
    def host_bw():
        bw = torch.where(fl.stalled[..., None], 0.0, fl.achieved_pp)
        if cfg.agg_mode == "dense":
            return _seg_sum(bw, ops.agg_src)
        (out,) = segment_sum_many(((bw, ops.sparse.src),))
        return out.view(bw.shape[:-2] + (cfg.n_hosts, cfg.n_planes))

    sig = {
        "host_bw": host_bw,
        "util": lambda: links.util,
        "queue": lambda: links.q_up,
        "ecn": lambda: fl.ecn,
        "eligible": lambda: fl.nic.eligible,
    }
    return tuple(sig[f]() for f in fields)


def _trace_like(cfg: EngineConfig, ops: SlotOperands,
                fields: Sequence[str]) -> List[Tuple[tuple, torch.dtype]]:
    """(shape, dtype) of one slot's value of each trace field."""
    fb = ops.fb
    lead, F = tuple(fb.demand.shape[:-1]), fb.demand.shape[-1]
    P, L, U = cfg.n_planes, cfg.n_leaves, cfg.n_up
    fl = fb.demand.dtype
    like = {"host_bw": ((cfg.n_hosts, P), fl), "util": ((P, L, U), fl),
            "queue": ((P, L, U), fl), "ecn": ((F, P), fl),
            "eligible": ((F, P), torch.bool)}
    return [(lead + like[f][0], like[f][1]) for f in fields]


def _record_rows(slots: int, every: int) -> np.ndarray:
    """(T,) record row of each slot: `t // every` at the recorded slots
    `range(0, slots, every)`, -1 (not recorded) elsewhere."""
    t = np.arange(slots)
    return np.where(t % every == 0, t // every, -1)


def _check_mode(cfg: EngineConfig, ops: SlotOperands,
                trace: Optional[TraceSpec]) -> None:
    """Refuse what the reference refuses: chunks without sparse
    aggregation (`ValueError`: the dense plans are the one-pass layout
    chunks exist to avoid) or with a trace (`NotImplementedError`: a
    trace records whole-run fields every slot); and sparse aggregation
    without its plans."""
    if cfg.flow_chunk:
        if cfg.agg_mode != "sparse":
            raise ValueError(
                "flow_chunk requires agg_mode='sparse' (the dense gather "
                "plans are exactly the one-pass layout chunking avoids)")
        if _traced(trace):
            raise NotImplementedError(
                "flow_chunk does not compose with TraceSpec captures")
    if cfg.agg_mode == "sparse" and ops.sparse is None:
        raise ValueError("sparse aggregation needs the operands' segment-"
                         "sum plans (`SlotOperands.sparse`)")
    if cfg.flow_chunk and ops.sparse.chunk != cfg.flow_chunk:
        raise ValueError(f"operands chunked by {ops.sparse.chunk} flows, "
                         f"the config by {cfg.flow_chunk}")


def slot_loop(cfg: EngineConfig, ops: SlotOperands,
              carry0: Optional[SimCarry] = None,
              trace: Optional[TraceSpec] = None) -> SlotLoop:
    """The run's slots as a `SlotLoop` over static buffers, starting
    from `carry0` (the initial carry by default); under failure reaction
    its second series is the blackhole timeline, and with `trace`
    enabled its records are the active trace fields."""
    _check_mode(cfg, ops, trace)
    carry = init_carry(ops.fb, cfg) if carry0 is None else carry0
    fields = _traced(trace)
    return SlotLoop(partial(_slot, cfg, ops, trace=trace), carry,
                    ops.seg_id, [_counted(cfg, t) for t in range(cfg.slots)],
                    n_series=2 if cfg.react else 1,
                    record_rows=(_record_rows(cfg.slots, trace.every)
                                 if fields else None),
                    record_like=_trace_like(cfg, ops, fields))


def _results(cfg: EngineConfig, carry: SimCarry, totals: torch.Tensor,
             blackhole: Optional[torch.Tensor] = None):
    """`(mean goodput, completion, per-slot totals, last util)`, and
    under failure reaction the per-slot blackholed totals; a batch's
    series come lane first, (B, T)."""
    n_rec, w0 = cfg.frames()
    frames = (n_rec - w0) if n_rec > w0 else n_rec
    return (sdiv(carry.goodput_sum, frames), carry.completion,
            totals.movedim(0, -1), carry.util_up) + \
        (() if blackhole is None else (blackhole.movedim(0, -1),))


def _loop_results(cfg: EngineConfig, loop: SlotLoop) -> tuple:
    """`_results` of a finished `SlotLoop`, then its records (a batch's
    lane first)."""
    lanes = loop.carry.goodput_sum.dim() - 1
    return _results(cfg, loop.carry, *loop.series) + \
        tuple(r.movedim(0, lanes) for r in loop.records)


def _simulate(cfg: EngineConfig, ops: SlotOperands,
              carry0: Optional[SimCarry] = None, *,
              trace: Optional[TraceSpec] = None, _eager: bool = False,
              timing: Optional[Dict] = None):
    """Run every slot: on CUDA as replays of captured slots
    (`slot_loop`), on the CPU, or with `_eager`, as an eager loop.
    Nothing in either loop reads device values on the host, so the host
    only queues work.  Returns `_results` as device tensors, then with
    `trace` enabled its fields over the recorded slots ((T_rec, ...)
    each; a batch's lane first).  `timing`, when a dict, receives the
    host walls of the capture (`capture_s`, which begins with a device
    synchronize) and of queueing the replays (`replay_s`) and a pair of
    CUDA events around the replays (`events`); of an eager loop its
    wall (`loop_s`)."""
    if ops.fb.demand.device.type == "cuda" and not _eager:
        loop = slot_loop(cfg, ops, carry0, trace)
        t0 = time.perf_counter()
        loop.capture()
        t1 = time.perf_counter()
        if timing is not None:
            events = tuple(torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            events[0].record()
        loop.replay()
        if timing is not None:
            events[1].record()
            timing.update(capture_s=t1 - t0,
                          replay_s=time.perf_counter() - t1, events=events)
        _count_loop(loop)
        return _loop_results(cfg, loop)
    _check_mode(cfg, ops, trace)
    t0 = time.perf_counter()
    carry = init_carry(ops.fb, cfg) if carry0 is None else carry0
    lead = tuple(ops.fb.demand.shape[:-1])
    series = ops.fb.demand.new_empty((2 if cfg.react else 1, cfg.slots)
                                     + lead)
    n = len(series)
    rec = []
    for t in range(cfg.slots):
        carry, *outs = _slot_step(cfg, ops, carry, t, trace)
        for k in range(n):
            series[k, t] = outs[k]
        if outs[n:] and t % trace.every == 0:
            rec.append(outs[n:])
    _count_loop(None)
    if timing is not None:
        timing["loop_s"] = time.perf_counter() - t0
    return _results(cfg, carry, *series) + \
        tuple(torch.stack(col).movedim(0, len(lead)) for col in zip(*rec))


# ---------------------------------------------------------------------------
# host preparation and entry points
# ---------------------------------------------------------------------------

class AggPerms(NamedTuple):
    """Flow→bucket gather plans: flow indices padded with F (the index
    of an appended zero row), flow order kept within each bucket."""
    src: np.ndarray         # (H, Cs) flows by src host
    dst: np.ndarray         # (H, Cd) flows by dst host
    pair: np.ndarray        # (L*L, Cp) flows by (src_leaf, dst_leaf)
    # (n_seg, P, `_plan_rows(cfg)`, Cu) flows by ECMP link: L*U up
    # buckets (src_leaf*U + spine or agg), then U*L down buckets
    # (spine or agg*L + dst_leaf), then on a fat tree the cross-pod
    # flows' pods*C up (pod_s*C + core) and pods*C down (pod_d*C + core)
    # buckets; a (1, P, 1, 1) placeholder of F under AR/WAR
    ecmp_load: np.ndarray


def _prepared(compiled, dtype: torch.dtype = torch.float64
              ) -> Tuple[EngineConfig, FlowArrays, FaultTimeline,
                         Optional[FaultTimeline]]:
    """`(cfg, flow arrays, physical timeline, visible timeline)` of
    `_lane` for a run in `dtype`: the visible timeline is the
    reaction-lagged view (None without a reaction, the physical timeline
    itself when the lag is zero)."""
    lane = _lane(compiled, dtype=dtype)
    return lane.cfg, lane.fa, lane.tl, lane.vtl


def phase_boundaries(pm: Optional[np.ndarray]) -> List[int]:
    """Slots where any phase-multiplier lane changes value ([0] always
    included) — unioned with the fault timeline's `change_slots()` so
    the piecewise-constant segment machinery covers both.  Phase changes
    never alter path capacity, so the ECMP re-hash replay draws no extra
    RNG at these boundaries."""
    if pm is None:
        return [0]
    diff = np.any(pm[1:] != pm[:-1], axis=1)
    return [0] + (np.flatnonzero(diff) + 1).tolist()


def _seg_dem(pm: Optional[np.ndarray], boundaries) -> np.ndarray:
    """(n_seg, K) demand-multiplier snapshots; a (n_seg, 1) ones
    placeholder when no schedule is present."""
    b = list(boundaries)
    if pm is None:
        return np.ones((len(b), 1))
    return np.asarray(pm)[b]


def _boundaries(tl: FaultTimeline, vtl: Optional[FaultTimeline],
                pm: Optional[np.ndarray] = None) -> Tuple[int, ...]:
    """Segment starts: every slot where the physical or the visible
    fabric changes, or a lane of the demand timeline `pm`."""
    b = set(tl.change_slots()) | set(phase_boundaries(pm))
    if vtl is not None:
        b |= set(vtl.change_slots())
    return tuple(sorted(b))


def _seg_id(boundaries, slots: int) -> np.ndarray:
    """(T,) index of the capacity segment governing each slot."""
    return (np.searchsorted(np.asarray(list(boundaries)),
                            np.arange(slots), side="right") - 1) \
        .astype(np.int32)


def _seg_caps(tl: FaultTimeline, boundaries) -> Tuple[np.ndarray, ...]:
    """Compress a dense timeline to its boundary snapshots ((n_seg, ...)
    each); `_seg_id` re-expands them per slot.  Returns up, down and
    access, and on a fat tree also up2 and down2."""
    b = list(boundaries)
    if tl.up2 is not None:
        return tl.up[b], tl.down[b], tl.access[b], tl.up2[b], tl.down2[b]
    return tl.up[b], tl.down[b], tl.access[b]


def _vis_seg_caps(vtl: FaultTimeline, boundaries) -> Tuple:
    """The routing-visible fabric snapshots (up, down, up2, down2);
    up2 and down2 are None on a leaf-spine."""
    b = list(boundaries)
    if vtl.up2 is not None:
        return vtl.up[b], vtl.down[b], vtl.up2[b], vtl.down2[b]
    return vtl.up[b], vtl.down[b], None, None


def _assign_for(cfg: EngineConfig, fa: FlowArrays, tl: FaultTimeline,
                seed: int, boundaries,
                vtl: Optional[FaultTimeline] = None,
                mode: str = "instant",
                backup: Optional[np.ndarray] = None) -> np.ndarray:
    """(n_seg, F, P) int32 ECMP path per (flow, plane) and capacity
    segment; a (1, F, P) zero placeholder under AR/WAR."""
    if cfg.routing == "ecmp":
        return ecmp_assign_segments(
            fa.src_leaf, fa.dst_leaf, tl, seed, cfg.n_paths, boundaries,
            uplink_cap=cfg.uplink_cap, core_cap=cfg.core_cap,
            cores_per_agg=cfg.cores_per_agg,
            leaves_per_pod=cfg.leaves_per_pod, vis_timeline=vtl,
            mode=mode, backup=backup)
    return np.zeros((1, len(fa), cfg.n_planes), np.int32)


def _ft_ecmp_keys(cfg: EngineConfig, fa: FlowArrays, assign_gp: np.ndarray
                  ) -> Tuple[Tuple[np.ndarray, np.ndarray, int], ...]:
    """The four fat-tree load-bucket key families of one (segment,
    plane) assignment column: (keys, mask, n_buckets) each, in plan row
    order (A-up, A-down, B-up, B-down)."""
    L, A = cfg.n_leaves, cfg.n_aggs
    J, pods = cfg.n_paths, cfg.n_pods
    a_of = assign_gp // cfg.cores_per_agg
    pod_s = fa.src_leaf // cfg.leaves_per_pod
    pod_d = fa.dst_leaf // cfg.leaves_per_pod
    cross = pod_s != pod_d
    every = np.ones(len(fa), bool)
    return ((fa.src_leaf * A + a_of, every, L * A),
            (a_of * L + fa.dst_leaf, every, A * L),
            (pod_s * J + assign_gp, cross, pods * J),
            (pod_d * J + assign_gp, cross, pods * J))


def _plan_rows(cfg: EngineConfig) -> int:
    """Rows of one ECMP load plan: stage-A up and down buckets, and on a
    fat tree the two stage-B bucket families."""
    if cfg.kind == "fat_tree":
        L, A = cfg.n_leaves, cfg.n_aggs
        return L * A + A * L + 2 * cfg.n_pods * cfg.n_paths
    return 2 * cfg.n_leaves * cfg.n_spines


def _agg_widths(cfg: EngineConfig, fa: FlowArrays,
                assign: np.ndarray) -> Tuple[int, int, int, int]:
    """Largest bucket of each aggregation axis (the plan widths): src
    host, dst host, leaf pair, and ECMP link over every (segment,
    plane) assignment (1 under AR/WAR).  All 1 under sparse
    aggregation, which builds no gather plan."""
    if cfg.agg_mode == "sparse":
        return (1, 1, 1, 1)
    def w(keys, n, mask=None):
        if mask is not None:
            keys = keys[mask]
            if keys.size == 0:
                return 1
        return max(1, int(np.bincount(keys, minlength=n).max()))
    H, L, S, P = cfg.n_hosts, cfg.n_leaves, cfg.n_spines, cfg.n_planes
    wu = 1
    if cfg.routing == "ecmp":
        for g in range(assign.shape[0]):
            for p in range(P):
                if cfg.kind == "fat_tree":
                    wu = max([wu] + [
                        w(keys, n, mask) for keys, mask, n in
                        _ft_ecmp_keys(cfg, fa, assign[g][:, p])])
                else:
                    wu = max(wu,
                             w(fa.src_leaf * S + assign[g][:, p], L * S),
                             w(assign[g][:, p] * L + fa.dst_leaf, S * L))
    return (w(fa.src, H), w(fa.dst, H),
            w(fa.src_leaf * L + fa.dst_leaf, L * L), wu)


def _ecmp_load_plan(cfg: EngineConfig, fa: FlowArrays, assign: np.ndarray,
                    wu: int, pad: int) -> np.ndarray:
    """(n_seg, P, `_plan_rows(cfg)`, wu) ECMP link-bucket plan (see
    `AggPerms`)."""
    P, L, S = cfg.n_planes, cfg.n_leaves, cfg.n_spines

    def plane(g, p):
        if cfg.kind == "fat_tree":
            return np.concatenate([
                _masked_perm_matrix(keys, mask, n, wu, pad)
                for keys, mask, n in
                _ft_ecmp_keys(cfg, fa, assign[g][:, p])])
        return np.concatenate([
            _perm_matrix(fa.src_leaf * S + assign[g][:, p], L * S, wu, pad),
            _perm_matrix(assign[g][:, p] * L + fa.dst_leaf, S * L, wu,
                         pad)])

    return np.stack([np.stack([plane(g, p) for p in range(P)])
                     for g in range(assign.shape[0])])


def _aggs_for(cfg: EngineConfig, fa: FlowArrays, assign: np.ndarray,
              widths: Tuple[int, int, int, int],
              pad: Optional[int] = None) -> AggPerms:
    """The plans of `fa`'s flows; `pad` (default `len(fa)`) is the index
    that reads the appended zero row: a flow-padded batch's row count,
    whose pad flows stay out of every plan."""
    ws, wd, wp, wu = widths
    H, L, P = cfg.n_hosts, cfg.n_leaves, cfg.n_planes
    F = len(fa) if pad is None else pad
    if cfg.agg_mode == "sparse":
        # the reference's inert placeholders: sparse aggregation reads
        # the CSR plans (`_sparse_plans`) instead
        z = np.zeros((1, 1), np.int32)
        return AggPerms(src=z, dst=z, pair=z,
                        ecmp_load=np.zeros((1, P, 1, 1), np.int32))
    if cfg.routing == "ecmp":
        load = _ecmp_load_plan(cfg, fa, assign, wu, F)
    else:
        load = np.full((1, P, 1, 1), F, np.int32)
    return AggPerms(
        src=_perm_matrix(fa.src, H, ws, F),
        dst=_perm_matrix(fa.dst, H, wd, F),
        pair=_perm_matrix(fa.src_leaf * L + fa.dst_leaf, L * L, wp, F),
        ecmp_load=load)


def _csr(parts, n_buckets: int, chunk: int, n_chunks: int
         ) -> SegmentPlan:
    """One CSR plan (int32 NumPy arrays) of the entries `parts`, a list
    of `(flows (n,), keys (n, P))`: flow f's value on plane p goes to
    bucket `keys[i, p]` (< `n_buckets`) where `flows[i] == f`.  Buckets
    are chunk-major (`n_chunks` x `n_buckets`, a chunk being `chunk`
    flows), each bucket's entries in flow order, as flat indices into
    its chunk's (chunk, P) values; parts never share a bucket.  Its
    `width` is the most entries of any bucket."""
    comp, local = [], []
    for flows, keys in parts:
        c = flows // chunk
        P = keys.shape[1]
        comp.append(((c * n_buckets)[:, None] + keys).ravel())
        local.append((((flows - c * chunk) * P)[:, None]
                      + np.arange(P)).ravel())
    comp, local = np.concatenate(comp), np.concatenate(local)
    order = np.argsort(comp, kind="stable")
    counts = np.bincount(comp, minlength=n_chunks * n_buckets)
    return SegmentPlan(
        np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        local[order].astype(np.int32), int(counts.max(initial=0)))


def _link_parts(cfg: EngineConfig, fa: FlowArrays, assign_g: np.ndarray):
    """`_csr` parts of one segment's ECMP link buckets, the reference's
    sparse keys family after family: stage-A up (plane, src leaf, spine
    or agg), stage-A down (plane, spine or agg, dst leaf), and on a fat
    tree the cross-pod flows' stage-B up (plane, src pod, core) and down
    (plane, dst pod, core) buckets (intra-pod flows add the reference's
    exact 0.0 there, so they stay out)."""
    P, L, U = cfg.n_planes, cfg.n_leaves, cfg.n_up
    pk = np.arange(P)[None, :]
    flows = np.arange(len(fa))
    src, dst = fa.src_leaf[:, None], fa.dst_leaf[:, None]
    a_of = assign_g // cfg.cores_per_agg
    LU = P * L * U
    parts = [(flows, pk * (L * U) + src * U + a_of),
             (flows, LU + pk * (U * L) + a_of * L + dst)]
    if cfg.kind == "fat_tree":
        J, pods, lpp = cfg.n_paths, cfg.n_pods, cfg.leaves_per_pod
        cross = np.flatnonzero(fa.src_leaf // lpp != fa.dst_leaf // lpp)
        B = P * pods * J
        g = assign_g[cross]
        parts += [(cross, 2 * LU + pk * (pods * J)
                   + (fa.src_leaf[cross] // lpp)[:, None] * J + g),
                  (cross, 2 * LU + B + pk * (pods * J)
                   + (fa.dst_leaf[cross] // lpp)[:, None] * J + g)]
    return parts


def _sparse_plans(cfg: EngineConfig, fa: FlowArrays, assign: np.ndarray,
                  chunk: int, n_chunks: int) -> SparsePlans:
    """The CSR plans of sparse aggregation (NumPy), in `n_chunks` chunks
    of `chunk` flows: offered rate by (src host, plane) and by (dst
    host, plane), and fabric rate by (plane, leaf pair) under AR/WAR or,
    under ECMP, by link for each segment's assignment (offsets and
    entries stacked (n_seg, ...); a segment's entry count is the
    same).  Keys are the reference's `segment_load` keys, so a bucket
    sums its flows in the reference's order."""
    P, L, H = cfg.n_planes, cfg.n_leaves, cfg.n_hosts
    pk = np.arange(P)[None, :]
    flows = np.arange(len(fa))

    def plan(parts, n):
        return _csr(parts, n, chunk, n_chunks)

    pair = link = None
    if cfg.routing == "ecmp":
        plans = [plan(_link_parts(cfg, fa, assign[g]), P * _plan_rows(cfg))
                 for g in range(assign.shape[0])]
        link = SegmentPlan(np.stack([p.offsets for p in plans]),
                           np.stack([p.entries for p in plans]),
                           max(p.width for p in plans))
    else:
        pair_idx = fa.src_leaf * L + fa.dst_leaf
        pair = plan([(flows, pk * (L * L) + pair_idx[:, None])], P * L * L)
    return SparsePlans(
        src=plan([(flows, fa.src[:, None] * P + pk)], H * P),
        dst=plan([(flows, fa.dst[:, None] * P + pk)], H * P),
        pair=pair, link=link, chunk=chunk, n_in=len(fa))


class _Lane(NamedTuple):
    """Host prep of one point on its own segments: the spec's name, the
    config and trace spec (the point's structure), the flow arrays, the
    physical and visible timelines, the demand timeline (None without a
    schedule), its segment starts, its ECMP assignment per segment and
    its plan widths; the `*_key`s are the content keys it was memoized
    under."""
    name: str
    cfg: EngineConfig
    trace: TraceSpec
    fa: FlowArrays
    tl: FaultTimeline
    vtl: Optional[FaultTimeline]
    pm: Optional[np.ndarray]
    boundaries: Tuple[int, ...]
    assign: np.ndarray
    widths: Tuple[int, int, int, int]
    fa_key: tuple
    assign_key: tuple


def _lane_key(compiled, dtype: torch.dtype = torch.float64
              ) -> Tuple[EngineConfig, TraceSpec]:
    """A point's structure, which the lanes of one batch share: its
    config (with the reaction flag, its demand-timeline lanes, and its
    aggregation mode and flow chunks for a run in `dtype`, as the
    reference's `_prepared` sets them: a chunk length makes the run
    sparse, and a trace keeps it in one pass) and trace spec."""
    cfg = EngineConfig.from_sim(compiled.cfg, compiled.spec.topo)
    r = compiled.spec.reaction
    if r is not None and r.enabled:
        cfg = replace(cfg, react=True)
    if compiled.phase_mult is not None:
        cfg = replace(cfg, n_phases=int(compiled.phase_mult.shape[1]))
    trace = compiled.cfg.trace if compiled.cfg.trace.enabled \
        else TraceSpec()
    chunk = flow_chunk_default(len(compiled.flows), cfg.n_planes,
                               cfg.agg_mode, dtype)
    if chunk and not trace.enabled:
        cfg = replace(cfg, agg_mode="sparse", flow_chunk=chunk)
    return cfg, trace


def _lane(compiled, caches: Optional[Dict] = None,
          dtype: torch.dtype = torch.float64) -> _Lane:
    """Host prep of one point: its config and trace spec, flow arrays,
    timelines (the visible one reaction-lagged: None without a
    reaction, the physical one when the lag is zero), segment starts,
    ECMP replay and plan widths.  With `caches`, what depends on part
    of the spec only is built once per content, as the reference's
    megabatch `_prepare` memoizes it: the flow arrays per (topology,
    tenants, workloads, workload seed, and with a schedule the slot
    length its byte volumes are calibrated to), the segment starts and
    timelines per (faults, slots, slot length, topology, workload seed,
    demand-timeline boundaries, reaction lag), the assignment per
    (flows, timeline, routing, ECMP seed, reaction mode), the widths
    per assignment."""
    caches = {} if caches is None else caches
    spec = compiled.spec
    cfg, trace = _lane_key(compiled, dtype)
    r = spec.reaction
    react = cfg.react
    lag = reaction_lag(r, spec.sim.routing) if react else None
    pm = compiled.phase_mult
    fa_key = ("fa", spec.topo, spec.tenants, spec.workloads,
              spec.workload_seed, None if pm is None else spec.sim.slot_us)
    if fa_key not in caches:
        caches[fa_key] = FlowArrays.build(compiled.flows, compiled.topo)
    fa = caches[fa_key]
    pb = tuple(phase_boundaries(pm))
    tl_key = ("tl", spec.faults, spec.sim.slots, spec.sim.slot_us,
              spec.topo, spec.workload_seed, pb, lag)
    if tl_key not in caches:
        tl = compile_fault_timeline(spec)
        vtl = (lagged_timeline(tl, lag) if lag else tl) if react else None
        caches[tl_key] = (tl, vtl, _boundaries(tl, vtl, pm))
    tl, vtl, boundaries = caches[tl_key]
    mode = r.mode if react else "instant"
    assign_key = ("assign", fa_key, tl_key, cfg.routing,
                  compiled.cfg.seed if cfg.routing == "ecmp" else None, mode)
    if assign_key not in caches:
        caches[assign_key] = _assign_for(
            cfg, fa, tl, compiled.cfg.seed, boundaries, vtl=vtl, mode=mode,
            backup=compiled.backup)
    assign = caches[assign_key]
    w_key = ("widths", assign_key, cfg.agg_mode)
    if w_key not in caches:
        caches[w_key] = _agg_widths(cfg, fa, assign)
    return _Lane(spec.name, cfg, trace, fa, tl, vtl, pm, boundaries,
                 assign, caches[w_key], fa_key, assign_key)


def _batch_widths(lanes: Sequence[_Lane]) -> Tuple[int, int, int, int]:
    """A batch's plan widths: the widest lane's, axis by axis."""
    return tuple(map(max, zip(*(ln.widths for ln in lanes))))


def _lane_aggs(lane: _Lane, widths, pad: Optional[int] = None,
               caches: Optional[Dict] = None) -> AggPerms:
    """The plans of a lane's flows at `widths`, reading row `pad` for
    padding (`_aggs_for`), memoized in `caches` per (assignment, widths,
    pad)."""
    caches = {} if caches is None else caches
    key = ("aggs", lane.assign_key, widths, pad)
    if key not in caches:
        caches[key] = _aggs_for(lane.cfg, lane.fa, lane.assign, widths, pad)
    return caches[key]


def _lane_sparse(lane: _Lane, n_flows: int,
                 caches: Optional[Dict] = None) -> SparsePlans:
    """The sparse plans of a lane's flows padded to `n_flows` (a
    multiple of the chunk length when the lane's config chunks; its pad
    flows stay out of every plan), memoized in `caches` per
    (assignment, chunk, flow count)."""
    caches = {} if caches is None else caches
    chunk = lane.cfg.flow_chunk or n_flows
    key = ("sparse", lane.assign_key, chunk, n_flows)
    if key not in caches:
        caches[key] = _sparse_plans(lane.cfg, lane.fa, lane.assign, chunk,
                                    n_flows // chunk)
    return caches[key]


def _lane_operands(lane: _Lane, boundaries, widths, device, dtype,
                   pad: Optional[int] = None,
                   caches: Optional[Dict] = None) -> SlotOperands:
    """One point's slot operands on the segments starting at
    `boundaries` (its own, or a batch's union of them: its capacity
    snapshots are taken there and its ECMP assignment and plans
    re-indexed from its own segments, so each union segment holds what
    the point's own segment holds), with plans of `widths` and, with
    `pad`, its flows padded to `pad` inert ones (zero demand, no bytes
    left to finish, never started, on one leaf: they touch no link and
    no plan).  Under sparse aggregation its plans are the CSR ones
    (`_lane_sparse`), and with `cfg.flow_chunk` its flows are padded
    further, to whole chunks, the totals still summing the first `pad`
    (or all its own) flows.  Under `cfg.n_phases` its demand multipliers
    are its timeline's values at `boundaries`, padded to `n_phases`
    lanes with 1.0 (all ones without a schedule; no flow reads a padded
    lane).  In float32 it warns of `bytes_total` beyond float32's
    integer resolution (`_warn_f32_bytes`)."""
    cfg, fa = lane.cfg, lane.fa
    if dtype == torch.float32:
        _warn_f32_bytes(lane.name, fa)
    # the flows the per-slot totals sum over, and those rounded up to
    # whole chunks
    n_in = len(fa) if pad is None else pad
    ch = cfg.flow_chunk
    n_flows = -(-n_in // ch) * ch if ch else n_in
    aggs, assign = _lane_aggs(lane, widths, pad, caches), lane.assign
    sparse = None
    if cfg.agg_mode == "sparse":
        sparse = _lane_sparse(lane, n_flows, caches)._replace(n_in=n_in)
    if cfg.routing == "ecmp" and tuple(boundaries) != lane.boundaries:
        own = np.searchsorted(lane.boundaries, boundaries, "right") - 1
        if sparse is None:
            aggs = aggs._replace(ecmp_load=aggs.ecmp_load[own])
        else:
            sparse = sparse._replace(link=sparse.link._replace(
                offsets=sparse.link.offsets[own],
                entries=sparse.link.entries[own]))
        assign = assign[own]
    flows = fa
    if n_flows > len(fa):
        flows, assign = _padded_flows(fa, assign, n_flows, cfg.slots)
    up, down, acc, *stage_b = _seg_caps(lane.tl, boundaries)
    up2, down2 = stage_b or (None, None)
    dem = None
    if cfg.n_phases:
        dem = _seg_dem(lane.pm, boundaries)
        dem = np.concatenate(
            [dem, np.ones((len(dem), cfg.n_phases - dem.shape[1]))], 1)
    return operands_from_numpy(
        cfg, flows, aggs, up, down, acc, _seg_id(boundaries, cfg.slots),
        assign=assign, seg_up2=up2, seg_down2=down2,
        vis=_vis_seg_caps(lane.vtl, boundaries) if cfg.react else None,
        seg_dem=dem, sparse=sparse, device=device, dtype=dtype)


# float32 bytes_total overflow conditions seen in this process, in
# detection order (the reference's `jx/engine.py::_F32_OVERFLOWS`), and
# the spec names already warned about
_F32_OVERFLOWS: List[Dict] = []
_F32_WARNED: set = set()


def strict_f32() -> bool:
    """`REPRO_JX_STRICT_F32=1` turns the float32 bytes_total overflow
    warning into a hard error, in both packages."""
    return bool(_env_flag("REPRO_JX_STRICT_F32"))


def f32_overflow_log() -> Tuple[Dict, ...]:
    """Every float32 bytes_total overflow condition seen this process,
    in detection order — `{"spec": name, "max_bytes": float}` each.
    Executors slice this by length to attach the overflows of one run
    to its flight record."""
    return tuple(dict(d) for d in _F32_OVERFLOWS)


def _warn_f32_bytes(name: str, fa: FlowArrays, stacklevel: int = 4
                    ) -> None:
    """Log, and warn once per spec name, a finite `bytes_total` above
    2^24 prepared for a float32 run: past float32's integer resolution
    the remaining-bytes countdown stalls and the transfer may never
    complete.  Under `strict_f32()` it raises `ValueError` after the
    log entry instead of warning."""
    finite = fa.bytes_total[np.isfinite(fa.bytes_total)]
    if not (finite.size and finite.max() > 2 ** 24):
        return
    msg = (f"{name}: bytes_total up to {finite.max():.3g} exceeds float32 "
           "integer resolution (2^24); remaining-bytes tracking will stall "
           "and transfers may never complete — run in float64 "
           "(dtype=torch.float64, the default) or rescale bytes_total")
    _F32_OVERFLOWS.append({"spec": name, "max_bytes": float(finite.max())})
    first = name not in _F32_WARNED
    _F32_WARNED.add(name)
    if strict_f32():
        raise ValueError(msg)
    # stdlib warnings dedup by call site, so a second spec tripping the
    # same condition would be swallowed: dedup per spec name here
    if first:
        warnings.warn(msg, stacklevel=stacklevel)


def _padded_flows(fa: FlowArrays, assign: np.ndarray, n: int, slots: int):
    """`fa`'s columns and the (n_seg, F, P) assignment padded to `n`
    flows with inert ones (the reference's `_padded_flow_cols`)."""
    k = n - len(fa)

    def p(a, fill):
        return np.concatenate([a, np.full(k, fill, a.dtype)])

    flows = replace(
        fa, src=p(fa.src, 0), dst=p(fa.dst, 0),
        src_leaf=p(fa.src_leaf, 0), dst_leaf=p(fa.dst_leaf, 0),
        demand=p(fa.demand, 0.0), bytes_total=p(fa.bytes_total, np.inf),
        group=p(fa.group, 0), start_slot=p(fa.start_slot, slots),
        phase=p(fa.phase, 0))
    assign = np.concatenate(
        [assign, np.zeros(assign.shape[:1] + (k,) + assign.shape[2:],
                          assign.dtype)], 1)
    return flows, assign


def prepare(compiled, device=None, dtype=torch.float64
            ) -> Tuple[EngineConfig, FlowArrays, SlotOperands]:
    """Host prep of one `CompiledScenario`: the config, the flow arrays
    and the slot operands on `device`."""
    device = resolve_device(device)
    lane = _lane(compiled, dtype=dtype)
    return lane.cfg, lane.fa, _lane_operands(
        lane, lane.boundaries, lane.widths, device, dtype)


def _wrap(cfg: EngineConfig, fa: FlowArrays, out, device: torch.device,
          trace: Optional[TraceSpec] = None) -> EngineResult:
    """One point's `EngineResult` from its `_simulate` outputs."""
    fields = _traced(trace)
    n = len(out) - len(fields)
    mean_goodput, completion, totals, util, *bh = \
        (o.cpu().numpy() for o in out[:n])
    # a chunked run's flows were padded to whole chunks
    mean_goodput, completion = mean_goodput[:len(fa)], completion[:len(fa)]
    rec = None
    if fields:
        rec = {"slot": trace.recorded_slots(cfg.slots)}
        rec.update((f, o.cpu().numpy()) for f, o in zip(fields, out[n:]))
    return EngineResult(
        mean_goodput=mean_goodput,
        completion_slot=completion.astype(np.int64),
        total_goodput=totals[::cfg.record_every], util_up_last=util,
        groups=fa.groups, group_of=fa.group, slot_us=cfg.slot_us,
        device=str(device), blackhole_timeline=bh[0] if bh else None,
        trace=rec)


def run_compiled(compiled, device=None, dtype=None) -> EngineResult:
    """Simulate one `CompiledScenario`.  `device` defaults to CUDA (and
    raises without a GPU); `device="cpu"` runs the plain path.  `dtype`
    is float64 (parity mode, the default) or float32 (fast mode).  A
    spec whose `sim.trace` is enabled also records its trace
    (`EngineResult.trace`)."""
    cfg, fa, ops = prepare(compiled, device,
                           torch.float64 if dtype is None else dtype)
    trace = compiled.cfg.trace
    return _wrap(cfg, fa, _simulate(cfg, ops, trace=trace),
                 ops.fb.src.device, trace)


# ---------------------------------------------------------------------------
# batches of points of one structure
# ---------------------------------------------------------------------------

# slot loops run and CUDA graphs captured since the last reset (the
# counterpart of the reference's `dispatch_stats`)
_DISPATCH = {"loops": 0, "graphs": 0}


def dispatch_stats() -> Dict[str, int]:
    """`loops`: slot loops run (one a point, or one a batch);
    `graphs`: CUDA graphs their captures made (0 on the CPU)."""
    return dict(_DISPATCH)


def reset_dispatch_stats() -> None:
    _DISPATCH.update(loops=0, graphs=0)


def _count_loop(loop: Optional[SlotLoop]) -> None:
    _DISPATCH["loops"] += 1
    if loop is not None:
        _DISPATCH["graphs"] += len(loop.graphs)


class BatchHandle(NamedTuple):
    """A dispatched batch: what `finalize_batch` needs to unpack it.
    `fas` holds each lane's flow arrays (the batch may pad its flows)."""
    cfg: EngineConfig
    trace: TraceSpec
    fas: List[FlowArrays]
    out: tuple
    device: torch.device


def _batch_operands(lanes: Sequence[_Lane], device, dtype,
                    pad: Optional[int] = None,
                    caches: Optional[Dict] = None) -> SlotOperands:
    """The lanes' operands stacked on the union of their segment
    starts, with plans of the widest lane's widths."""
    union = tuple(sorted(set().union(*(ln.boundaries for ln in lanes))))
    widths = _batch_widths(lanes)
    return stack_operands([_lane_operands(ln, union, widths, device, dtype,
                                          pad, caches) for ln in lanes],
                          lanes[0].cfg)


def _dispatch_lanes(lanes: Sequence[_Lane], device, dtype,
                    pad: Optional[int] = None,
                    caches: Optional[Dict] = None,
                    timing: Optional[Dict] = None) -> BatchHandle:
    """Stack the lanes' operands and queue their slot loop.  `timing`,
    when a dict, receives the wall of building the operands on the
    device (`operands_s`) and `_simulate`'s walls."""
    cfg, trace = lanes[0].cfg, lanes[0].trace
    t0 = time.perf_counter()
    ops = _batch_operands(lanes, device, dtype, pad, caches)
    if timing is not None:
        timing["operands_s"] = time.perf_counter() - t0
    return BatchHandle(cfg, trace, [ln.fa for ln in lanes],
                       _simulate(cfg, ops, trace=trace, timing=timing),
                       device)


def prepare_batch(points: Sequence, device=None, dtype=None
                  ) -> Tuple[EngineConfig, TraceSpec, List[FlowArrays],
                             SlotOperands]:
    """Host prep of a batch of `CompiledScenario`s that share structure
    (the same `EngineConfig` and trace spec, so the same scenario shape,
    routing, NIC and slots, and the same flow count; seeds, faults and
    flows may differ): the config, the trace spec, each point's flow
    arrays and the lane-stacked operands on `device`, on the union of
    the points' segment starts.  Raises `ValueError` for points of
    another structure."""
    device = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    caches: Dict = {}
    lanes = [_lane(c, caches, dtype) for c in points]
    cfg, trace, F = lanes[0].cfg, lanes[0].trace, len(lanes[0].fa)
    for ln in lanes:
        if ln.cfg != cfg or ln.trace != trace or len(ln.fa) != F:
            raise ValueError(
                "batched points must be structurally identical "
                f"(got {ln.cfg} with {len(ln.fa)} flows vs {cfg} with "
                f"{F}); group grid points by (scenario, routing, nic) "
                "first")
    return cfg, trace, [ln.fa for ln in lanes], _batch_operands(
        lanes, device, dtype, caches=caches)


def dispatch_compiled_batch(points: Sequence, device=None, dtype=None
                            ) -> BatchHandle:
    """Prepare (`prepare_batch`) and queue one batch of points as one
    slot loop over a lane axis: on CUDA one captured graph per segment
    of the union of the points' segment starts.  Returns a handle for
    `finalize_batch`.  On CUDA the replays are queued and the call
    returns while the device runs them, so the caller's host work
    overlaps the loop; but the next capture (this function's, or any
    `run_compiled`'s) begins with a device synchronize and so waits for
    this loop to finish: two captured loops are never in flight
    together."""
    cfg, trace, fas, ops = prepare_batch(points, device, dtype)
    return BatchHandle(cfg, trace, fas, _simulate(cfg, ops, trace=trace),
                       ops.fb.src.device)


def finalize_batch(handle: BatchHandle) -> List[EngineResult]:
    """Wait for a dispatched batch and unpack one `EngineResult` per
    point, in point order; flow-axis outputs keep each point's own flow
    count."""
    cfg, trace, fas, out, device = handle
    out = [o.cpu() for o in out]
    n = len(out) - len(_traced(trace))
    res = []
    for b, fa in enumerate(fas):
        F = len(fa)
        row = [o[b] for o in out]
        row[:2] = (row[0][:F], row[1][:F])
        row[n:] = [r[:, :F] if f in FLOW_AXIS_FIELDS else r
                   for f, r in zip(_traced(trace), row[n:])]
        res.append(_wrap(cfg, fa, row, device, trace))
    return res


def run_compiled_batch(points: Sequence, device=None, dtype=None
                       ) -> List[EngineResult]:
    """Simulate a batch of `CompiledScenario`s that share structure as
    one slot loop over a lane axis (see `dispatch_compiled_batch`).
    Each lane computes what its point computes alone: per-flow outputs
    bit for bit, its per-slot series up to the reduction tree of one
    sum a slot."""
    return finalize_batch(dispatch_compiled_batch(points, device, dtype))
