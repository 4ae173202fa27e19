"""Byte accounting and the static step skeleton for schedule workloads
(a copy of the reference's `comms/schedule.py` over the port's model
layout).

`plan_schedule` resolves a `ScheduleSpec` against the architecture
registry and produces a `SchedulePlan`: calibrated per-collective byte
volumes (simulator units) plus the per-step window layout that
`comms.lower` turns into flows and a demand-multiplier timeline.

Real-byte sources — each collective's volume comes from the subsystem
that actually moves those bytes in training, not from ad-hoc constants:

  * DP gradient sync — dtype-aware micro-chunk sizes from
    `core.collectives.stream_report` over `models.param_shapes` (meta
    tensors: no weights are materialized); the ring / RS+AG volume per
    rank is ``2 (D-1)/D`` of the rank's gradient shard.
  * MoE all2all — `models.moe` capacity math: two ``(E, C, d_model)``
    dispatch/combine buffers per MoE layer at compute dtype, cross-rank
    share ``(m-1)/m`` over the EP group (= the DP group here).
  * PP activations — tokens-per-microbatch × d_model at compute dtype
    per pipeline edge, forward; backward carries the same volume in
    gradients (modelled as a 2× window, matching the usual fwd:bwd
    FLOP ratio).
  * Checkpoint writes — the rank's parameter-shard bytes (every leaf
    of the parameter tree).

Calibration: fabric capacity 1.0 moves ``line_rate_gbps`` for one slot,
so ``sim_bytes = real_bytes / (line_rate_gbps * 125 * slot_us)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.collectives import stream_report
from repro_torch.core.planes import PlaneConfig
from repro_torch.models.moe import _capacity
from repro_torch.models.transformer import param_shapes, torch_dtype

# Demand-multiplier lane layout of one lowered schedule: lane 0 is the
# global always-1.0 lane, then fwd / bwd / compute(fwd|bwd) windows.
LANES_PER_SCHEDULE = 4
FWD_LANE, BWD_LANE, COMPUTE_LANE = 1, 2, 3

# Minimum window width in slots — keeps the step skeleton well-formed
# even when a collective's calibrated volume rounds to under one slot.
MIN_WINDOW = 4
STEP_PAD = 2


def sim_bytes(real_bytes: float, line_rate_gbps: float,
              slot_us: float) -> float:
    """Real bytes -> simulator byte units (1 Gbit/s = 125 bytes/us)."""
    return real_bytes / (line_rate_gbps * 125.0 * slot_us)


def _itemsize(dtype_name: str) -> int:
    """Bytes an element of a config's dtype name, through torch's dtypes
    (numpy has no bfloat16)."""
    return torch_dtype(dtype_name).itemsize


def resolve_model(ss):
    """ScheduleSpec -> the `ModelConfig` whose traffic it compiles
    (`reduced()` family shrink when `ss.reduced` — registry scenarios
    stay numpy-fast while keeping dense/MoE structure)."""
    cfg = get_config(ss.model)
    return cfg.reduced() if ss.reduced else cfg


def grad_chunk_bytes(cfg, n_planes: int) -> np.ndarray:
    """Dtype-aware gradient micro-chunk sizes for the whole model —
    `stream_report` over `param_shapes`, i.e. the exact chunking the
    plane-sharded allreduce engine would stream.  Every leaf is a meta
    tensor at `param_dtype` (gradients stream at master-weight
    precision), so the volumes depend on nothing but the config."""
    rep = stream_report(param_shapes(cfg), PlaneConfig(
        n_planes=n_planes, microchunks=max(16, n_planes)))
    return rep.chunk_bytes


def moe_a2a_bytes_per_rank(cfg, ss) -> float:
    """Real all2all bytes one rank exchanges per step: two (E, C, d)
    buffers per MoE layer at compute dtype, cross-rank share (m-1)/m
    over the EP group (the DP group)."""
    if cfg.moe_experts == 0:
        return 0.0
    per_period = sum(cfg.is_moe_pos(p) for p in range(cfg.pattern_len))
    n_moe = cfg.n_periods * per_period
    if n_moe == 0:
        return 0.0
    cap = _capacity(ss.tokens_per_rank, cfg)
    buf = cfg.moe_experts * cap * cfg.d_model * _itemsize(cfg.dtype)
    m = ss.dp
    return n_moe * 2.0 * buf * (m - 1) / m


@dataclass(frozen=True)
class SchedulePlan:
    """Calibrated volumes (simulator byte units) + step skeleton."""
    model: str                 # resolved ModelConfig.name
    ar_flow: float             # one DP ring stream, per rank per step
    a2a_pair: float            # one ordered EP pair, per step
    act_edge: float            # per microbatch per pp edge (fwd)
    ckpt_rank: float           # one rank's checkpoint shard
    w_fwd: int
    w_bwd: int
    w_sync: int
    pad: int
    step_starts: Tuple[int, ...]
    grad_bytes_real: float     # whole-model gradient bytes (dtype-aware)
    a2a_bytes_real: float      # per rank per step
    act_bytes_real: float      # per microbatch per edge
    ckpt_bytes_real: float     # per rank

    @property
    def step_period(self) -> int:
        return self.w_fwd + self.w_bwd + self.w_sync + self.pad


def plan_schedule(ss, slot_us: float, slots: int, start_slot: int = 0,
                  n_planes: int = 1) -> SchedulePlan:
    """Byte-account a `ScheduleSpec` and lay out its step windows.

    Raises if the simulation horizon cannot hold `ss.steps` full steps —
    a schedule that silently truncates would corrupt step-time metrics.
    """
    cfg = resolve_model(ss)
    sb = lambda b: sim_bytes(b, ss.line_rate_gbps, slot_us)  # noqa: E731

    grad_real = float(grad_chunk_bytes(cfg, n_planes).sum())
    shard_real = grad_real / (ss.tp * ss.pp)
    ar_real = (2.0 * (ss.dp - 1) / ss.dp) * shard_real
    a2a_real = moe_a2a_bytes_per_rank(cfg, ss)
    act_real = ((ss.tokens_per_rank / ss.microbatches)
                * cfg.d_model * _itemsize(cfg.dtype)) if ss.pp > 1 else 0.0

    ar_flow = sb(ar_real)
    a2a_pair = sb(a2a_real) / max(ss.dp - 1, 1)
    act_edge = sb(act_real)
    ckpt_rank = sb(shard_real)

    # Static skeleton: forward window long enough to stream every
    # microbatch's activations at line rate, backward 2x (fwd:bwd FLOP
    # ratio), sync window sized to the uncongested ring stream.  The
    # compute windows must also drain the EP all2all (it overlaps
    # fwd+bwd = 3 w_fwd; with TP streams sharing the NIC its effective
    # rate halves) or back-to-back steps pile up unboundedly.
    a2a_rank = a2a_pair * max(ss.dp - 1, 1)
    overlap = 2.0 if ss.tp > 1 else 1.0
    w_fwd = max(MIN_WINDOW, math.ceil(ss.microbatches * act_edge),
                math.ceil(overlap * a2a_rank / 3.0))
    w_bwd = 2 * w_fwd
    w_sync = max(MIN_WINDOW, math.ceil(ar_flow))
    period = w_fwd + w_bwd + w_sync + STEP_PAD
    need = start_slot + ss.steps * period
    if slots < need:
        raise ValueError(
            f"schedule for {ss.model!r} needs {need} slots "
            f"({ss.steps} steps x {period}-slot period from slot "
            f"{start_slot}) but sim.slots = {slots}")
    step_starts = tuple(start_slot + s * period for s in range(ss.steps))
    return SchedulePlan(
        model=cfg.name, ar_flow=ar_flow, a2a_pair=a2a_pair,
        act_edge=act_edge, ckpt_rank=ckpt_rank,
        w_fwd=w_fwd, w_bwd=w_bwd, w_sync=w_sync, pad=STEP_PAD,
        step_starts=step_starts,
        grad_bytes_real=grad_real, a2a_bytes_real=a2a_real,
        act_bytes_real=act_real, ckpt_bytes_real=shard_real)


@dataclass(frozen=True)
class Phase:
    """One row of the compiled phase table (golden-tested)."""
    name: str                  # 'fwd' | 'bwd' | 'sync' | 'ckpt'
    step: int
    start_slot: int
    stop_slot: int
    sim_bytes: float           # closed-transfer volume scheduled here
    n_flows: int               # closed flows launched at start_slot


@dataclass(frozen=True)
class TrainSchedule:
    """Compiled-schedule metadata carried on `CompiledScenario` — enough
    to derive per-step completion times from either backend's
    `completion_slot` without re-running the compiler."""
    model: str
    dp: int
    tp: int
    pp: int
    steps: int
    n_ranks: int
    w_fwd: int
    w_bwd: int
    w_sync: int
    pad: int
    step_starts: Tuple[int, ...]
    phases: Tuple[Phase, ...]
    # Per-step indices of the closed flows whose completion defines the
    # step (DP sync + MoE a2a; checkpoint writes are background and
    # excluded).  Local to the lowered flow list until `shifted()`.
    step_flows: Tuple[Tuple[int, ...], ...]
    lane_offset: int           # global lane of this schedule's FWD_LANE - 1
    grad_bytes_real: float
    a2a_bytes_real: float
    ckpt_bytes_real: float

    @property
    def step_period(self) -> int:
        return self.w_fwd + self.w_bwd + self.w_sync + self.pad

    def shifted(self, offset: int) -> "TrainSchedule":
        """Rebase `step_flows` onto the scenario's global flow list."""
        return replace(self, step_flows=tuple(
            tuple(i + offset for i in s) for s in self.step_flows))

    def step_times(self, completion_slot, horizon: int) -> np.ndarray:
        """(steps,) slots from each scheduled step start to its last
        closed-flow completion (unfinished flows count as `horizon` —
        a step that never syncs is maximally late, not missing)."""
        comp = np.asarray(completion_slot, np.float64)
        out = []
        for s, idx in enumerate(self.step_flows):
            if not idx:
                out.append(float("nan"))
                continue
            c = comp[list(idx)]
            c = np.where(c < 0, float(horizon), c)
            out.append(float(c.max()) - self.step_starts[s])
        return np.asarray(out)
