"""Megabatch dispatch: a grid of scenario points in as few slot loops as
its structures allow, the counterpart of the reference's
`repro/netsim/jx/megabatch.py`.

`engine.dispatch_compiled_batch` batches points that share one
`EngineConfig`.  A grid that sweeps routing × NIC × faults × seeds over
several scenarios is grouped here instead:

  * points are grouped by structure with routing and NIC lifted out
    (the topology shape, slots, record cadence, reaction, trace spec)
    and by their pow2 flow bucket (`_bucket`, at least
    `FLOW_BUCKET_MIN`), as the reference groups them;
  * within a group, the reference's `lax.switch` over `StackIdx`
    becomes one sub-batch per (routing, NIC): each is one slot loop
    over a lane axis (on CUDA one captured graph a segment of the union
    of its points' segment starts), whose kernels take the NIC mode and
    whether weighted AR applies as launch constants;
  * flows are padded to the bucket with inert pad flows (zero demand,
    no bytes left to finish, never started, on one leaf), which stay
    out of every aggregation plan, so no lane's sum gains a term;
  * host prep is memoized by content (`engine._lane`): flow arrays,
    fault timelines, ECMP assignment replays, plan widths and plans are
    built once per distinct key, not once per point.

`finalize_group` strips each point's outputs back to its own flow count,
the `FLOW_AXIS_FIELDS` of its trace included.  `engine.dispatch_stats`
counts the slot loops (and, on CUDA, the graphs) the dispatches ran.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Sequence, Tuple

import torch

from . import engine
from .engine import BatchHandle, EngineResult

# flow-count buckets start here: tiny scenarios all land in one shape
FLOW_BUCKET_MIN = 8


def _bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= n (>= lo): the flow counts that let
    points of different scenarios share one batch."""
    return max(lo, 1 << max(0, int(n - 1).bit_length()))


def _struct_key(compiled) -> Tuple:
    """A point's structure with routing and NIC lifted out, and its
    flow bucket."""
    cfg = engine.EngineConfig.from_sim(compiled.cfg, compiled.spec.topo)
    r = compiled.spec.reaction
    cfg = replace(cfg, routing="*", nic="*", sw_lb_delay_slots=0,
                  react=r is not None and r.enabled)
    trace = compiled.cfg.trace if compiled.cfg.trace.enabled else None
    return cfg, trace, _bucket(len(compiled.flows), FLOW_BUCKET_MIN)


def plan_megabatch(points: Sequence) -> Tuple[Dict, List[List[Tuple]]]:
    """Group `CompiledScenario`s by structure and flow bucket without
    building anything.  Returns `(caches, planned)`: each planned group
    is `[(point_index, compiled), ...]`, ready for `dispatch_planned`,
    and `caches` the memo its host prep fills."""
    groups: Dict[Tuple, List[Tuple]] = {}
    for i, c in enumerate(points):
        groups.setdefault(_struct_key(c), []).append((i, c))
    return {}, list(groups.values())


def dispatch_planned(group: Sequence[Tuple], caches: Dict, device=None,
                     dtype=None) -> List[Tuple[List[int], BatchHandle]]:
    """Host prep (memoized in `caches`) and dispatch of one planned
    group: one slot loop per (routing, NIC) sub-batch, its lanes padded
    to the group's flow bucket.  Returns `[(point indices, handle)]`
    for `finalize_group`."""
    device = engine.resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    pad = _bucket(max(len(c.flows) for _, c in group), FLOW_BUCKET_MIN)
    subs: Dict[Tuple, List[Tuple[int, engine._Lane]]] = {}
    for i, c in group:
        lane = engine._lane(c, caches)
        subs.setdefault((lane.cfg, lane.trace), []).append((i, lane))
    out = []
    for members in subs.values():
        handle = engine._dispatch_lanes([ln for _, ln in members], device,
                                        dtype, pad=pad, caches=caches)
        out.append(([i for i, _ in members], handle))
    return out


def dispatch_megabatch(points: Sequence, device=None, dtype=None
                       ) -> List[Tuple[List[int], BatchHandle]]:
    """`plan_megabatch` and `dispatch_planned` of every group, all
    dispatched before any is waited for.  Returns `[(point indices,
    handle)]` for `finalize_group`."""
    caches, planned = plan_megabatch(points)
    out: List = []
    for group in planned:
        out.extend(dispatch_planned(group, caches, device, dtype))
    return out


def finalize_group(handle: BatchHandle) -> List[EngineResult]:
    """Wait for one dispatched sub-batch and unpack its points' results,
    in its point order, each stripped to its own flow count."""
    return engine.finalize_batch(handle)


def run_megabatch(points: Sequence, device=None, dtype=None
                  ) -> List[EngineResult]:
    """Simulate any `CompiledScenario` grid in one slot loop per
    (structure, flow bucket, routing, NIC), returning results in point
    order.  `device` and `dtype` as `engine.run_compiled`'s."""
    results: List = [None] * len(points)
    for idxs, handle in dispatch_megabatch(points, device, dtype):
        for i, r in zip(idxs, finalize_group(handle)):
            results[i] = r
    return results
