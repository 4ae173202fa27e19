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
  * points with and without a schedule workload share a sub-batch: its
    `n_phases` is the pow2 bucket of its widest demand timeline (0 when
    no point has one, so the slot has no demand multiply), and a lane
    without a schedule, or with fewer timeline lanes, reads 1.0 in the
    lanes it lacks.  The reference puts `n_phases` in its structural
    key and runs such points in separate programs; the results are the
    same (a product with 1.0 is exact), the loops fewer;
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

Host prep and dispatch are two steps, so an executor can pipeline
them: `prepare_planned` yields a group's sub-batches one at a time,
each prepared on the host only when it is asked for, and
`dispatch_prepared` builds one sub-batch's operands on the device and
queues its loop.  On CUDA a loop's replays are queued and the call
returns while the device runs them, so the next sub-batch's host prep
overlaps it; the next capture, though, begins with a device
synchronize, so two loops are never in flight together
(`repro_torch.experiments.execute` runs this pipeline).

`finalize_group` strips each point's outputs back to its own flow count,
the `FLOW_AXIS_FIELDS` of its trace included.  `engine.dispatch_stats`
counts the slot loops (and, on CUDA, the graphs) the dispatches ran.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch

from . import engine
from .engine import BatchHandle, EngineResult

# flow-count buckets start here: tiny scenarios all land in one shape
FLOW_BUCKET_MIN = 8


def _bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= n (>= lo): the flow counts that let
    points of different scenarios share one batch."""
    return max(lo, 1 << max(0, int(n - 1).bit_length()))


def _sub_key(compiled) -> Tuple:
    """A point's sub-batch within its group: its structure
    (`engine._lane_key`) with the demand-timeline lane count lifted
    out."""
    cfg, trace = engine._lane_key(compiled)
    return replace(cfg, n_phases=0), trace


def _struct_key(compiled) -> Tuple:
    """A point's structure with routing and NIC lifted out, and its
    flow bucket."""
    cfg, trace = _sub_key(compiled)
    cfg = replace(cfg, routing="*", nic="*", sw_lb_delay_slots=0)
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


class Prepared(NamedTuple):
    """One (routing, NIC) sub-batch of a planned group after host prep:
    its point indices, its lanes (`engine._lane`) and the flow count
    they are padded to (the group's bucket)."""
    idxs: List[int]
    lanes: List[engine._Lane]
    pad: int


def prepare_planned(group: Sequence[Tuple], caches: Dict
                    ) -> Iterator[Prepared]:
    """Host prep (memoized in `caches`) of one planned group, one
    (routing, NIC) sub-batch at a time: a generator, so each sub-batch
    is prepared only when the caller asks for it (after dispatching the
    one before, say).  Each lane's plans at the sub-batch's widths are
    built here too, so `dispatch_prepared` only moves operands to the
    device.  Every lane of a sub-batch takes its `n_phases` bucket.
    Makes no device call."""
    pad = _bucket(max(len(c.flows) for _, c in group), FLOW_BUCKET_MIN)
    subs: Dict[Tuple, List[Tuple[int, object]]] = {}
    for i, c in group:
        subs.setdefault(_sub_key(c), []).append((i, c))
    for members in subs.values():
        lanes = [engine._lane(c, caches) for _, c in members]
        k = max(ln.cfg.n_phases for ln in lanes)
        lanes = [ln._replace(cfg=replace(ln.cfg, n_phases=_bucket(k) if k
                                         else 0)) for ln in lanes]
        widths = engine._batch_widths(lanes)
        for lane in lanes:
            engine._lane_aggs(lane, widths, pad, caches)
        yield Prepared([i for i, _ in members], lanes, pad)


def dispatch_prepared(prep: Prepared, caches: Dict, device=None,
                      dtype=None, timing: Optional[Dict] = None
                      ) -> Tuple[List[int], BatchHandle]:
    """Build one prepared sub-batch's operands on `device` and queue its
    slot loop.  Returns `(point indices, handle)` for `finalize_group`;
    `timing` as `engine._dispatch_lanes`'."""
    device = engine.resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    return prep.idxs, engine._dispatch_lanes(
        prep.lanes, device, dtype, pad=prep.pad, caches=caches,
        timing=timing)


def dispatch_planned(group: Sequence[Tuple], caches: Dict, device=None,
                     dtype=None) -> List[Tuple[List[int], BatchHandle]]:
    """Host prep (memoized in `caches`) and dispatch of one planned
    group: one slot loop per (routing, NIC) sub-batch, its lanes padded
    to the group's flow bucket.  Returns `[(point indices, handle)]`
    for `finalize_group`."""
    return [dispatch_prepared(prep, caches, device, dtype)
            for prep in prepare_planned(group, caches)]


def dispatch_megabatch(points: Sequence, device=None, dtype=None
                       ) -> List[Tuple[List[int], BatchHandle]]:
    """`plan_megabatch` and `dispatch_planned` of every group.  Returns
    `[(point indices, handle)]` for `finalize_group`.  On CUDA each
    capture waits for the loop before it (see the module docstring), so
    the loops run one after another; only the last may still be running
    when this returns."""
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
