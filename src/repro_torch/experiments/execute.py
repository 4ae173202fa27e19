"""Grid-point executor shared by `run_experiment` and the deprecated
`sweep`/`sweep_many` shims: the port's counterpart of the reference's
`repro/experiments/execute.py`.

Three dispatch modes, every point on the port's slot engine:

  * 'megabatch' (the default): `megabatch.plan_megabatch` groups the
    grid by structure and flow bucket, and each group's (routing, NIC)
    sub-batches run as one slot loop each (on CUDA, replays of captured
    graphs).  Host prep is pipelined: after sub-batch j is dispatched,
    the host prepares sub-batch j+1 (`megabatch.prepare_planned`: flow
    arrays, fault timelines, ECMP replays, plan widths) while the device
    replays j's loop; then j is finalized and its rows delivered, and
    j+1 is dispatched.
  * 'group': the reference's legacy grouping (points equal but for their
    seeds), each group one `engine.dispatch_compiled_batch`.
  * 'serial': `run_point`, one point at a time.

What overlaps on CUDA and what does not: sub-batch j is finalized (a
device-to-host copy that waits for its loop) before j+1 is dispatched,
so two loops are never in flight together.  A capture also begins with
a device synchronize (`torch.cuda.graph`); a sub-batch whose structure
is in the graph cache (`netsim.graph.cached_loop`, e.g. on a second
run of a study in one process) captures nothing and so makes no
synchronize.  What overlaps is host work, the prep of j+1, with the
device running j.  The prep runs on the calling thread, between j's
dispatch and its finalize; no other thread makes a CUDA call, so no
capture sees one.

How it differs from the reference's executor: there is no process pool
(the port has no NumPy engine, a forked child cannot use the parent's
CUDA context, and the CPU path runs a grid as one megabatch too) and no
persistent compile cache (there is no XLA); `device`/`dtype`/`dispatch`
take the place of `processes`/`backend`/`jx_dispatch`, and a spec's
`sim.backend` selects nothing.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.netsim import engine, megabatch
from repro_torch.scenarios.compile import compile_scenario
from repro_torch.scenarios.runner import (ScenarioMetrics, distill_metrics,
                                          run_point)
from repro_torch.scenarios.spec import ScenarioSpec

OnResult = Callable[[int, ScenarioMetrics], None]

DISPATCH_MODES = ("megabatch", "group", "serial")

# the host and device walls of a megabatch sweep, summed over its loops
WALLS = ("compile_s", "prep_s", "operands_s", "capture_s", "replay_s",
         "loop_s", "finalize_s", "overlap_s")


def execute_points(points: List[ScenarioSpec], device=None, dtype=None,
                   dispatch: Optional[str] = None,
                   derive: Optional[Callable] = None,
                   on_result: Optional[OnResult] = None,
                   flight: Optional[Dict] = None
                   ) -> List[ScenarioMetrics]:
    """Run every point; returns metrics in point order.  `device`
    defaults to CUDA (and raises without a GPU; `device="cpu"` runs the
    plain path), `dtype` to float64.  `dispatch` is one of
    `DISPATCH_MODES` (None: 'megabatch').  `derive(spec, compiled,
    result) -> dict` adds per-run `extra` metrics.  `on_result(i, m)`
    fires once per point as its row is finalized, *before* the call
    returns.

    `flight`, when a dict, is filled with the executor's flight record:
    `device`, `dtype`, `mode`, `n_points`, `wall_s`, per-point walls
    (`points`: the points of one loop share its dispatch and finalize
    wall evenly), `pipeline` (megabatch: `groups`, `launches` (loops),
    `pipelined` (more than one loop, so prep and loops overlapped) and
    `loops`, one record of walls a loop, with `cached` True for a loop
    taken from the graph cache), `f32_overflows` (the float32
    bytes_total conditions its prep hit, `engine.f32_overflow_log`),
    `dispatch_stats` (this sweep's `engine.dispatch_stats()` delta:
    slot loops and CUDA graphs) and `walls` (megabatch: `WALLS` summed
    over the sweep; `loop_s` is device time between CUDA events on
    CUDA, the eager loop's wall on the CPU; `overlap_s` the host prep
    that ran while a loop was still on the device)."""
    mode = "megabatch" if dispatch is None else dispatch
    if mode not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch {mode!r}; expected one of "
                         f"{DISPATCH_MODES}")
    device = engine.resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    emit = on_result or (lambda i, m: None)
    t_start = time.perf_counter()
    stats0 = engine.dispatch_stats()
    n_overflows0 = len(engine.f32_overflow_log())
    results: List[Optional[ScenarioMetrics]] = [None] * len(points)
    point_walls: List[Dict] = []

    def deliver(i: int, c, r) -> None:
        m = distill_metrics(points[i], c, r)
        if derive is not None:
            m.extra.update(derive(points[i], c, r))
        results[i] = m
        emit(i, m)

    def record(idxs: List[int], wall_s: float) -> None:
        each = wall_s / max(len(idxs), 1)
        point_walls.extend({"index": i, "wall_s": each} for i in idxs)

    pipeline: Dict = {}
    walls: Dict = {}
    if mode == "megabatch":
        pipeline, walls = _execute_megabatch(points, device, dtype,
                                             deliver, record)
    elif mode == "group":
        _execute_groups(points, device, dtype, deliver, record)
    else:
        for i, p in enumerate(points):
            t0 = time.perf_counter()
            results[i] = run_point(p, device, dtype, derive)
            emit(i, results[i])
            record([i], time.perf_counter() - t0)
    if flight is not None:
        stats = engine.dispatch_stats()
        flight.update(
            {"device": str(device), "dtype": str(dtype), "mode": mode,
             "n_points": len(points),
             "wall_s": time.perf_counter() - t_start,
             "points": point_walls, "pipeline": pipeline,
             "f32_overflows": list(
                 engine.f32_overflow_log()[n_overflows0:]),
             "dispatch_stats": {k: stats[k] - stats0[k] for k in stats},
             "walls": walls})
    return results


def _execute_megabatch(points: List[ScenarioSpec], device, dtype,
                       deliver: Callable, record: Callable):
    """The pipelined megabatch sweep (see the module docstring).
    Returns `(pipeline, walls)` for the flight record."""
    walls = dict.fromkeys(WALLS, 0.0)
    t0 = time.perf_counter()
    compiled = [compile_scenario(p) for p in points]
    caches, planned = megabatch.plan_megabatch(compiled)
    walls["compile_s"] = time.perf_counter() - t0
    preps = (prep for group in planned
             for prep in megabatch.prepare_planned(group, caches, dtype))

    def prep_next():
        t = time.perf_counter()
        prep = next(preps, None)
        return prep, time.perf_counter() - t

    loops: List[Dict] = []
    nxt, prep_s = prep_next()
    while nxt is not None:
        timing: Dict = {}
        t = time.perf_counter()
        idxs, handle = megabatch.dispatch_prepared(nxt, caches, device,
                                                   dtype, timing)
        dispatch_s = time.perf_counter() - t
        # the next sub-batch's host prep, while this loop replays
        nxt, next_prep_s = prep_next()
        t = time.perf_counter()
        res = megabatch.finalize_group(handle)     # waits for the loop
        finalize_s = time.perf_counter() - t
        if "events" in timing:
            start, end = timing["events"]
            loop_s = start.elapsed_time(end) / 1e3
            # device work left when the host had queued every replay
            in_flight = max(0.0, loop_s - timing["replay_s"])
        else:
            loop_s, in_flight = timing["loop_s"], 0.0
        t = time.perf_counter()
        for i, r in zip(idxs, res):
            deliver(i, compiled[i], r)
        record(idxs, dispatch_s + finalize_s + time.perf_counter() - t)
        loop = {"points": len(idxs), "prep_s": prep_s,
                "operands_s": timing["operands_s"],
                "capture_s": timing.get("capture_s", 0.0),
                "cached": timing.get("cached", False),
                "replay_s": timing.get("replay_s", 0.0), "loop_s": loop_s,
                "finalize_s": finalize_s,
                "overlap_s": min(next_prep_s, in_flight)}
        loops.append(loop)
        for k in WALLS[1:]:
            walls[k] += loop[k]
        prep_s = next_prep_s
    pipeline = {"groups": len(planned), "launches": len(loops),
                "pipelined": len(loops) > 1, "loops": loops}
    return pipeline, walls


def _execute_groups(points: List[ScenarioSpec], device, dtype,
                    deliver: Callable, record: Callable) -> None:
    """The reference's 'group' path: points that are equal but for their
    seeds form one batch, each batch one `dispatch_compiled_batch`; all
    are dispatched, then finalized in turn."""
    order: List = []
    groups: Dict = {}
    for i, p in enumerate(points):
        key = replace(p, sim=replace(p.sim, seed=0, backend="numpy"),
                      workload_seed=0)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(i)
    dispatched = []
    for key in order:
        idxs = groups[key]
        compiled = [compile_scenario(points[i]) for i in idxs]
        dispatched.append((idxs, compiled, engine.dispatch_compiled_batch(
            compiled, device, dtype)))
    for idxs, compiled, handle in dispatched:
        t = time.perf_counter()
        for i, c, r in zip(idxs, compiled, engine.finalize_batch(handle)):
            deliver(i, c, r)
        record(idxs, time.perf_counter() - t)
