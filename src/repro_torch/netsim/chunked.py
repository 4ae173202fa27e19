"""Chunked flow streaming: the slot with its flow axis in chunks of
`EngineConfig.flow_chunk` flows, the counterpart of the reference's
`repro/netsim/jx/chunked.py`, so that a population whose per-flow
working set would not fit one device's budget still runs.

The slot takes three passes, each reading only the old carry (a slot
has no feedback within itself into the per-flow state, so the order of
the chunks cannot matter):

  1. **accumulate**: chunk by chunk, the chunk's plane split and one
     segment-sum launch that adds its offered and fabric rates into the
     running access, pair (AR/WAR) or link (ECMP) sums.  Each bucket
     continues its chain where the chunk before left it
     (`link_load.segment_sum_many` with `acc`), so the sums are those of
     one pass bit for bit, a non-divisible tail included (its pad flows
     are in no plan); the last chunk's launch also writes the access
     and (ECMP) link bottleneck scales of the finished sums;
  2. **link-level**: routing, bottleneck scales and queue updates
     (`engine._links`), with no flow axis;
  3. **emit**: chunk by chunk, the plane split again (the same values:
     every input is the old carry's), the chunk's fabric and access
     scaling, NIC update, stalls, completion and goodput sum
     (`engine._flows`), which are per flow.

The per-slot totals are one sum over every flow's achieved goodput (and,
under ECMP with failure reaction, over every (flow, plane)'s rate on a
dead path), taken over the flows before chunk padding (`n_in`) in one
reduction of the shape a pass without chunks reduces, so they too are
bit for bit those of one pass.  A chunk's intermediates are released
before the next chunk begins, so a captured slot's memory pool holds
about one chunk's working set beside the carry.

Not supported, as in the reference: dense aggregation (`ValueError`;
chunks exist to avoid its whole-run gather plans) and traces
(`NotImplementedError`; a trace records whole-run fields every slot),
refused by `engine._check_mode`.
"""
from __future__ import annotations

import torch

from . import engine
from .carry import SlotOperands
from .state import FlowBatch, NicCarry, SimCarry


def _ops_chunk(ops: SlotOperands, sl: slice) -> SlotOperands:
    """`ops` restricted to the flows `sl` (views of every per-flow
    field; the per-link, per-host and plan fields as they are)."""
    def rows(x):
        return None if x is None else x[..., sl, :]

    return ops._replace(
        fb=FlowBatch(*(x[..., sl] for x in ops.fb)),
        pair_idx=ops.pair_idx[..., sl], esr=rows(ops.esr),
        cross=rows(ops.cross), ecmp_up=rows(ops.ecmp_up),
        ecmp_down=rows(ops.ecmp_down), ecmp_up2=rows(ops.ecmp_up2),
        ecmp_down2=rows(ops.ecmp_down2))


def _carry_chunk(carry: SimCarry, sl: slice) -> SimCarry:
    """`carry` with its per-flow fields restricted to the flows `sl`
    (its queues whole)."""
    return carry._replace(
        nic=NicCarry(*(x[..., sl, :] for x in carry.nic)),
        remaining=carry.remaining[..., sl], done=carry.done[..., sl],
        completion=carry.completion[..., sl],
        goodput_sum=carry.goodput_sum[..., sl])


def slot(cfg: engine.EngineConfig, ops: SlotOperands, carry: SimCarry, t,
         seg: int, counted):
    """One slot of capacity segment `seg` in chunks of `ops.sparse.chunk`
    flows: `engine._slot`'s contract without a trace (`t` and `counted`
    host values or device tensors).  Returns `(next carry, total)` and
    under failure reaction the blackholed total."""
    sp = ops.sparse
    lead = tuple(ops.fb.demand.shape[:-1])
    ch = sp.chunk
    chunks = [slice(c * ch, (c + 1) * ch)
              for c in range(ops.fb.demand.shape[-1] // ch)]

    def offered(sl):
        return engine._offered(cfg, _ops_chunk(ops, sl),
                               _carry_chunk(carry, sl), t, seg)

    # pass 1: the chunks' rates folded into the running sums (the last
    # chunk's launch also writes the access and, under ECMP, link scales)
    acc = None
    for c, sl in enumerate(chunks):
        acc, scales = engine._sparse_sums(cfg, ops, *offered(sl), seg,
                                          chunk=c, acc=acc)
    # pass 2: the link half, no flow axis
    links = engine._links(cfg, ops, carry, seg,
                          engine._shape_sums(cfg, lead, acc, scales))
    del acc, scales

    # pass 3: the per-flow half, chunk by chunk
    parts = []
    for sl in chunks:
        fl = engine._flows(cfg, _ops_chunk(ops, sl), _carry_chunk(carry, sl),
                           t, seg, counted, *offered(sl), links)
        parts.append((fl.nic, fl.remaining, fl.done, fl.completion,
                      fl.goodput_sum, fl.achieved, fl.bh))
        del fl
    nic_parts, remaining, done, completion, goodput_sum, achieved, bh = \
        zip(*parts)
    del parts
    nic = NicCarry(*(torch.cat(x, -2) for x in zip(*nic_parts)))
    achieved = torch.cat(achieved, -1)
    fl = engine._Flows(nic, torch.cat(remaining, -1), torch.cat(done, -1),
                       torch.cat(completion, -1), torch.cat(goodput_sum, -1),
                       achieved, None, None, None, None)
    # totals over the flows before chunk padding, reduced as one pass
    # reduces them
    n = sp.n_in
    outs = (engine._lane_total(achieved[..., :n].contiguous(), 1),)
    if cfg.react:
        outs += (links.bh if bh[0] is None else engine._lane_total(
            torch.cat(bh, -2)[..., :n, :].contiguous(), 2),)
    return (engine._next_carry(links, fl),) + outs
