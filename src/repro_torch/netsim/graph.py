"""The slot loop captured as CUDA graphs: the port's counterpart of
`repro/netsim/jx/engine.py::_jitted`, which compiles `_simulate`'s
`lax.scan` over slots into one XLA program.

`SlotLoop` runs a slot step as a function of device state only, as the
reference's scan body is a function of its carry and traced slot:

  * the carry lives in static buffers that every slot reads and then
    overwrites with its successor (one `copy_` a field; a field the
    step hands back unchanged is the buffer itself and costs nothing);
  * the slot `t` is a 0-d int64 tensor on the device that the loop
    itself advances, so the step's uses of `t` (a flow's start slot,
    the completion slot, the swlb probe deadline) read it there;
  * whether a slot counts toward the post-warmup goodput is a (T,)
    table on the device, indexed by `t`;
  * each slot's total goodput is written into a (T,) buffer at `t`.

Only the capacity segment stays on the host: the step takes it as a
Python int, so each segment's operands are plain views and a graph is
captured per segment (no gather of a segment's snapshot per slot).

On CUDA, `capture` runs slot 0 eagerly on a side stream (the real slot
0; it also loads the kernel library and warms the allocator), then
captures one graph per segment that slots 1..T-1 use, all in one
memory pool; `replay` replays them slot by slot.  Nothing in `replay`
reads the device on the host.  A failed capture or replay raises; there
is no fallback to the eager loop.  `run` takes the same steps without
capture, which is how the structure is tested on the CPU.

`kernels.build` counts a kernel launch when it happens: a call outside
a capture counts at once, a call inside one is recorded, and every
replay of the graph counts what its capture recorded.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Sequence

import numpy as np
import torch

from repro_torch.kernels import build


def _leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nest of NamedTuples, in field order."""
    for x in tree:
        if isinstance(x, torch.Tensor):
            yield x
        else:
            yield from _leaves(x)


def _clone(tree):
    return type(tree)(*(x.clone() if isinstance(x, torch.Tensor)
                        else _clone(x) for x in tree))


class SlotLoop:
    """`step(carry, t, seg, counted) -> (next carry, total)` runs one
    slot of capacity segment `seg` (a Python int); `t` is the loop's 0-d
    int64 slot tensor and `counted` a (1,) bool tensor, both on the
    carry's device.  `seg_id` maps each slot to its segment and
    `counted` each slot to whether it counts (host arrays of length T).
    `carry0` is copied into the static buffers, so the caller's tensors
    are never written."""

    def __init__(self, step: Callable, carry0, seg_id: Sequence[int],
                 counted: Sequence[bool]):
        self._step = step
        self.seg_id = [int(s) for s in seg_id]
        self.carry = _clone(carry0)
        self.device = device = next(_leaves(self.carry)).device
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        self.counted = torch.as_tensor(np.asarray(counted, dtype=bool),
                                       device=device)
        self.totals = torch.empty(len(self.seg_id),
                                  dtype=self.carry.goodput_sum.dtype,
                                  device=device)
        # segment -> (graph, launches its capture recorded)
        self.graphs: Dict[int, tuple] = {}

    def step(self, seg: int) -> None:
        """Slot `t` of segment `seg` on the static buffers; advances
        `t`."""
        t = self.t.view(1)
        new, total = self._step(self.carry, self.t, seg,
                                self.counted.index_select(0, t))
        self.totals.index_copy_(0, t, total.view(1))
        for dst, src in zip(_leaves(self.carry), _leaves(new)):
            dst.copy_(src)
        self.t += 1

    def run(self) -> None:
        """Every slot, step by step, without capture."""
        for seg in self.seg_id:
            self.step(seg)

    def capture(self) -> None:
        """CUDA: slot 0 eagerly, then one graph per segment of slots
        1..T-1.  Raises if a capture fails."""
        if not self.seg_id:
            return
        build.library()              # build and load before any capture
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.step(self.seg_id[0])
            torch.cuda.current_stream().wait_stream(side)
            pool = torch.cuda.graph_pool_handle()
            for seg in sorted(set(self.seg_id[1:])):
                graph = torch.cuda.CUDAGraph()
                before = dict(build.RECORDED)
                with torch.cuda.graph(graph, pool=pool):
                    self.step(seg)
                self.graphs[seg] = (graph, {k: n - before[k] for k, n in
                                            build.RECORDED.items()})

    def replay(self) -> None:
        """CUDA: slots 1..T-1 from the captured graphs, on the current
        stream, without a host sync."""
        with torch.cuda.device(self.device):
            for seg in self.seg_id[1:]:
                graph, launches = self.graphs[seg]
                graph.replay()
                build.count_replay(launches)
