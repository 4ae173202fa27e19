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
  * each slot's total goodput is written into a (T,) buffer at `t`, and
    so, under failure reaction, is its blackholed total (a second
    per-slot series); a batch's series are (T, B);
  * with a trace, each recorded field has a static (n_rec + 1, ...)
    buffer and a (T,) device table maps each slot to its record row,
    or to the scratch row `n_rec` for a slot that is not recorded, so
    every slot writes its row by `index_copy_` and no slot branches on
    `t` on the host.

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

The graph cache (`cached_loop`) is the counterpart of the reference's
`_JIT_CACHE`: it keeps a `SlotLoop`, its graphs and its own copy of the
operands per structure, and on a hit rebinds them to the new values
(`copy_` into the entry's buffers on the current stream, `t` back to 0,
series and records zeroed) instead of capturing anew; see
`cached_loop` for the key and the bounds.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, List, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build


def _leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nest of tuples (NamedTuples included), in order,
    a tensor that appears twice yielded twice; other leaves (None, such
    as a leaf-spine carry's stage-B queues, ints, host arrays) have
    none."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)


def _clone_tree(tree, memo: Dict[int, torch.Tensor]):
    """`tree` with each tensor cloned once (a tensor that appears twice
    stays one tensor: `memo` maps id to clone) and its other leaves as
    they are."""
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            memo[id(tree)] = tree.clone()
        return memo[id(tree)]
    if isinstance(tree, tuple):
        items = [_clone_tree(x, memo) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def structure(tree) -> tuple:
    """Everything of a nest of tuples but the values of its tensors, as a
    hashable key: each tensor's shape, dtype, device and the position of
    its first appearance (tensors that are one tensor stay one), each
    host array's shape, dtype and bytes, each other leaf's type and
    value, each tuple's type."""
    seen: Dict[int, int] = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            first = seen.setdefault(id(x), len(seen))
            return ("tensor", tuple(x.shape), x.dtype, x.device, first)
        if isinstance(x, tuple):
            return (type(x).__name__,) + tuple(walk(y) for y in x)
        if isinstance(x, np.ndarray):
            return ("array", x.shape, x.dtype.str, x.tobytes())
        return (type(x).__name__, x)
    return walk(tree)


def _nbytes(tensors) -> int:
    """Bytes of the storages under `tensors`, each storage once."""
    storages = {}
    for x in tensors:
        st = x.untyped_storage()
        storages[(x.device, st.data_ptr())] = st.nbytes()
    return sum(storages.values())


class SlotLoop:
    """`step(carry, t, seg, counted) -> (next carry, total, *more)` runs
    one slot of capacity segment `seg` (a Python int); `t` is the loop's
    0-d int64 slot tensor and `counted` a (1,) bool tensor, both on the
    carry's device.  `total` and each of the `n_series - 1` further 0-d
    outputs (the blackholed total under failure reaction) land at `t` in
    a (T, ...) buffer of `series` (the outputs' shape: () for a point,
    (B,) for a batch).  The step's outputs after those are the records,
    one a `record_like` (shape, dtype): each lands in row
    `record_rows[t]` (-1: not recorded) of a buffer of `record_like[k]`
    with `n_rec + 1` rows; a slot that is not recorded writes the last,
    the scratch row, which `records` leaves out.
    `seg_id` maps each slot to its segment and `counted` each slot to
    whether it counts (host arrays of length T).  `carry0` is copied
    into the static buffers, so the caller's tensors are never
    written."""

    def __init__(self, step: Callable, carry0, seg_id: Sequence[int],
                 counted: Sequence[bool], n_series: int = 1,
                 record_rows: Optional[Sequence[int]] = None,
                 record_like: Sequence[Tuple[tuple, torch.dtype]] = ()):
        self._step = step
        self.seg_id = [int(s) for s in seg_id]
        self.carry = _clone_tree(carry0, {})
        self.device = device = next(_leaves(self.carry)).device
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        self.counted = torch.as_tensor(np.asarray(counted, dtype=bool),
                                       device=device)
        lanes = tuple(self.carry.goodput_sum.shape[:-1])
        self.series = [torch.empty((len(self.seg_id),) + lanes,
                                   dtype=self.carry.goodput_sum.dtype,
                                   device=device)
                       for _ in range(n_series)]
        self.n_rec = 0
        self._records: List[torch.Tensor] = []
        if record_like:
            rows = np.asarray(record_rows, dtype=np.int64)
            if rows.shape != (len(self.seg_id),):
                raise ValueError("record_rows: one row a slot")
            self.n_rec = int(rows.max()) + 1
            self.rows = torch.as_tensor(
                np.where(rows < 0, self.n_rec, rows), device=device)
            self._records = [torch.zeros((self.n_rec + 1,) + tuple(shape),
                                         dtype=dtype, device=device)
                             for shape, dtype in record_like]
        # segment -> (graph, launches its capture recorded)
        self.graphs: Dict[int, tuple] = {}

    @property
    def totals(self) -> torch.Tensor:
        """(T,) total goodput of each slot ((T, B) for a batch)."""
        return self.series[0]

    @property
    def records(self) -> List[torch.Tensor]:
        """The recorded rows of each record buffer, scratch row
        dropped: (n_rec, ...) views."""
        return [buf[:self.n_rec] for buf in self._records]

    def step(self, seg: int) -> None:
        """Slot `t` of segment `seg` on the static buffers; advances
        `t`."""
        t = self.t.view(1)
        new, *outs = self._step(self.carry, self.t, seg,
                                self.counted.index_select(0, t))
        n = len(self.series)
        if len(outs) != n + len(self._records):
            raise ValueError(f"step: {len(outs)} outputs, expected {n} "
                             f"series and {len(self._records)} records")
        for buf, out in zip(self.series, outs[:n]):
            buf.index_copy_(0, t, out.unsqueeze(0))
        if self._records:
            row = self.rows.index_select(0, t)
            for buf, out in zip(self._records, outs[n:]):
                buf.index_copy_(0, row, out.unsqueeze(0))
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

    def replay(self, first: bool = False) -> None:
        """CUDA: slots 1..T-1 from the captured graphs, on the current
        stream, without a host sync; with `first` (a rebound loop, whose
        slot 0 `capture` has not run) slot 0 too, by its segment's graph
        where one was captured, else eagerly."""
        with torch.cuda.device(self.device):
            if first and self.seg_id:
                if self.seg_id[0] in self.graphs:
                    graph, launches = self.graphs[self.seg_id[0]]
                    graph.replay()
                    build.count_replay(launches)
                else:
                    self.step(self.seg_id[0])
            for seg in self.seg_id[1:]:
                graph, launches = self.graphs[seg]
                graph.replay()
                build.count_replay(launches)

    def reset(self, carry0) -> None:
        """Back to slot 0 from `carry0` (copied into the static buffers),
        with the series and records zeroed; the graphs stay."""
        for dst, src in zip(_leaves(self.carry), _leaves(carry0)):
            dst.copy_(src)
        self.t.zero_()
        for buf in self.series + self._records:
            buf.zero_()

    def buffers(self) -> Iterator[torch.Tensor]:
        """The loop's own tensors: carry, slot, tables, series,
        records."""
        yield from _leaves(self.carry)
        yield from (self.t, self.counted)
        if self._records:
            yield self.rows
        yield from self.series
        yield from self._records

    def release(self) -> None:
        """Drop the graphs and so their memory pool, once the device has
        finished what was queued (CUDA), so that no queued replay reads
        memory that is handed out again."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for graph, _ in self.graphs.values():
            graph.reset()
        self.graphs.clear()


# the graph cache's bounds: entries, and bytes of their buffers
GRAPH_CACHE_ENTRIES = 64
GRAPH_CACHE_BYTES = 2 << 30


class _Entry:
    """A cached loop and the operands its step reads."""

    def __init__(self, loop: SlotLoop, operands):
        self.loop = loop
        self.operands = operands
        self.nbytes = _nbytes(list(_leaves(operands))
                              + list(loop.buffers()))


_CACHE: "OrderedDict[tuple, _Entry]" = OrderedDict()
_CACHE_STATS = {"hits": 0, "misses": 0}


def cached_loop(key, operands, carry0,
                make: Callable[[Any, Any], SlotLoop]
                ) -> Tuple[SlotLoop, bool]:
    """A `SlotLoop` for `operands` from `carry0`, and whether it came
    from the cache.  The entry is looked up under `(key,
    structure((operands, carry0)))`: the caller's `key` names what the
    step is built from besides the operands (the engine's config, trace
    spec and device), `structure` every shape, dtype, device, host
    array (the slot→segment map) and non-tensor leaf (a plan's width,
    the chunk length) of the operands and the carry.  Deliberately left
    out: tensor values (they are what a hit rebinds) and strides (the
    entry's own copies are what the step reads).

    A hit copies `operands`' tensors into the entry's own and `carry0`
    into its static carry, and `reset`s the loop: run it (CPU) or
    `replay(first=True)` it (CUDA; nothing is captured).  A miss clones
    `operands` (each tensor once), builds the loop with `make(own
    operands, carry0)` and stores it: `capture` and `replay` it (CUDA)
    or run it.  Each call's copies are queued on the current stream
    after whatever that stream holds, so an entry rebound while an
    earlier replay of it is queued waits for it; the caller takes its
    results off the entry's buffers (`engine._simulate` clones them)
    before the next call of the structure.

    Bounds: at most `GRAPH_CACHE_ENTRIES` entries and
    `GRAPH_CACHE_BYTES` bytes of their buffers (operands, carry, series,
    records; not the graphs' memory pools, which hold a slot's
    intermediates), least recently used out first; an entry over the
    byte bound alone is built but not kept.  Eviction waits for the
    device and releases the entry's graphs and pool.  The library's 93
    points (35 loops) leave 35 entries, 16.5 MiB of buffers and 100 MiB
    of reserved pool memory; the sweep's peak allocation is 16.7 MiB
    from an empty cache and 21.5 MiB on a second pass, against 7.9 MiB
    without the cache (NVIDIA H100 80GB HBM3, `chip_smoke.py`'s sweep
    phase).  The cache is the
    process's, as the reference's is, and is used from one thread at a
    time (the executor dispatches from its calling thread)."""
    full = (key, structure((operands, carry0)))
    entry = _CACHE.get(full)
    if entry is not None:
        _CACHE.move_to_end(full)
        for dst, src in zip(_leaves(entry.operands), _leaves(operands)):
            dst.copy_(src)
        entry.loop.reset(carry0)
        _CACHE_STATS["hits"] += 1
        return entry.loop, True
    _CACHE_STATS["misses"] += 1
    own = _clone_tree(operands, {})
    entry = _Entry(make(own, carry0), own)
    if entry.nbytes <= GRAPH_CACHE_BYTES:
        _CACHE[full] = entry
        while len(_CACHE) > GRAPH_CACHE_ENTRIES or \
                _cache_bytes() > GRAPH_CACHE_BYTES:
            _CACHE.popitem(last=False)[1].loop.release()
    return entry.loop, False


def _cache_bytes() -> int:
    return sum(e.nbytes for e in _CACHE.values())


def graph_cache_stats() -> Dict[str, int]:
    """`entries` and `bytes` (of their buffers) the graph cache holds,
    and its `hits` and `misses` since it was last cleared."""
    return dict(entries=len(_CACHE), bytes=_cache_bytes(), **_CACHE_STATS)


def clear_graph_cache() -> None:
    """Release every entry (graphs, pools, buffers) and zero the
    counts."""
    while _CACHE:
        _CACHE.popitem(last=False)[1].loop.release()
    _CACHE_STATS.update(hits=0, misses=0)
