"""The `ShardCtx` threaded through the model forward and the train step,
the reference's logical-axis sharding rules, and the layout changes of
the activations under tensor parallelism.

The reference maps logical axes onto a JAX mesh (`DEFAULT_RULES`,
`spec_for_axes`, `param_shardings`) and constrains activations with
`with_sharding_constraint`, leaving the collectives to GSPMD.  This port
takes a `torch.distributed.device_mesh.DeviceMesh` with named dims
(`launch.mesh.make_mesh_for`) and the same rules:

  * data parallelism over the DP dims: the batch is tiled over them and
    the gradients are summed by the plane collective engine
    (`core.collectives.plane_allreduce`, through `ShardCtx.group`);
  * tensor parallelism over the model dim: a rank holds only its slice
    of every leaf the rules shard (`shard_params`, `gather_params`), and
    activations move between layouts through explicit collectives that
    carry their gradients (`parallel.tp`), where the reference's
    constraints stand: `gather_residual`, `reduce_residual` and
    `shard_residual` (sequence-parallel residual stream), the rank's
    heads (`head_range`, `local_part`), `shard_logits`, the caches
    (`cache_split`, `shard_cache`);
  * FSDP over one DP dim (`fsdp_axis`, with `make_rules(fsdp_axis)`):
    a rank holds its slice of every leaf whose spec names that dim, the
    forward gathers a block's such leaves right before the block
    (`fsdp_whole`, an all-gather whose backward is a reduce-scatter) and
    drops them after it, as the reference's ZeRO-3 layout does.

The TP path is taken whenever the context has a mesh, a model dim of 1
included, where every collective is a copy.  It covers every family:
standard attention, MLA and SSM blocks compute the heads of their rank
(`head_range`), reading each leaf's columns through `local_part`, which
joins the reference's parameter layout to the rank's compute layout.
Caches follow the reference's `shard_cache` rule (`cache_split`): a K/V
cache holds the rank's kv heads where they divide the model dim, else its
slots of the ring where the slots divide it; MLA's latent cache holds the
rank's slots.  A decode step attends over the rank's slots only and the
ranks' partial softmaxes are merged in rank order
(`models.attention.merge_partials`).

Gradients under TP: a replicated activation's gradient is kept partial,
each rank holding its own terms and the group's sum being the gradient
(`parallel.tp`); the train step seeds the loss with 1 / tp and sums the
gradient of every replicated leaf over the model group once, after
autograd (`train.loop.make_grad_fn`).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from . import tp as tpc

DEFAULT_RULES: Dict[str, Any] = {
    "embed": None,          # d_model: replicated
    "mlp": "model",         # FFN intermediate
    "heads": "model",       # attention heads
    "kv": "model",          # kv heads (may be fewer than model size -> None)
    "head": None,           # per-head dim
    "vocab": "model",       # embedding/vocab dim
    "embed_t": None,        # embedding-table d_model dim (never sharded)
    "experts": "model",     # MoE expert dim
    "embed_e": None,        # expert d_model dim (contracted; never FSDP)
    "mlp_e": None,          # expert FFN dim (FSDP-sharded when enabled)
    "qlora": None,
    "kvlora": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": "model",
    "layers": None,         # stacked-scan leading dim
    "ff_tokens": None,
}

def make_rules(fsdp_axis: Optional[str] = None) -> Dict[str, Any]:
    """The parameter rules; `fsdp_axis` also shards the 'embed' (d_model)
    and 'mlp_e' dims of the weights over a DP axis, as the reference's
    ZeRO-3 layout does."""
    rules = dict(DEFAULT_RULES)
    if fsdp_axis is not None:
        rules["embed"] = fsdp_axis
        rules["mlp_e"] = fsdp_axis
    return rules


def axis_size(mesh, name: str) -> int:
    """The size of the mesh dim `name`."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"mesh dims {names} have no {name!r}")
    return int(mesh.shape[names.index(name)])


def _rows(mesh, dims: Tuple[str, ...]) -> List[List[int]]:
    """The global ranks of every group over `dims`, one list a group, each
    in the reference's order: the coordinates on `dims` read as one
    row-major number (rank = pod x |data| + data)."""
    names = tuple(mesh.mesh_dim_names)
    idx = [names.index(d) for d in dims]
    rest = [i for i in range(len(names)) if i not in idx]
    n = int(np.prod([mesh.shape[i] for i in idx]))
    return mesh.mesh.permute(*rest, *idx).reshape(-1, n).tolist()


def mesh_group(mesh, dims: Tuple[str, ...]):
    """The process group over the mesh dims `dims`, flattened in the
    reference's order: a rank's index in it is its coordinates on `dims`
    read as one row-major number, as `P(("pod", "data"))` tiles a batch.

    One dim is the mesh's own group of that dim.  Several are one
    `new_group` for each combination of the other dims, created by every
    rank in one order (`new_group` is collective over the world).  The
    group's rank order is checked against the expected one, and a
    mismatch raises: `new_group` sorts its ranks, so a mesh whose ranks
    do not run row-major over `dims` would tile the batch in another
    order than the reference's."""
    import torch.distributed as dist
    rows = _rows(mesh, tuple(dims))
    me = dist.get_rank()
    if len(dims) == 1:
        group = mesh.get_group(dims[0])
    else:
        group = None
        for row in rows:
            g = dist.new_group(row)
            if me in row:
                group = g
    want = next(row for row in rows if me in row)
    got = dist.get_process_group_ranks(group)
    if list(got) != want:
        raise RuntimeError(
            f"the group over {tuple(dims)} orders its ranks {got}; the "
            f"reference's order is {want}")
    return group


@dataclass(frozen=True)
class ShardCtx:
    """Distribution context threaded through model apply functions.

    `mesh` is None (one rank) or a `DeviceMesh` with named dims: the
    batch is tiled over `dp_axes`, the leaves and activations the rules
    shard are split over `tp_axis`, and the residual stream is split
    along the sequence when `seq_sharded` (and the sequence divides the
    model dim).  `fsdp_axis`, one of `dp_axes` or None, is the DP dim
    whose ranks split the weights (FSDP; its rules are
    `make_rules(fsdp_axis)`)."""
    mesh: Optional[Any] = None
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    seq_sharded: bool = True          # sequence-parallel residual stream
    fsdp_axis: Optional[str] = None
    rules: Dict[str, Any] = field(default_factory=lambda: dict(DEFAULT_RULES))
    # the process groups `group` made, by dims (not a field of the
    # context's value: two contexts over one mesh compare equal)
    _groups: Dict[Tuple[str, ...], Any] = field(
        default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if self.mesh is None:
            return
        if self.fsdp_axis is not None and self.fsdp_axis not in \
                self.dp_axes:
            raise ValueError(f"FSDP axis {self.fsdp_axis!r} is not one of "
                             f"the DP axes {self.dp_axes}")
        for a in self.dp_axes + (self.tp_axis,):
            axis_size(self.mesh, a)

    @property
    def plane_axes(self) -> Tuple[str, ...]:
        """DP axes the plane collective engine synchronizes explicitly
        (the reference's: the DP axes but the FSDP one)."""
        return tuple(a for a in self.dp_axes if a != self.fsdp_axis)

    @property
    def tp_size(self) -> int:
        if self.mesh is None:
            return 1
        return axis_size(self.mesh, self.tp_axis)

    @property
    def fsdp_size(self) -> int:
        """The size of the FSDP dim (1 without one or without a mesh)."""
        if self.mesh is None or self.fsdp_axis is None:
            return 1
        return axis_size(self.mesh, self.fsdp_axis)

    @property
    def fsdp_group(self):
        """The process group of this rank's FSDP dim."""
        return self.group((self.fsdp_axis,))

    @property
    def dp_spec(self):
        return tuple(self.dp_axes) if len(self.dp_axes) > 1 else \
            self.dp_axes[0]

    @property
    def tp_group(self):
        """The process group of this rank's model dim."""
        return self.group((self.tp_axis,))

    @property
    def tp_rank(self) -> int:
        """This rank's coordinate on the model dim (0 without a mesh)."""
        if self.mesh is None:
            return 0
        return int(self.mesh.get_local_rank(self.tp_axis))

    def with_seq(self, seq_sharded: bool) -> "ShardCtx":
        return replace(self, seq_sharded=seq_sharded, _groups=self._groups)

    def group(self, dims: Tuple[str, ...]):
        """The process group over the mesh dims `dims` (`mesh_group`),
        made once a context; every rank must ask for it together the
        first time."""
        dims = tuple(dims)
        if dims not in self._groups:
            self._groups[dims] = mesh_group(self.mesh, dims)
        return self._groups[dims]

    def splits(self, axis: str, n: int) -> bool:
        """Whether a dim of logical axis `axis` and size `n` is split over
        the model dim (`spec_for_axes`'s rule)."""
        return (self.mesh is not None and
                self.rules.get(axis) == self.tp_axis and
                n % self.tp_size == 0)

    def local_range(self, n: int) -> Tuple[int, int]:
        """(start, size) of this rank's even share of a dim of size `n`
        split over the model dim."""
        size = n // self.tp_size
        return self.tp_rank * size, size


def local_ctx() -> ShardCtx:
    return ShardCtx(mesh=None)


# ---------------------------------------------------------------------------
# parameter sharding
# ---------------------------------------------------------------------------

class Spec(tuple):
    """A leaf's layout, the reference's `PartitionSpec`: one mesh-dim name
    or None a dim, with the mesh it names in `mesh` (None without one)."""

    def __new__(cls, entries=(), mesh=None):
        spec = super().__new__(cls, entries)
        spec.mesh = mesh
        return spec

    def __repr__(self):
        return f"Spec{tuple(self)}"


def spec_for_axes(axes: Tuple[str, ...], ctx: ShardCtx,
                  shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """Logical axes -> Spec, dropping shardings that don't divide; a mesh
    dim appears at most once a spec (the reference's rule)."""
    out = []
    for i, ax in enumerate(axes):
        mesh_ax = ctx.rules.get(ax)
        if mesh_ax is None or ctx.mesh is None:
            out.append(None)
            continue
        size = axis_size(ctx.mesh, mesh_ax)
        if shape is not None and shape[i] % size != 0:
            out.append(None)        # e.g. kv=1 (MQA) cannot shard 16-way
        else:
            out.append(mesh_ax)
    seen = set()
    for i, ax in enumerate(out):
        if ax is None:
            continue
        if ax in seen:
            out[i] = None
        seen.add(ax)
    return Spec(out, ctx.mesh)


def _walk(fn, tree, *others):
    """`tree` (dicts and lists; a tuple is a leaf) with each leaf replaced
    by `fn(leaf, *the same leaf of others)`."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v, *(o[i] for o in others))
                for i, v in enumerate(tree)]
    return fn(tree, *others)


def spec_leaves(specs) -> List[Spec]:
    """The specs of a tree in `jax.tree.leaves` order (dict keys sorted)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for x in specs for s in spec_leaves(x)]
    return [specs]


def param_shardings(axes_tree, ctx: ShardCtx, shapes_tree=None):
    """A tree of `Spec`s mirroring the parameter tree: each leaf's logical
    axes (`logical_axes`) through `spec_for_axes`, with its shape from
    `shapes_tree` (anything with `.shape`, e.g. `param_shapes`)."""
    if shapes_tree is None:
        return _walk(lambda a: spec_for_axes(tuple(a), ctx), axes_tree)
    return _walk(lambda a, s: spec_for_axes(tuple(a), ctx, tuple(s.shape)),
                 axes_tree, shapes_tree)


def full_shape(shape, spec: Spec) -> Tuple[int, ...]:
    """The whole leaf's shape of a rank's slice of `shape`."""
    return tuple(n * axis_size(spec.mesh, name) if name else n
                 for n, name in zip(shape, spec))


def local_slice(x, spec: Spec):
    """This rank's slice of the whole leaf `x` under `spec` (a copy)."""
    for i, name in enumerate(spec):
        if name:
            n = x.shape[i] // axis_size(spec.mesh, name)
            x = x.narrow(i, spec.mesh.get_local_rank(name) * n, n)
    return x.clone()


def shard_params(full_tree, shardings):
    """Each rank's local slice of every leaf of `full_tree`, by its spec
    in `shardings` (`param_shardings`)."""
    return _walk(local_slice, full_tree, shardings)


def gather_params(local_tree, shardings):
    """The whole tree from every rank's slices (`shard_params`'s
    inverse), gathered over each sharded dim's group on every rank."""
    import torch
    import torch.distributed as dist

    def gather(x, spec):
        for i, name in enumerate(spec):
            if name:
                group = spec.mesh.get_group(name)
                parts = [torch.empty_like(x)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, x.contiguous(), group=group)
                x = torch.cat(parts, dim=i)
        return x
    return _walk(gather, local_tree, shardings)


def leaf_specs(init, cfg, ctx: ShardCtx) -> Dict[str, Spec]:
    """The spec of every leaf `init(make, cfg, prefix)` builds (one
    mixer's leaves, as a period's leaves are after their stacked dim is
    sliced off): each leaf's logical axes and shape through
    `spec_for_axes`, as `param_specs` gives them."""
    return init(lambda name, shape, axes, scale: spec_for_axes(
        tuple(axes), ctx, tuple(shape)), cfg, "")


def names_dim(spec: Spec, name: Optional[str]) -> bool:
    """Whether `spec` splits some dim of its leaf over the mesh dim
    `name` (False for None)."""
    return name is not None and name in tuple(spec)


def fsdp_whole(tree, specs, ctx: ShardCtx):
    """`tree` (a block's leaves, or any subtree) with every leaf whose
    spec names the FSDP dim gathered whole along that dim over the FSDP
    group: an all-gather forward, a reduce-scatter of the gradient
    backward (each rank gets its own slice's gradient, summed over the
    FSDP ranks).  `specs` may carry a leading dim more than the leaves
    (the stacked "layers" dim of a period's leaves, sliced off here).
    Leaves FSDP does not split are returned as they are."""
    if ctx.mesh is None or ctx.fsdp_axis is None:
        return tree

    def whole(x, spec):
        spec = tuple(spec)[len(spec) - x.ndim:]
        if not names_dim(spec, ctx.fsdp_axis):
            return x
        return tpc.gather(x, spec.index(ctx.fsdp_axis), ctx.fsdp_group)
    return _walk(whole, tree, specs)


def local_part(leaf, spec: Spec, dim: int, start: int, size: int,
               ctx: ShardCtx, even: bool = False):
    """The columns [start, start + size) along `dim` of the whole leaf
    (whole in every other dim), of which this rank holds its slice under
    `spec` (the model dim's entries; FSDP's are gathered before a block
    runs, `fsdp_whole`).

    Where the rank's held slice is exactly those columns it is returned
    as it is; where the leaf is whole, narrowed.  Otherwise the leaf is
    gathered whole over the model group (`tp.gather` along each dim the
    model dim splits) and narrowed: the backward reduce-scatters the
    gradient, so each rank gets its own slice's gradient, complete.  The
    reference's spec of a leaf need not be the columns a rank computes
    (an SSM's conv weight is split along its width, its bias evenly over
    all channels, its heads' columns half a head a rank when the heads
    do not divide the model dim).

    Every rank of the group must issue the same collectives, so the held
    slice is taken as it is only for an `even` range: the caller's word
    that every rank asks for its own share of one size (a rank's heads
    where the heads divide the model dim), which is then every rank's
    held slice or none's.  Any other range (a range of padded heads, or
    one every rank reads alike, e.g. an SSM's B/C channels) is gathered
    on every rank."""
    n = leaf.shape[dim]
    split = [i for i, name in enumerate(spec) if name == ctx.tp_axis]
    if ctx.mesh is not None and split:
        if (even and split == [dim] and size == n and
                start == ctx.tp_rank * n):
            return leaf
        for i in split:
            leaf = tpc.gather(leaf, i, ctx.tp_group)
    if start == 0 and size == leaf.shape[dim]:
        return leaf
    return leaf.narrow(dim, start, size)


# ---------------------------------------------------------------------------
# activation layouts
# ---------------------------------------------------------------------------

def seq_split(seq_len: int, ctx: ShardCtx) -> bool:
    """Whether the residual stream of a sequence of `seq_len` is split
    along the sequence over the model dim (the reference's
    `shard_residual` rule)."""
    m = ctx.tp_size
    return (ctx.mesh is not None and ctx.seq_sharded and
            seq_len % m == 0 and seq_len >= m)


def shard_residual(x, ctx: ShardCtx):
    """(B, S, D) whole on every rank -> the residual layout: this rank's
    sequence slice when sequence-parallel (autograd's narrow, whose
    backward pads with zeros: the gradient of the whole stays partial),
    else as it is."""
    if not seq_split(x.shape[1], ctx):
        return x
    start, size = ctx.local_range(x.shape[1])
    return x.narrow(1, start, size)


def gather_residual(x, ctx: ShardCtx, seq_len: int):
    """The residual layout of a sequence of `seq_len` -> (B, S, D) whole
    on every rank: an all-gather along S when sequence-parallel."""
    if not seq_split(seq_len, ctx):
        return x
    return tpc.gather(x, 1, ctx.tp_group)


def reduce_residual(x, ctx: ShardCtx):
    """(B, S, D) partial sums (a row-parallel product's terms) -> their
    sum in the residual layout: a reduce-scatter along S when
    sequence-parallel, else an all-reduce."""
    if ctx.mesh is None:
        return x
    if seq_split(x.shape[1], ctx):
        return tpc.reduce_scatter(x, 1, ctx.tp_group)
    return tpc.reduce(x, ctx.tp_group)


def head_range(n_heads: int, ctx: ShardCtx) -> Tuple[int, int]:
    """(start, count) of this rank's heads of `n_heads`.  The reference
    pads the heads to a multiple of the model dim with zero heads (whose
    `wo` rows are zero) and splits them evenly; a rank here takes the
    same range and leaves the padded heads out, since they add exactly
    0.  The count may be 0 on the last ranks."""
    if ctx.mesh is None:
        return 0, n_heads
    tp = ctx.tp_size
    per = (n_heads + (-n_heads % tp)) // tp
    start = ctx.tp_rank * per
    return start, max(0, min(per, n_heads - start))


def group_reads(start: int, count: int, per: int):
    """The groups heads [start, start + count) read, head h reading group
    h // `per` (a GQA group's kv head, an SSM head's B/C group), in the
    form the attention kernels and `ssd_scan` take: a list `g` with head
    start + j reading g[j // (count // len(g))] -- the runs of equal
    groups where they are of one length, else one entry a head."""
    reads = [h // per for h in range(start, start + count)]
    if not reads:
        return reads
    runs = [reads[0]]
    for a, b in zip(reads, reads[1:]):
        if b != a:
            runs.append(b)
    if count % len(runs) == 0 and reads == [
            runs[j // (count // len(runs))] for j in range(count)]:
        return runs
    return reads


def shard_logits(x, ctx: ShardCtx, vocab: int):
    """(B, S, V') logits -> the whole vocab `vocab` on every rank: an
    all-gather along V where the model dim splits the vocab (each rank
    computed its slice), else as they are (computed whole)."""
    if not ctx.splits("vocab", vocab):
        return x
    return tpc.gather(x, x.ndim - 1, ctx.tp_group)


def cache_kv_heads(n_kv: int, ctx: ShardCtx) -> int:
    """The kv heads a rank's K/V cache holds: its share when the kv heads
    divide the model dim, else all of them."""
    return n_kv // ctx.tp_size if ctx.splits("kv", n_kv) else n_kv


class CacheSplit(NamedTuple):
    """How a rank holds a cache (`cache_split`): `axis` is "heads" (its
    kv heads), "slots" (its slots [start, start + size) of the ring) or
    "whole"."""
    axis: str
    start: int
    size: int


def cache_split(slots: int, ctx: ShardCtx,
                kv_heads: Optional[int] = None) -> CacheSplit:
    """The reference's `shard_cache` rule for a cache of a ring of
    `slots` (its global S) with `kv_heads` kv heads: "heads" where the
    model dim splits the kv heads; else "slots", the rank's even share of
    the ring, where `slots % tp == 0 and slots >= tp`; else "whole".
    `kv_heads` None is MLA's latent cache (`ckv`, `kr`), which the
    reference splits along S only.  A cache's positions (`pos`) follow
    its slots.  Shapes and the context in, ranges out: no tensor."""
    if ctx.mesh is None:
        return CacheSplit("whole", 0, slots)
    if kv_heads is not None and ctx.splits("kv", kv_heads):
        return CacheSplit("heads", 0, slots)
    tp = ctx.tp_size
    if slots % tp == 0 and slots >= tp:
        return CacheSplit("slots", *ctx.local_range(slots))
    return CacheSplit("whole", 0, slots)


def shard_cache(x, ctx: ShardCtx, kv_heads_axis: int = 2):
    """A whole K or V cache (..., S, Hkv, D) -> this rank's part by
    `cache_split`: its kv heads, or the whole.  A split along S raises:
    a rank's slots need the ring's size beside them (the cache's "ring"
    leaf), so a whole cache is cut along S by `models.shard_caches`."""
    split = cache_split(x.shape[kv_heads_axis - 1], ctx,
                        x.shape[kv_heads_axis])
    if split.axis == "whole":
        return x
    if split.axis == "slots":
        raise ValueError("a K/V leaf split along S alone loses its ring's "
                         "size: cut the cache with models.shard_caches")
    start, size = ctx.local_range(x.shape[kv_heads_axis])
    return x.narrow(kv_heads_axis, start, size).clone()
