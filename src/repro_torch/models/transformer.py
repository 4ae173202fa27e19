"""The LM: embeddings -> prefix layers -> pattern periods -> head.

The parameter tree keeps the reference's nested dicts and lists and its
stacked `period` leaves, so a leaf's key path, shape and dtype are the
reference's, and its leaves come in `jax.tree.leaves` order
(`tree_leaves`: dict keys sorted, lists in order).  That order and that
stacking decide how the plane-sharded gradient sync chunks the model
(`core.collectives.stream_report` cuts each leaf along axis 0), so the
training-step schedule (`repro_torch.comms`) reads its gradient bytes
from `param_shapes`, which holds no memory.  `params_from_jax` carries
the reference's weights across, bit for bit.

The forward runs eagerly: `backbone` loops over the periods with views
of the stacked leaves (`a[i]`) where the reference runs `lax.scan`, and
the caches of a pattern position are stacked again after the loop.
`loss_fn` is differentiable (autograd; the attention kernels carry
their own backward on CUDA).  The reference's `_remat_wrap` wraps each
period in `jax.checkpoint`; here each period of a differentiated
forward goes through non-reentrant `torch.utils.checkpoint` under
`cfg.remat`: "full" keeps only the period's inputs, so the backward runs
the period's forward again, kernels included; "dots" and "kv" are
selective checkpoints (`create_selective_checkpoint_contexts`) whose
policies save what the reference's do and recompute the rest: "dots"
the outputs of matrix products without batch dims (JAX's
`dots_with_no_batch_dims_saveable`), "kv" only K and V as
`attention.kv_tag` marks them; "none" keeps every activation.  A
policy sees only aten ops (and the tag): the attention kernels' ctypes
launches write into `torch.empty` outputs that no policy saves, so the
recomputed launch writes fresh ones.  `cfg.scan_layers` and
`cfg.unroll_loops` shape what XLA traces (one scanned body or an
unrolled stack) and have nothing to do here.  Cross-entropy is taken in sequence chunks
(`chunked_ce_loss`), so (B, S, vocab) logits are never whole.  The
caches are written functionally, as the reference's are: a step returns
new cache tensors and leaves its input caches as they were, which the
serving engine relies on when it keeps the other slots' rows.

Under a mesh (`parallel.sharding`) the tree holds the rank's slices
(`param_specs`, `shard_params`), the embedded input enters the residual
layout, the CE is vocab-parallel where the model dim splits the vocab
(`_nll`), and `prefill_step`/`decode_step` gather the logits over the
vocab, so a caller sees the reference's shapes on every rank.

Under FSDP (a context with an `fsdp_axis`) the forward is the one place
that gathers weights: a block's leaves whose specs name the FSDP dim are
gathered whole over the FSDP group right before the block runs
(`sharding.fsdp_whole`) and dropped after it, one layer at a time; the
embedding, the final norm and the head where they are used.  A period's
gathers sit inside its remat wrapper, so its recomputation gathers
again and no checkpoint policy saves a gathered weight ("dots" saves
matrix products' outputs only).  The backward of each gather is the
reduce-scatter of its gradient over the FSDP ranks.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import _ring
from .blocks import apply_block, init_block, init_block_cache
from .config import ModelConfig
from .layers import (axes_builder, embed_tokens, init_embed, lm_logits,
                     meta_builder, rms_norm, tensor_builder)
from ..parallel import tp as tpc
from ..parallel.sharding import (ShardCtx, cache_split, fsdp_whole,
                                 gather_residual, head_range,
                                 param_shardings, shard_cache, shard_logits,
                                 shard_residual)

KeyPath = Tuple                # dict keys (str) and list indices (int)


def _stacked_builder(make, n: int):
    def smake(name, shape, axes, scale):
        return make(name, (n,) + tuple(shape), ("layers",) + tuple(axes),
                    scale)
    return smake


def _init_tree(make, cfg: ModelConfig) -> Dict:
    p: Dict = {"embed": init_embed(make, cfg.vocab, cfg.d_model,
                                   cfg.tie_embeddings),
               "final_ln": make("final_ln", (cfg.d_model,), ("embed",), 0.0)}
    p["prefix"] = [
        init_block(make, cfg, "a", False, f"prefix{i}")
        for i in range(cfg.n_prefix_layers)
    ]
    smake = _stacked_builder(make, cfg.n_periods)
    p["period"] = [
        init_block(smake, cfg, kind, cfg.is_moe_pos(pos), f"pat{pos}")
        for pos, kind in enumerate(cfg.block_pattern)
    ]
    if cfg.frontend != "none":
        p["frontend_proj"] = make("frontend_proj",
                                  (cfg.d_model, cfg.d_model),
                                  ("embed", "embed2"), 1.0)
    return p


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ('float32', 'bfloat16',
    ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def init_params(cfg: ModelConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Random parameters at `cfg.param_dtype` (`layers.tensor_builder`),
    drawn from `generator` (seed 0 on the CPU by default) in the tree's
    build order.  `device` defaults to CUDA (and raises without a GPU).
    The draws are not the reference's: carry its weights across with
    `params_from_jax`."""
    from repro_torch.netsim.engine import resolve_device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return _init_tree(tensor_builder(generator, torch_dtype(cfg.param_dtype),
                                     device), cfg)


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree as `device="meta"` tensors at
    `cfg.param_dtype`: every key path, shape and dtype, no memory (the
    counterpart of `jax.eval_shape(init_params)`)."""
    return _init_tree(meta_builder(torch_dtype(cfg.param_dtype)), cfg)


def logical_axes(cfg: ModelConfig) -> Dict:
    return _init_tree(axes_builder(), cfg)


def param_specs(cfg: ModelConfig, ctx: ShardCtx) -> Dict:
    """Every leaf's `sharding.Spec` under `ctx` (the reference's
    `param_shardings(logical_axes, ctx, shapes)`), the layout
    `sharding.shard_params` slices by."""
    return param_shardings(logical_axes(cfg), ctx, param_shapes(cfg))


def fsdp_specs(cfg: ModelConfig, ctx: ShardCtx) -> Optional[Dict]:
    """`param_specs` under an FSDP context with a mesh (what the forward
    gathers by), else None."""
    if ctx.mesh is None or ctx.fsdp_axis is None:
        return None
    return param_specs(cfg, ctx)


def _whole(params: Dict, specs: Optional[Dict], key: str, ctx: ShardCtx):
    """`params[key]` with its FSDP-split leaves gathered whole (as it is
    without FSDP)."""
    if specs is None:
        return params[key]
    return fsdp_whole(params[key], specs[key], ctx)


def tree_items(tree, path: KeyPath = ()) -> Iterator[Tuple[KeyPath, object]]:
    """(key path, leaf) pairs in `jax.tree.leaves` order: dict keys
    sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_items(x, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> List:
    """The leaves in `jax.tree.leaves` order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(tree, leaves: List):
    """`tree` with its leaves replaced, in `tree_leaves` order, by
    `leaves`."""
    paths = [path for path, _ in tree_items(tree)]
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(paths)}")
    by_path = dict(zip(paths, leaves))
    return _map_items(tree, lambda path, leaf: by_path[path])


def _map_items(tree, fn: Callable, path: KeyPath = ()):
    """`tree` with each leaf replaced by `fn(key path, leaf)`."""
    if isinstance(tree, dict):
        return {k: _map_items(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_items(x, fn, path + (i,))
                          for i, x in enumerate(tree))
    return fn(path, tree)


def param_count(params: Dict) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A copy of `a` as a tensor; numpy has no bfloat16 of its own, so a
    bfloat16 array (ml_dtypes') crosses as its 16-bit pattern."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Dict:
    """The reference's parameter tree (nested dicts and lists of arrays,
    e.g. `jax.device_get(init_params(key, cfg))`) as the port's tree of
    tensors on `device` (CUDA by default), bit for bit.  Every key path,
    shape and dtype must be the port's layout for `cfg` (`param_shapes`);
    raises `ValueError` on any mismatch."""
    from repro_torch.netsim.engine import resolve_device
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    layout = dict(tree_items(shapes))
    given = dict(tree_items(tree))
    missing = sorted(map(str, layout.keys() - given.keys()))
    extra = sorted(map(str, given.keys() - layout.keys()))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter key paths differ: missing "
                         f"{missing}, unexpected {extra}")

    def carry(path, meta):
        a = np.asarray(given[path])
        want = str(meta.dtype).removeprefix("torch.")
        if tuple(a.shape) != tuple(meta.shape) or a.dtype.name != want:
            raise ValueError(
                f"{cfg.name}: leaf {path} is {a.dtype.name}{list(a.shape)},"
                f" the layout has {want}{list(meta.shape)}")
        return _from_numpy(a).to(device)

    return _map_items(shapes, carry)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def tree_map(tree, fn):
    """`tree` (dicts, lists, None) with each tensor replaced by
    `fn(tensor)`."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(x, fn) for x in tree)
    return None if tree is None else fn(tree)


def _stack(trees: List):
    """Trees of one structure stacked leaf by leaf along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device=None, ctx: Optional[ShardCtx] = None) -> Dict:
    """Cache tree: a prefix list and, per pattern position, caches
    stacked over the periods (leading axis `n_periods`, then the batch).
    `dtype` is a torch dtype or its name; `device` defaults to CUDA.
    Under a mesh (`ctx`) each cache holds the rank's part by
    `sharding.cache_split` (a K/V cache its kv heads or its slots of the
    ring, MLA's latent cache its slots) and an SSM cache its heads."""
    from repro_torch.netsim.engine import resolve_device
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    caches: Dict = {
        "prefix": [init_block_cache(cfg, "a", batch, max_len, dtype, device,
                                    ctx)
                   for _ in range(cfg.n_prefix_layers)],
        "period": [],
    }
    for kind in cfg.block_pattern:
        one = init_block_cache(cfg, kind, batch, max_len, dtype, device, ctx)
        caches["period"].append(tree_map(one, lambda a: a.expand(
            (cfg.n_periods,) + tuple(a.shape)).contiguous()))
    return caches


def _shard_ssm_cache(c: Dict, ctx: ShardCtx) -> Dict:
    """A whole SSM cache ({"conv", "ssm"}, any leading dims) -> this
    rank's (`ssm.init_ssm_cache`'s layout): the state of its heads, the
    conv inputs of its heads' x channels and of every B/C channel."""
    h, p = c["ssm"].shape[-3], c["ssm"].shape[-2]
    start, count = head_range(h, ctx)
    conv = c["conv"]
    if count < h:
        conv = torch.cat([conv[..., start * p:(start + count) * p],
                          conv[..., h * p:]], dim=-1)
    return {"conv": conv.clone(),
            "ssm": c["ssm"].narrow(c["ssm"].ndim - 3, start, count).clone()}


def _shard_ring_cache(c: Dict, ctx: ShardCtx) -> Dict:
    """A whole K/V or latent cache (any leading dims) -> this rank's by
    `sharding.cache_split`: its kv heads (K and V), or its slots of the
    ring (every leaf, and a "ring" leaf recording the ring's size,
    `attention._ring`), or the whole."""
    slots = c["pos"].shape[-1]
    split = cache_split(slots, ctx, c["k"].shape[-2] if "k" in c else None)
    if split.axis == "whole":
        return dict(c)
    if split.axis == "heads":
        return dict(c, k=shard_cache(c["k"], ctx, c["k"].ndim - 2),
                    v=shard_cache(c["v"], ctx, c["v"].ndim - 2))
    out = {}
    for k, x in c.items():
        axis = x.ndim - (1 if k == "pos" else 3 if k in ("k", "v") else 2)
        out[k] = x.narrow(axis, split.start, split.size).clone()
    pos = c["pos"]
    ring = _ring(pos[..., 0].numel(), slots, pos.device)
    out["ring"] = ring.view(tuple(pos.shape) + (0,))
    return out


def shard_caches(caches: Dict, ctx: ShardCtx) -> Dict:
    """A whole cache tree -> this rank's (`init_caches(..., ctx)`'s
    layout): each K/V cache and each MLA latent cache by
    `sharding.cache_split` (`_shard_ring_cache`: its kv heads, or its
    slots of the ring, positions included, or the whole), each SSM cache
    to its heads (`_shard_ssm_cache`)."""
    if isinstance(caches, dict):
        if "ssm" in caches:
            return _shard_ssm_cache(caches, ctx)
        if "pos" in caches:
            return _shard_ring_cache(caches, ctx)
        return {k: shard_caches(v, ctx) for k, v in caches.items()}
    if isinstance(caches, list):
        return [shard_caches(c, ctx) for c in caches]
    return caches


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

_ATEN = torch.ops.aten
# matrix products without batch dims: einsum lowers one to `bmm` over a
# batch of one
_DOTS = (_ATEN.mm.default, _ATEN.addmm.default)


def _is_unbatched_dot(op, args) -> bool:
    return op in _DOTS or (op is _ATEN.bmm.default and
                           args[0].shape[0] == 1)


def _save_dots(ctx, op, *args, **kwargs):
    """remat "dots": save the outputs of matrix products without batch
    dims, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if _is_unbatched_dot(op, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_kv(ctx, op, *args, **kwargs):
    """remat "kv": save the tagged K and V only."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.repro_torch
            .kv_tag.default else CheckpointPolicy.PREFER_RECOMPUTE)


_POLICIES = {"dots": _save_dots, "kv": _save_kv}
REMAT = ("none", "full", "dots", "kv")


def _remat_wrap(fn: Callable, cfg: ModelConfig) -> Callable:
    """`fn` (one period of the stack) as the differentiated forward runs
    it under `cfg.remat`: as it is ("none", or without grad), under
    `torch.utils.checkpoint` ("full"), whose backward runs it again, or
    under a selective checkpoint whose backward runs it again but for
    the ops its policy saved ("dots", "kv")."""
    if cfg.remat not in REMAT:
        raise ValueError(f"unknown remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat in _POLICIES:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _POLICIES[cfg.remat])
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def backbone(params: Dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, ctx: ShardCtx,
             caches: Optional[Dict] = None,
             ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """x: (B,S,d) embedded input. Returns (hidden, caches', aux)."""
    specs = fsdp_specs(cfg, ctx)
    body = _remat_wrap(lambda *a: _period(params, cfg, positions, ctx, *a,
                                          specs=specs), cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_prefix = []
    for i, bp in enumerate(params["prefix"]):
        c = caches["prefix"][i] if caches is not None else None
        if specs is not None:
            bp = fsdp_whole(bp, specs["prefix"][i], ctx)
        x, c, aux = apply_block(bp, cfg, x, positions, "a", False, ctx, c)
        aux_total = aux_total + aux
        new_prefix.append(c)

    pcaches = caches["period"] if caches is not None else None
    period_outs = []
    for i in range(cfg.n_periods):
        if pcaches is None:
            x, aux_total = body(x, aux_total, i)
            continue
        x, aux_total, new = _period(params, cfg, positions, ctx, x,
                                    aux_total, i, pcaches, specs=specs)
        period_outs.append(new)
    new_caches = None
    if pcaches is not None:
        new_caches = {"prefix": new_prefix,
                      "period": [_stack([po[pos] for po in period_outs])
                                 for pos in range(cfg.pattern_len)]}
    x = rms_norm(x, _whole(params, specs, "final_ln", ctx), cfg.norm_eps)
    return x, new_caches, aux_total


def _period(params: Dict, cfg: ModelConfig, positions: torch.Tensor,
            ctx: ShardCtx, x: torch.Tensor, aux_total: torch.Tensor, i: int,
            pcaches: Optional[List] = None, specs: Optional[Dict] = None):
    """Period `i` of the stack (the reference's `period_core`): its
    blocks over `x`, the aux losses added to `aux_total`; under FSDP
    (`specs`, `fsdp_specs`) each block's leaves gathered right before
    it.  Returns (x, aux_total), and the period's new caches when
    `pcaches` is given."""
    new = []
    for pos, kind in enumerate(cfg.block_pattern):
        pp = tree_map(params["period"][pos], lambda a: a[i])
        if specs is not None:
            pp = fsdp_whole(pp, specs["period"][pos], ctx)
        c = (tree_map(pcaches[pos], lambda a: a[i])
             if pcaches is not None else None)
        x, c, aux = apply_block(pp, cfg, x, positions, kind,
                                cfg.is_moe_pos(pos), ctx, c)
        aux_total = aux_total + aux
        new.append(c)
    if pcaches is None:
        return x, aux_total
    return x, aux_total, new


def embed_input(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                ctx: ShardCtx,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The embedded input in the residual layout (`sharding.
    shard_residual`).  FSDP never splits the table (its d_model dim is
    "embed_t"), so only the frontend's projection is gathered."""
    dtype = torch_dtype(cfg.dtype)
    x = embed_tokens(params["embed"], tokens, dtype, ctx, cfg.vocab)
    if frontend_embeds is not None and cfg.frontend != "none":
        fe = torch.einsum("bfd,de->bfe", frontend_embeds.to(dtype),
                          _whole(params, fsdp_specs(cfg, ctx),
                                 "frontend_proj", ctx).to(dtype))
        f = fe.shape[1]
        x = torch.cat([fe, x[:, f:]], dim=1)
    return shard_residual(x, ctx)


# ---------------------------------------------------------------------------
# losses / steps
# ---------------------------------------------------------------------------

def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def _nll(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
         ctx: ShardCtx) -> torch.Tensor:
    """-log softmax of the logits at `labels`, as `torch.logsumexp`
    computes its sum (the max, an infinite max taken as 0, the log of the
    sum of exponentials plus the max) with the max held constant, which
    it is in the gradient.  Where the model dim splits the vocab the
    logits are the rank's slice (vocab-parallel): the max is taken over
    the group (outside autograd), then the sum of exponentials and the
    target's logit (from the rank that holds it) are summed over the
    group in one all-reduce.  One rank, with a mesh or without, runs the
    same operations on the same values."""
    split = ctx.splits("vocab", cfg.vocab)
    mx = logits.detach().amax(-1)
    if split:
        mx = tpc.all_max(mx, ctx.tp_group)
    mx = torch.where(mx.abs() == float("inf"), 0.0, mx)
    if split:
        start, size = ctx.local_range(cfg.vocab)
        local = labels.long() - start
        held = (local >= 0) & (local < size)
        tgt = logits.gather(-1, local.clamp(0, size - 1)[..., None])[..., 0]
        tgt = torch.where(held, tgt, 0.0)
    else:
        tgt = logits.gather(-1, labels[..., None].long())[..., 0]
    sumexp = torch.exp(logits - mx[..., None]).sum(-1)
    if split:
        sumexp, tgt = tpc.reduce(torch.stack([sumexp, tgt]),
                                 ctx.tp_group).unbind(0)
    return sumexp.log() + mx - tgt


def chunked_ce_loss(params: Dict, cfg: ModelConfig, hidden: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor, ctx: ShardCtx,
                    chunk: int = 0) -> torch.Tensor:
    """Next-token CE without materializing full (B,S,V) logits.  `hidden`
    is in the residual layout and is gathered along S; where the model
    dim splits the vocab each rank computes its slice of the logits and
    the CE is vocab-parallel (`_nll`)."""
    hidden = gather_residual(hidden, ctx, labels.shape[1])
    B, S, D = hidden.shape
    chunk = min(chunk or cfg.loss_chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    nc = hidden.shape[1] // chunk
    dtype = torch_dtype(cfg.dtype)
    embed = _whole(params, fsdp_specs(cfg, ctx), "embed", ctx)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        h, lab, m = hidden[:, sl], labels[:, sl], mask[:, sl]
        logits = lm_logits(embed, h, dtype, cfg.logit_softcap)
        nll = _nll(logits, lab, cfg, ctx) * m
        tot = tot + nll.sum()
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict, ctx: ShardCtx,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, Dict]:
    """The training loss: `batch` holds `tokens` and `labels` (B, S) int
    tensors, optionally `mask` and `frontend_embeds`.  Returns (loss,
    {"ce", "aux"}); differentiable in `params` (`train.make_train_step`
    takes its gradient by autograd)."""
    tokens = batch["tokens"]
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    else:
        mask = mask.float()
    if cfg.frontend != "none" and cfg.frontend_tokens:
        fmask = torch.ones_like(mask)
        fmask[:, :cfg.frontend_tokens] = 0.0
        mask = mask * fmask
    positions = _positions(tokens)
    x = embed_input(params, cfg, tokens, ctx, batch.get("frontend_embeds"))
    hidden, _, aux = backbone(params, cfg, x, positions, ctx)
    ce = chunked_ce_loss(params, cfg, hidden, labels, mask, ctx)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


def prefill_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                 ctx: ShardCtx, caches: Dict,
                 frontend_embeds: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Dict]:
    """Process a full prompt, fill caches, return last-token logits
    (B, 1, vocab) in float32, the whole vocab on every rank."""
    positions = _positions(tokens)
    x = embed_input(params, cfg, tokens, ctx, frontend_embeds)
    hidden, caches, _ = backbone(params, cfg, x, positions, ctx, caches)
    last = gather_residual(hidden, ctx, tokens.shape[1])[:, -1:]
    logits = lm_logits(_whole(params, fsdp_specs(cfg, ctx), "embed", ctx),
                       last, torch_dtype(cfg.dtype), cfg.logit_softcap)
    return shard_logits(logits, ctx, cfg.vocab), caches


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                position: torch.Tensor, ctx: ShardCtx, caches: Dict,
                ) -> Tuple[torch.Tensor, Dict]:
    """One token per sequence. tokens: (B,1); position: (B,) int32."""
    positions = position[:, None].to(torch.int32)
    x = embed_input(params, cfg, tokens, ctx)
    hidden, caches, _ = backbone(params, cfg, x, positions, ctx, caches)
    logits = lm_logits(_whole(params, fsdp_specs(cfg, ctx), "embed", ctx),
                       gather_residual(hidden, ctx, 1),
                       torch_dtype(cfg.dtype), cfg.logit_softcap)
    return shard_logits(logits, ctx, cfg.vocab), caches
