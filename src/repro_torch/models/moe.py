"""Mixture-of-Experts: top-k routing, capacity dispatch and combine, and
shared experts.

The reference has three execution modes over one local dispatch/combine
body, and so has the port (`apply_moe` picks one as the reference does):

  * without a mesh, or under one whose model dim does not divide the
    experts ("none"): the body on the rank's tokens, every expert here;
  * "a2a" (the sequence divides the model dim: train and prefill): each
    model rank routes its own sequence slice, with the capacity of its
    own token count and the arrival ranks of its own tokens, and the
    dispatch buffers go to the experts' ranks and back with
    `all_to_all` over the model group, so token drops depend on the
    sharding, as the reference's do;
  * "psum" (decode): every rank routes all tokens, runs its E / m
    experts and the outputs are summed over the model group in float32.

The router's slices (its "experts" dim is split with the experts) are
gathered before routing; the aux loss is averaged over the model group.
Under FSDP the block's leaves come gathered whole over the FSDP dim
(`transformer`), so the expert banks' "mlp_e" columns are whole here.

Order matters where the reference leaves it implicit:
  * `jax.lax.top_k` breaks ties toward the lower expert index;
    `torch.topk` promises no order, so the top k are the first k of a
    stable descending sort.
  * the arrival rank of an entry within its expert comes from a stable
    sort (`_ranks_within_expert`).
  * dispatch scatters with accumulation: an entry past an expert's
    capacity is clamped to its last slot and adds an exact 0.0 there,
    as in the reference, so that slot holds one nonzero addend and the
    order of CUDA's atomics cannot change a bit.  A scatter without
    accumulation would let the zero overwrite the real token.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Builder, act_fn, init_mlp, mlp_residual
from ..parallel import tp as tpc
from ..parallel.sharding import ShardCtx, seq_split


def init_moe(make: Builder, cfg: ModelConfig, prefix: str) -> Dict:
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    p = {
        "router": make(f"{prefix}.router", (d, e), ("embed", "experts"), 1.0),
        # expert weights: the contracted dims keep their own logical
        # axis (embed_e), the FFN dim shards (mlp_e), as in the
        # reference's layout
        "wi": make(f"{prefix}.wi", (e, d, f),
                   ("experts", "embed_e", "mlp_e"), 1.0),
        "wg": make(f"{prefix}.wg", (e, d, f),
                   ("experts", "embed_e", "mlp_e"), 1.0),
        "wo": make(f"{prefix}.wo", (e, f, d),
                   ("experts", "mlp_e", "embed_e"), 1.0),
    }
    if cfg.moe_shared:
        p["shared"] = init_mlp(make, d, cfg.moe_shared * f,
                               f"{prefix}.shared")
    return p


# ---------------------------------------------------------------------------
# local dispatch / combine
# ---------------------------------------------------------------------------

def _topk_route(router_w, x_flat, cfg: ModelConfig):
    """x_flat: (T, d) -> (weights (T,k), experts (T,k), aux_loss)."""
    logits = torch.einsum("td,de->te", x_flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    # the top k, ties to the lower index: a stable descending sort
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.moe_topk], idx[:, :cfg.moe_topk]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    w = w * cfg.router_scale
    # Switch-style load-balance aux loss
    e = cfg.moe_experts
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], e).float().mean(0)
    aux = e * torch.sum(me * ce)
    return w.to(x_flat.dtype), idx, aux


def _ranks_within_expert(eids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """eids: flat (N,) expert ids -> arrival rank of each entry within its
    expert (stable order)."""
    n = eids.shape[0]
    sorted_e, order = torch.sort(eids, stable=True)
    start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = (torch.arange(n, device=eids.device) - start).to(
        torch.int32)
    return torch.zeros(n, dtype=torch.int32,
                       device=eids.device).index_put((order,), rank_sorted)


def _dispatch(x_flat, eids, ranks, n_experts, capacity):
    """Scatter tokens into (E, C, d) buffers; overflow tokens dropped.

    Sums in a float32 buffer and casts back, as the reference does."""
    t, d = x_flat.shape
    k = eids.shape[-1]
    flat_e = eids.reshape(-1)
    flat_r = ranks.reshape(-1)
    valid = flat_r < capacity
    src = x_flat.float().repeat_interleave(k, dim=0)
    src = torch.where(valid[:, None], src, 0.0)
    buf = torch.zeros((n_experts, capacity, d), dtype=torch.float32,
                      device=x_flat.device)
    buf = buf.index_put((flat_e, torch.clamp(flat_r, max=capacity - 1).long()),
                        src, accumulate=True)
    return buf.to(x_flat.dtype)


def _combine(buf, weights, eids, ranks, capacity):
    """Gather expert outputs back per (token, k) and weight-sum."""
    t, k = eids.shape
    flat_e = eids.reshape(-1)
    flat_r = ranks.reshape(-1)
    valid = (flat_r < capacity).to(buf.dtype)
    got = buf[flat_e, torch.clamp(flat_r, max=capacity - 1).long()]
    got = got * valid[:, None]
    got = got.reshape(t, k, -1)
    return torch.einsum("tkd,tk->td", got, weights.to(buf.dtype))


def _expert_ffn(p: Dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d) through the gated FFN, each product
    accumulated in float32 and rounded to the buffer's dtype (the
    reference's preferred_element_type)."""
    dt = buf.dtype
    b32 = buf.float()
    h = torch.einsum("ecd,edf->ecf", b32,
                     p["wi"].to(dt).float()).to(dt)
    g = torch.einsum("ecd,edf->ecf", b32,
                     p["wg"].to(dt).float()).to(dt)
    h = act_fn(act)(g) * h
    return torch.einsum("ecf,efd->ecd", h.float(),
                        p["wo"].to(dt).float()).to(dt)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    """Per-expert buffer slots for `tokens` routed tokens: the top-k
    share times the capacity factor, rounded up to a multiple of 8 (at
    least 8)."""
    c = int(math.ceil(tokens * cfg.moe_topk / cfg.moe_experts
                      * cfg.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def _moe_local(p, cfg: ModelConfig, x, router=None, mode: str = "none",
               ctx: Optional[ShardCtx] = None):
    """The MoE body on a rank's tokens x (B, S', d) in `mode` (module
    docstring); `router` is the whole router (d, E), `p`'s own by
    default, and `p`'s expert weights are the rank's (E / m of them in
    "a2a" and "psum")."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    w, idx, aux = _topk_route(p["router"] if router is None else router,
                              x_flat, cfg)
    ranks = _ranks_within_expert(idx.reshape(-1),
                                 cfg.moe_experts).reshape(idx.shape)
    cap = _capacity(b * s, cfg)
    if ctx is not None:
        aux = tpc.pmean(aux, ctx.tp_group)

    if mode == "none":
        buf = _dispatch(x_flat, idx, ranks, cfg.moe_experts, cap)
        buf = _expert_ffn(p, buf, cfg.act)
        out = _combine(buf, w, idx, ranks, cap)
        return out.reshape(b, s, d), aux

    group = ctx.tp_group
    m = ctx.tp_size
    e_loc = cfg.moe_experts // m
    if mode == "a2a":
        buf = _dispatch(x_flat, idx, ranks, cfg.moe_experts, cap)
        # (E, C, d) -> (E/m, m*C, d): chunk j of the experts to rank j,
        # the ranks' chunks side by side along the capacity
        buf = tpc.all_to_all(buf, group)
        buf = buf.reshape(m, e_loc, cap, d).transpose(0, 1).reshape(
            e_loc, m * cap, d)
        buf = _expert_ffn(p, buf, cfg.act)
        buf = buf.reshape(e_loc, m, cap, d).transpose(0, 1).reshape(
            cfg.moe_experts, cap, d)
        buf = tpc.all_to_all(buf, group)
        out = _combine(buf, w, idx, ranks, cap)
        return out.reshape(b, s, d), aux

    if mode == "psum":
        e0 = ctx.tp_rank * e_loc
        local = idx - e0
        here = (local >= 0) & (local < e_loc)
        local_ids = torch.where(here, local, 0)
        local_ranks = torch.where(here, ranks, cap)   # force-drop remote
        buf = _dispatch(x_flat, local_ids, local_ranks, e_loc, cap)
        buf = _expert_ffn(p, buf, cfg.act)
        out = _combine(buf, w * here.to(w.dtype), local_ids, local_ranks,
                       cap)
        out = tpc.reduce(out.float(), group).to(x.dtype)
        return out.reshape(b, s, d), aux

    raise ValueError(mode)


def moe_mode(cfg: ModelConfig, ctx: ShardCtx, seq_len: int) -> str:
    """The reference's choice: "a2a" when the residual is split along a
    sequence of `seq_len`, else "psum"; "none" without a mesh or where
    the model dim does not divide the experts."""
    if ctx.mesh is None or cfg.moe_experts % ctx.tp_size:
        return "none"
    return "a2a" if seq_split(seq_len, ctx) else "psum"


def apply_moe(p: Dict, cfg: ModelConfig, x: torch.Tensor, ctx: ShardCtx,
              seq_len: Optional[int] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S', d) in the residual layout of a sequence of `seq_len`
    (x's own by default). Returns (out in that layout, aux_loss)."""
    seq_len = x.shape[1] if seq_len is None else seq_len
    shared_out = None
    if "shared" in p:
        shared_out = mlp_residual(p["shared"], x, cfg.act, x.dtype, ctx,
                                  seq_len, cfg.moe_shared * cfg.moe_d_ff)
    if ctx.mesh is None:
        out, aux = _moe_local(p, cfg, x)
    else:
        mode = moe_mode(cfg, ctx, seq_len)
        router = p["router"]
        if ctx.splits("experts", cfg.moe_experts):
            router = tpc.gather(router, -1, ctx.tp_group)
        out, aux = _moe_local(p, cfg, x, router, mode, ctx)
    if shared_out is not None:
        out = out + shared_out
    return out, aux
