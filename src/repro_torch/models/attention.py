"""Attention variants: full/sliding-window GQA-MQA, and DeepSeek-V2 MLA.

The reference computes prefill/train attention with `chunked_attention`
(KV chunks, online softmax), "the pure-JAX analogue of the Pallas flash
kernel", and decode as one chunk over the ring cache.  Here the route
for standard attention is fixed by the device and the layer kind, never
by whether a kernel builds or launches:

  * CPU: `chunked_attention`, a line-for-line copy of the reference
    (operands in the model dtype, float32 accumulation, P rounded to
    the model dtype before its product with V).
  * CUDA, prefill/train/loss: the hand-written flash kernel through
    `ops.flash_attention_bshd(q, k, v, causal=True, window=window)`.
    The reference passes `q_pos == k_pos == arange(S)` there
    (`prefill_step`, `loss_fn`), so the kernel's index masks are its
    position masks.  GQA is read in place (kv head h // (Hq / Hkv)).
  * CUDA, decode: the hand-written decode kernel through
    `ops.decode_attention_bshd(q, cache_k, cache_v, lengths)`, which
    reads the ring cache (B, S, Hkv, D) in place with
    `lengths = min(position + 1, size)` per row.  That is the
    reference's valid set exactly while the ring holds the row's own
    sequence from position 0 (a prefill, then decode steps in order, as
    the serving engine runs them): on 'a' layers slot j holds position
    j, and every stale slot of an earlier request holds a position past
    the current one; on 'l' layers `size = min(max_len, window)`, so
    once the ring has wrapped every slot is inside the window.

Training differentiates both routes.  On the CPU autograd runs through
the copied `chunked_attention` (the reference differentiates its own
with `jax.value_and_grad`).  On CUDA `ops.flash_attention_bshd` is a
`torch.autograd.Function`: its forward writes each row's log-sum-exp
and its backward is the hand-written backward kernel, so
`wq`, `wk`, `wv` and the qk-norm gains get their gradients through the
kernels.  The decode kernel has no backward and raises under grad.

A head_dim the kernels refuse raises on CUDA (the wrappers'
`HEAD_DIMS`); the `reduced()` configs' 16 is one of them.

MLA (`apply_mla`) stays in plain PyTorch ops on every device, as the
reference computes it outside any Pallas kernel: its prefill has
Dk = nope + rope and Dv = v_head_dim, which the kernels do not take, and
its decode is the absorbed latent product.  Under tensor parallelism it
computes the rank's heads as standard attention does.

Under tensor parallelism (a context with a mesh) a rank computes its q
heads from its slice of `wq` (or the whole `wq`'s columns of them where
the model dim does not divide the heads), the kv heads those read
(`attn_layout`), and its rows of `wo`: its terms of the output, which
the block sums over the model group.  The kernels then see the rank's
head counts, a GQA group the whole configs may never produce.

The caches follow the reference's `shard_cache` rule
(`sharding.cache_split`): a K/V cache holds the rank's kv heads where
they divide the model dim, else its slots of the ring; MLA's latent
cache holds its slots.  A cache held by slots carries a "ring" leaf
(`_ring`) and is written only where the rank holds the slot
(`_cache_write`).  A decode step over it attends for every head over
the rank's slots, on CUDA with the decode kernel's log-sum-exp entry
(`ops.decode_attention_bshd_lse`), on the CPU with its plain version,
and merges the ranks' partial softmaxes in rank order
(`merge_partials`): `_split_decode`, and MLA's `_latent_attention`,
which takes that partial form with and without a mesh.

Under `remat="kv"` a differentiated prefill tags K and V with
`kv_tag`, the identity as a custom op (`repro_torch::kv_tag`, a copy of
the same values and strides), where the reference names them
"kv_gathered" (`checkpoint_name`); the checkpoint policy of
`transformer._remat_wrap` saves what that op returns and nothing else.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Builder, apply_rope, rms_norm
from ..kernels import ops
from ..parallel import tp as tpc
from ..parallel.sharding import (ShardCtx, cache_kv_heads, cache_split,
                                 group_reads, head_range, leaf_specs,
                                 local_ctx, local_part)

NEG_INF = -1e30


@torch.library.custom_op("repro_torch::kv_tag", mutates_args=())
def kv_tag(x: torch.Tensor) -> torch.Tensor:
    """K or V as they are (a copy with x's values and strides), tagged
    for remat "kv"'s policy, which sees this op and saves its output."""
    return x.clone()


@kv_tag.register_fake
def _(x):
    return torch.empty_like(x)


kv_tag.register_autograd(lambda ctx, grad: grad)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_attn(make: Builder, cfg: ModelConfig, prefix: str) -> Dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": make(f"{prefix}.wq", (d, hq, dh), ("embed", "heads", "head"), 1.0),
        "wk": make(f"{prefix}.wk", (d, hkv, dh), ("embed", "kv", "head"), 1.0),
        "wv": make(f"{prefix}.wv", (d, hkv, dh), ("embed", "kv", "head"), 1.0),
        "wo": make(f"{prefix}.wo", (hq, dh, d), ("heads", "head", "embed"), 1.0),
    }
    if cfg.qk_norm:
        p["q_gamma"] = make(f"{prefix}.qg", (dh,), ("head",), 0.0)
        p["k_gamma"] = make(f"{prefix}.kg", (dh,), ("head",), 0.0)
    return p


def init_mla(make: Builder, cfg: ModelConfig, prefix: str) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.nope_head_dim + cfg.rope_head_dim
    return {
        "wq_a": make(f"{prefix}.wq_a", (d, cfg.q_lora), ("embed", "qlora"), 1.0),
        "q_gamma": make(f"{prefix}.qn", (cfg.q_lora,), ("qlora",), 0.0),
        "wq_b": make(f"{prefix}.wq_b", (cfg.q_lora, h, qd),
                     ("qlora", "heads", "head"), 1.0),
        "wkv_a": make(f"{prefix}.wkv_a", (d, cfg.kv_lora + cfg.rope_head_dim),
                      ("embed", "kvlora"), 1.0),
        "kv_gamma": make(f"{prefix}.kvn", (cfg.kv_lora,), ("kvlora",), 0.0),
        "wkv_b": make(f"{prefix}.wkv_b",
                      (cfg.kv_lora, h, cfg.nope_head_dim + cfg.v_head_dim),
                      ("kvlora", "heads", "head"), 1.0),
        "wo": make(f"{prefix}.wo", (h, cfg.v_head_dim, d),
                   ("heads", "head", "embed"), 1.0),
    }


# ---------------------------------------------------------------------------
# chunked flash-style attention (the CPU route; the reference's oracle)
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      *, window: int = 0, chunk: int = 1024,
                      causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k/v: (B,Sk,Hkv,Dk|Dv); positions int32 (B,Sq)/(B,Sk).

    window > 0 limits attention to the last `window` positions (inclusive
    of self).  Returns (B,Sq,Hq,Dv) in q.dtype.  The KV chunks run in a
    Python loop (the reference's `lax.scan`, or its unrolled loop under
    `cfg.unroll_loops`: the same sums in the same order)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    G = Hq // Hkv
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32,
                                          device=q.device))
    chunk = min(chunk, Sk)
    pad = (-Sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
    n_chunks = k.shape[1] // chunk

    # operands stay in the model dtype, the products accumulate in
    # float32 (the reference's preferred_element_type)
    kc = k.reshape(B, n_chunks, chunk, Hkv, k.shape[-1])
    vc = v.reshape(B, n_chunks, chunk, Hkv, Dv)
    pc = k_pos.reshape(B, n_chunks, chunk)
    q32 = q.float()

    m = torch.full((B, Sq, Hq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Hq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hq, Dv), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        kb, vb, pb = kc[:, i], vc[:, i], pc[:, i]       # (B,C,Hkv,*),(B,C)
        if G > 1:
            kb = kb.repeat_interleave(G, dim=2)
            vb = vb.repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bchd->bqhc", q32, kb.float()) * scale
        valid = (pb >= 0)[:, None, :]                    # (B,1,C)
        if causal:
            valid = valid & (pb[:, None, :] <= q_pos[:, :, None])
        if window > 0:
            valid = valid & (pb[:, None, :] > q_pos[:, :, None] - window)
        s = torch.where(valid[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhc,bchd->bqhd", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# standard (GQA / MQA / MHA) attention with optional KV cache
# ---------------------------------------------------------------------------

def _maybe_qk_norm(p: Dict, q, k, eps: float):
    if "q_gamma" in p:
        q = rms_norm(q, p["q_gamma"], eps)
        k = rms_norm(k, p["k_gamma"], eps)
    return q, k


def _ring(batch: int, slots: int, device) -> torch.Tensor:
    """The "ring" leaf of a cache split along S: a zero-size int32
    (batch, slots, 0) tensor whose shape records the ring's global slot
    count.  A rank's slots alone cannot tell a ring split into `size` x
    tp slots from a whole one of `size`; the leaf holds no data, and
    every walk of the cache tree (`tree_map`, stacking, `_keep_slot`)
    carries its shape as it does any other leaf's."""
    return torch.empty((batch, slots, 0), dtype=torch.int32, device=device)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  kind: str, dtype, device=None,
                  ctx: Optional[ShardCtx] = None) -> Dict:
    """Ring-buffer cache. 'l' layers cap the buffer at cfg.window.  Under
    a mesh it holds what `sharding.cache_split` gives the rank: its kv
    heads (`cache_kv_heads`), or its slots of the ring (its positions
    too, and a "ring" leaf, `_ring`), or the whole."""
    ctx = local_ctx() if ctx is None else ctx
    size = min(max_len, cfg.window) if kind == "l" else max_len
    split = cache_split(size, ctx, cfg.n_kv_heads)
    hkv = cache_kv_heads(cfg.n_kv_heads, ctx)
    dh = cfg.head_dim
    cache = {
        "k": torch.zeros((batch, split.size, hkv, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, split.size, hkv, dh), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, split.size), -1, dtype=torch.int32,
                          device=device),
    }
    if split.axis == "slots":
        cache["ring"] = _ring(batch, size, device)
    return cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype, device=None,
                   ctx: Optional[ShardCtx] = None) -> Dict:
    """The latent cache (B, S, kv_lora), its rope keys (B, S, rope) and
    positions.  Under a mesh it holds the rank's slots where
    `sharding.cache_split` splits S (then with a "ring" leaf, `_ring`),
    else the whole."""
    ctx = local_ctx() if ctx is None else ctx
    split = cache_split(max_len, ctx)
    n = split.size
    cache = {
        "ckv": torch.zeros((batch, n, cfg.kv_lora), dtype=dtype,
                           device=device),
        "kr": torch.zeros((batch, n, cfg.rope_head_dim), dtype=dtype,
                          device=device),
        "pos": torch.full((batch, n), -1, dtype=torch.int32,
                          device=device),
    }
    if split.axis == "slots":
        cache["ring"] = _ring(batch, max_len, device)
    return cache


def cache_ring(cache: Dict, ctx: ShardCtx) -> Tuple[int, int, int]:
    """(start, size, S): `cache` holds slots [start, start + size) of a
    ring of S.  A cache without a "ring" leaf holds its whole ring; one
    with it holds the rank's slots by `sharding.cache_split`."""
    size = cache["pos"].shape[-1]
    if "ring" not in cache:
        return 0, size, size
    slots = cache["ring"].shape[-2]
    split = cache_split(slots, ctx)
    if split.axis != "slots" or split.size != size:
        raise ValueError(f"a cache of {size} slots with a ring of {slots}:"
                         f" not this rank's slots at a model dim of "
                         f"{ctx.tp_size}")
    return split.start, size, slots


def _cache_write(cache: Dict, names: Tuple[str, ...], values, positions,
                 ctx: ShardCtx):
    """Write (B,P,...) entries at ring slots positions % S; returns a new
    cache dict (the input's tensors are not written).  The cache holds
    slots [start, start + size) of a ring of S (`cache_ring`): an entry
    whose slot lies there goes to slot - start, the others are dropped.

    A prompt that covers the ring exactly or wraps it a whole number of
    times replaces the buffers with (the held slots of) its last S
    entries, as the reference's fast path does.  A longer prompt that
    does not wrap evenly repeats slots in `positions % S`, where the
    reference's scatter keeps the last write: only its last S entries,
    whose slots are distinct, are written here, so no order of repeated
    indices is left to the device.  A whole ring drops nothing: one
    `index_put` a buffer.  A rank's slots are scattered over a copy of
    the buffer with one scratch row past its end, where the dropped
    entries land (in any order) and which is cut off after: no mask, no
    host sync."""
    start, size, S = cache_ring(cache, ctx)
    P = positions.shape[1]
    new = dict(cache)
    if P == S or (P > S and P % S == 0):
        first = P - S + start
        for n, val in zip(names, values):
            new[n] = val[:, first:first + size].to(cache[n].dtype)
        new["pos"] = positions[:, first:first + size].to(torch.int32)
        return new
    if P > S:
        values = [val[:, -S:] for val in values]
        positions = positions[:, -S:]
    B = cache["pos"].shape[0]
    slots = (positions % S).long()                            # (B,P)
    writes = [*zip(names, values), ("pos", positions)]
    if size == S:
        bidx = torch.arange(B, device=slots.device)[:, None]
        for n, val in writes:
            new[n] = cache[n].index_put((bidx, slots),
                                        val.to(cache[n].dtype))
        return new
    local = slots - start
    rows = torch.arange(B, device=local.device)[:, None] * size + local
    rows = torch.where((local >= 0) & (local < size), rows,
                       B * size).reshape(-1)
    for n, val in writes:
        old = cache[n]
        rest = tuple(old.shape[2:])
        buf = torch.cat([old.reshape((B * size,) + rest),
                         old.new_empty((1,) + rest)])
        buf.index_put_((rows,), val.reshape((-1,) + rest).to(old.dtype))
        new[n] = buf[:B * size].view(old.shape)
    return new


def standard_attention_layers(cfg: ModelConfig) -> int:
    """The layers that take standard attention, the ones routed to the
    kernels on CUDA (MLA and mamba layers are not)."""
    if cfg.use_mla:
        return 0
    per = sum(t in ("a", "l", "g") for t in cfg.block_pattern)
    return cfg.n_prefix_layers + per * cfg.n_periods


def _prefill_attention(q, k, v, positions, window: int, cfg: ModelConfig,
                       ctx: ShardCtx):
    """Causal (and windowed) attention of a prompt over its own K/V."""
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, positions, positions,
                                 window=window, chunk=cfg.attn_chunk)
    return ops.flash_attention_bshd(q, k.contiguous(), v.contiguous(),
                                    causal=True, window=window)


def decode_lengths(positions: torch.Tensor, size: int, start: int = 0,
                   slots: Optional[int] = None) -> torch.Tensor:
    """The decode kernel's valid cache slots a row, (B,) int32, of a
    cache holding slots [start, start + size) of a ring of `slots`
    (default `size`, the whole ring): L = `min(position + 1, slots)` of
    positions (B, 1), the held ones `clamp(L - start, 0, size)`.  Slots
    below L are the reference's valid set while the ring holds the row's
    own sequence from position 0 (module docstring)."""
    valid = torch.clamp(positions[:, 0] + 1,
                        max=size if slots is None else slots)
    if slots is not None and slots != size:
        valid = torch.clamp(valid - start, min=0, max=size)
    return valid.to(torch.int32)


def _decode_attention(q, cache: Dict, positions, window: int,
                      ctx: ShardCtx):
    """One query a row against the ring cache just written."""
    if q.device.type == "cpu":
        return chunked_attention(q, cache["k"], cache["v"], positions,
                                 cache["pos"], window=window,
                                 chunk=cache["k"].shape[1])
    lengths = decode_lengths(positions, cache["pos"].shape[1])
    return ops.decode_attention_bshd(q, cache["k"], cache["v"], lengths)


def _decode_partial(q, k, v, lengths):
    """One query a row against the rank's slots of a ring split along S:
    (out (B, 1, Hq, D) float32, lse (B, Hq) float32), a row of length 0
    giving 0 and -inf (`ops.decode_attention_bshd_lse`: the decode
    kernel's log-sum-exp entry on CUDA, its plain version on the CPU)."""
    return ops.decode_attention_bshd_lse(q, k, v, lengths)


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The softmax over the union of disjoint key sets from each set's
    partial, in float32, in the order of the stack (rank order): outs
    (n, *rows, D) each set's normalised output, lses (n, *rows) the
    log-sum-exp of its scores (-inf for a set with no key, which then
    weighs 0).  m = max lse, w_i = exp(lse_i - m), out = sum_i w_i out_i
    / sum_i w_i, both sums taken in order.  One partial comes back bit
    for bit (w = exp(0) = 1, a division by 1); a row whose sets are all
    empty gives 0."""
    m = lses.amax(0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    acc = wsum = None
    for out, lse in zip(outs, lses):
        w = torch.exp(lse - m)
        acc = w[..., None] * out if acc is None else acc + w[..., None] * out
        wsum = w if wsum is None else wsum + w
    return acc / torch.clamp(wsum, min=1e-30)[..., None]


def _all_heads(x: torch.Tensor, n_heads: int, ctx: ShardCtx):
    """(B, S, count, F), this rank's heads (`head_range`) -> (B, S,
    n_heads, F), every rank's: padded to the reference's even share
    (zero heads), gathered over the model group in rank order, the
    padding cut off."""
    tp = ctx.tp_size
    per = (n_heads + (-n_heads % tp)) // tp
    if x.shape[2] < per:
        x = F.pad(x, (0, 0, 0, per - x.shape[2]))
    return tpc.gather(x, 2, ctx.tp_group)[:, :, :n_heads]


def _in_layout(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """y with its dims laid out in the order of `like`'s strides, so
    that the products after it see the layout they would see without
    the collectives before (at a model dim of 1, `like`'s own strides)
    and sum in the same order."""
    order = sorted(range(like.ndim), key=lambda d: like.stride(d),
                   reverse=True)
    back = sorted(range(like.ndim), key=order.__getitem__)
    return y.permute(order).contiguous().permute(back)


def _split_decode(q, cache: Dict, positions, n_heads: int, ctx: ShardCtx):
    """Decode attention over a K/V ring split along S (a "ring" leaf):
    the query's heads gathered over the model group, one partial over
    this rank's slots for every head (`_decode_partial`, lengths by
    `decode_lengths` of its range: a rank with none of a row's valid
    slots weighs 0), the partials and their log-sum-exps gathered in one
    collective and merged in rank order (`merge_partials`), so every
    rank holds the same bits; returns this rank's heads (B, 1, count,
    D) in q's dtype.  A rank with only padded heads runs it too: its
    slots serve every head, and the group's collectives must match."""
    start, count = head_range(n_heads, ctx)
    q_all = _all_heads(q, n_heads, ctx)
    s0, size, S = cache_ring(cache, ctx)
    lengths = decode_lengths(positions, size, s0, S)
    out, lse = _decode_partial(q_all, cache["k"], cache["v"], lengths)
    D = out.shape[-1]
    part = torch.cat([out, lse[:, None, :, None]], -1)
    parts = tpc.gather(part[None], 0, ctx.tp_group)
    merged = merge_partials(parts[..., :D], parts[..., D])
    return merged[:, :, start:start + count].to(q.dtype)


def attn_layout(cfg: ModelConfig, ctx: ShardCtx):
    """(start, count, kv) of this rank's attention: its q heads [start,
    start + count) (`sharding.head_range`), and `kv`, None where its K/V
    heads are the ones it computes (no mesh, or the model dim splits the
    kv heads, whose slice the rank's q heads read), else the kv heads
    (of all, which every rank computes) its q heads read, in the form
    the kernels take: head start + j reads kv[j // (count // len(kv))].

    A q head h reads kv head h // (Hq / Hkv), the model's own grouping,
    at every model dim.  (The reference pads the heads to a multiple of
    the model dim, which regroups them when the kv heads are not
    padded too: at Hq 12, Hkv 4 and a model dim of 8 its head 3 reads kv
    head 0, not 1, so its values under such a mesh differ from its own
    without one; ROADMAP queue 3.)"""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    start, count = head_range(hq, ctx)
    if ctx.mesh is None or count == 0 or ctx.splits("kv", hkv):
        return start, count, None
    return start, count, group_reads(start, count, hq // hkv)


def _kv_select(x: torch.Tensor, kv) -> torch.Tensor:
    """K or V (B, S, Hkv, D) at the kv heads `kv` (`attn_layout`)."""
    if kv is None or kv == list(range(x.shape[2])):
        return x
    return x.index_select(2, torch.tensor(kv, device=x.device))


def apply_attn(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, kind: str,
               cache: Optional[Dict] = None,
               ctx: Optional[ShardCtx] = None,
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B,S,d), the whole sequence on every rank. positions: (B,S).
    Returns (out, updated cache).  Under a mesh `out` is this rank's
    terms of the output, its heads through its rows of `wo`
    (`attn_layout`; the block sums them over the model group), and the
    cache holds what `sharding.cache_split` gives it: its kv heads, or
    its slots of the ring, over which a decode step attends for every
    head (`_split_decode`), or the whole."""
    ctx = local_ctx() if ctx is None else ctx
    dt = x.dtype
    window = cfg.window if kind == "l" else 0
    start, count, kv = attn_layout(cfg, ctx)
    wq, wo = p["wq"], p["wo"]
    if ctx.mesh is not None and not ctx.splits("heads", cfg.n_heads):
        # whole on every rank: this rank's heads of them
        wq, wo = wq.narrow(1, start, count), wo.narrow(0, start, count)
    q = torch.einsum("bsd,dhk->bshk", x, wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    q, k = _maybe_qk_norm(p, q, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_base)
    k = apply_rope(k, positions, cfg.rope_base)
    wo = wo.to(dt)
    if cache is not None:
        cache = _cache_write(cache, ("k", "v"), (k, v), positions, ctx)
    if cache is not None and q.shape[1] == 1 and "ring" in cache:
        # the ring is split along S: every rank, one with only padded
        # heads included, attends over its slots for all heads
        out = _split_decode(q, cache, positions, cfg.n_heads, ctx)
        return torch.einsum("bshk,hkd->bsd", out, wo), cache
    if count == 0:
        # only padded heads here (the reference's zero rows of wo): no
        # attention, and the empty product's zeros still hang on x in
        # autograd, so that the block's sum over the model group runs its
        # backward on this rank as on the others
        return torch.einsum("bshk,hkd->bsd", q, wo), cache

    if cache is not None and q.shape[1] == 1:
        heads = dict(cache, k=_kv_select(cache["k"], kv),
                     v=_kv_select(cache["v"], kv))
        out = _decode_attention(q, heads, positions, window, ctx)
        return torch.einsum("bshk,hkd->bsd", out, wo), cache

    # Train / prefill: attend over the prompt's own K/V (the ring cache
    # may be smaller than the prompt for sliding-window layers; the cache
    # written above is kept for decode).
    k, v = _kv_select(k, kv), _kv_select(v, kv)
    if cfg.remat == "kv" and torch.is_grad_enabled():
        k, v = kv_tag(k), kv_tag(v)
    out = _prefill_attention(q, k, v, positions, window, cfg, ctx)
    return torch.einsum("bshk,hkd->bsd", out, wo), cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2): latent KV cache, absorbed decode
# ---------------------------------------------------------------------------

def _latent_attention(q_lat, q_rope, cache: Dict, positions, scale,
                      n_heads: int, ctx: ShardCtx) -> torch.Tensor:
    """The absorbed attention of this rank's heads over the latent cache
    (B, S, count, kv_lora), in partial form with and without a mesh.
    Over the slots the cache holds: the masked scores, their softmax
    cast to the activations' dtype and its product with `ckv`, and
    beside it the scores' log-sum-exp a row and head; the partials merge
    in float32 (`merge_partials`).  Over a whole cache that is one
    partial, which comes back bit for bit.  Over a cache split along S
    (a "ring" leaf) q_lat and q_rope are first gathered for every head,
    and the ranks' partials (one collective) merge in rank order; a
    rank with only padded heads runs both collectives too.  The result
    keeps the layout of the product with `ckv` (`_in_layout`), and the
    gathered queries keep theirs, so at a model dim of 1 every product
    sums as it does without a mesh."""
    dt = q_lat.dtype
    start, count = head_range(n_heads, ctx)
    split = "ring" in cache
    if split:
        kvl = q_lat.shape[-1]
        q = _all_heads(torch.cat([q_lat, q_rope], -1), n_heads, ctx)
        q_lat = _in_layout(q[..., :kvl], q_lat)
        q_rope = _in_layout(q[..., kvl:], q_rope)
    s = (torch.einsum("bshk,btk->bhst", q_lat, cache["ckv"]) +
         torch.einsum("bshr,btr->bhst", q_rope, cache["kr"]))
    s = s.float() * scale
    pos = cache["pos"]
    valid = (pos >= 0)[:, None, None, :] & \
        (pos[:, None, None, :] <= positions[:, None, :, None])
    s = torch.where(valid, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1).transpose(1, 2)          # (B,S,H)
    a = torch.softmax(s, dim=-1).to(dt)
    lat = torch.einsum("bhst,btk->bshk", a, cache["ckv"])
    if not split:
        merged = merge_partials(lat.float()[None], lse[None])
        return _in_layout(merged.to(dt), lat)
    kvl = lat.shape[-1]
    parts = tpc.gather(torch.cat([lat.float(), lse[..., None]], -1)[None],
                       0, ctx.tp_group)
    merged = merge_partials(parts[..., :kvl], parts[..., kvl])
    return _in_layout(merged[:, :, start:start + count].to(dt), lat)


def apply_mla(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[Dict] = None,
              ctx: Optional[ShardCtx] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B,S,d), the whole sequence on every rank.  Returns (out,
    updated cache).  Under a mesh a rank computes its heads
    (`sharding.head_range`): its columns of `wq_b` and `wkv_b`
    (column-parallel) and its rows of `wo` (row-parallel), through
    `local_part`; `out` is its terms of the output, which the block sums
    over the model group.  `wq_a`, `wkv_a` and the two norm gains are
    whole on every rank.  The latent cache (B, S, kv_lora) and its rope
    keys hold the rank's slots where the reference splits them along S
    (`sharding.cache_split`), and the absorbed attention over them is
    taken in partial form (`_latent_attention`)."""
    ctx = local_ctx() if ctx is None else ctx
    dt = x.dtype
    B, S, _ = x.shape
    nd, rd = cfg.nope_head_dim, cfg.rope_head_dim
    start, count = head_range(cfg.n_heads, ctx)
    specs = leaf_specs(init_mla, cfg, ctx)
    even = cfg.n_heads % ctx.tp_size == 0

    def heads(name, dim):
        return local_part(p[name], specs[name], dim, start, count, ctx, even)

    wq_b, wkv_b, wo = heads("wq_b", 1), heads("wkv_b", 1), heads("wo", 0)
    cq = rms_norm(torch.einsum("bsd,dq->bsq", x, p["wq_a"].to(dt)),
                  p["q_gamma"], cfg.norm_eps)
    qf = torch.einsum("bsq,qhk->bshk", cq, wq_b.to(dt))

    kva = torch.einsum("bsd,dk->bsk", x, p["wkv_a"].to(dt))
    ckv = rms_norm(kva[..., :cfg.kv_lora], p["kv_gamma"], cfg.norm_eps)
    k_rope = apply_rope(kva[..., None, cfg.kv_lora:], positions,
                        cfg.rope_base)[:, :, 0]               # (B,S,rd)
    if cache is not None:
        cache = _cache_write(cache, ("ckv", "kr"), (ckv, k_rope), positions,
                             ctx)
    if count == 0 and (cache is None or "ring" not in cache):
        # only padded heads here: the empty product's zeros hang on x in
        # autograd, as `apply_attn`'s do (over a split latent cache the
        # rank's slots serve every head, so it attends as the others do)
        return torch.einsum("bsh,hvd->bsd", qf.sum(-1), wo.to(dt)), cache

    q_nope, q_rope = qf[..., :nd], qf[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_base)
    scale = 1.0 / torch.sqrt(torch.tensor(nd + rd, dtype=torch.float32,
                                          device=x.device))

    if cache is None:
        # ---- prefill / train: expand per-head K,V ----
        kvf = torch.einsum("bsk,khd->bshd", ckv, wkv_b.to(dt))
        k_nope, vv = kvf[..., :nd], kvf[..., nd:]
        k_full = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(B, S, count, rd)], -1)
        q_full = torch.cat([q_nope, q_rope], -1)
        out = chunked_attention(q_full, k_full, vv, positions, positions,
                                chunk=cfg.attn_chunk)
    else:
        # ---- decode: absorbed attention over the latent cache ----
        wkv_b = wkv_b.to(dt)
        w_uk, w_uv = wkv_b[..., :nd], wkv_b[..., nd:]
        q_lat = torch.einsum("bshd,khd->bshk", q_nope, w_uk)  # (B,S,H,kv_lora)
        lat = _latent_attention(q_lat, q_rope, cache, positions, scale,
                                cfg.n_heads, ctx)
        out = torch.einsum("bshk,khd->bshd", lat, w_uv)       # (B,S,H,vd)

    y = torch.einsum("bshv,hvd->bsd", out, wo.to(dt))
    return y, cache
