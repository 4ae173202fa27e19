"""Mamba2 (SSD — state-space duality) mixer, arXiv:2405.21060.

Chunked SSD: within-chunk quadratic (attention-like) plus an inter-chunk
state recurrence, here a Python loop over chunks where the reference
runs `lax.scan` (or, under `cfg.unroll_loops`, an unrolled loop of the
same sums).  Decode is an O(1) state update; the causal conv keeps its
last `conv_width - 1` inputs as a cache.  The scan and the state are
float32 whatever the model dtype.

Padded steps of the last chunk have dt = 0, so they neither add to the
state nor decay it; the intra-chunk decay matrix is
`exp(where(mask, diff, -1e30))`, an exact 0 above the diagonal.

Under tensor parallelism (a context with a mesh) a rank computes its SSM
heads [start, start + count) (`ssm_layout`, the padded even split of
`sharding.head_range`): its columns of `in_z`, `in_x` and `in_dt`, its
entries of `A_log`, `D`, `dt_bias` and `gamma` (column-parallel), the
conv over its heads' x channels and all B/C channels, and its rows of
`out` (row-parallel): `out` is its terms of the output, which the block
sums over the model group.  `in_bc` is whole on every rank (the
reference's "ssm_state" rule), so B and C are too, and a head reads
group h // (ssm_heads / ssm_groups) of them.  Each leaf's columns come
through `sharding.local_part`: the reference's spec of an SSM leaf is
often not what a rank computes (the conv weight is split along its
width at a model dim of 2 or 4, its bias evenly over all channels).  The
gated norm normalises over all `ssm_heads * ssm_head_dim` channels, so
its mean of squares is added over the model group (`_gated_norm`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Builder, rms_norm
from ..parallel import tp as tpc
from ..parallel.sharding import (ShardCtx, group_reads, head_range,
                                 leaf_specs, local_ctx, local_part)

NEG_INF = -1e30


def _groups(cfg: ModelConfig) -> int:
    g = getattr(cfg, "ssm_groups", 1) or 1
    return g


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_mamba(make: Builder, cfg: ModelConfig, prefix: str) -> Dict:
    d, din = cfg.d_model, cfg.ssm_heads * cfg.ssm_head_dim
    g, n, h = _groups(cfg), cfg.ssm_state, cfg.ssm_heads
    cc = din + 2 * g * n
    return {
        "in_z": make(f"{prefix}.in_z", (d, din), ("embed", "ssm_heads"), 1.0),
        "in_x": make(f"{prefix}.in_x", (d, din), ("embed", "ssm_heads"), 1.0),
        "in_bc": make(f"{prefix}.in_bc", (d, 2 * g * n),
                      ("embed", "ssm_state"), 1.0),
        "in_dt": make(f"{prefix}.in_dt", (d, h), ("embed", "ssm_heads"), 1.0),
        "conv_w": make(f"{prefix}.conv_w", (cfg.conv_width, cc),
                       ("conv", "ssm_heads"), 1.0),
        "conv_b": make(f"{prefix}.conv_b", (cc,), ("ssm_heads",), 0.0),
        "A_log": make(f"{prefix}.A_log", (h,), ("ssm_heads",), 0.0),
        "D": make(f"{prefix}.D", (h,), ("ssm_heads",), 0.0),
        "dt_bias": make(f"{prefix}.dt_bias", (h,), ("ssm_heads",), 0.0),
        "gamma": make(f"{prefix}.gamma", (din,), ("ssm_heads",), 0.0),
        "out": make(f"{prefix}.out", (din, d), ("ssm_heads", "embed"), 1.0),
    }


def ssm_layout(cfg: ModelConfig, ctx: ShardCtx):
    """(start, count, groups) of this rank's SSM heads [start, start +
    count) (`sharding.head_range`) and the B/C groups they read, in the
    form `ssd_scan` takes (`sharding.group_reads`; None where they are
    all the groups of all the heads, as without a mesh)."""
    h = cfg.ssm_heads
    start, count = head_range(h, ctx)
    if count == h:
        return start, count, None
    return start, count, group_reads(start, count, h // _groups(cfg))


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None,
                   ctx: Optional[ShardCtx] = None) -> Dict:
    """The SSM state (B, heads, head_dim, state), float32, and the conv's
    last `conv_width - 1` inputs.  Under a mesh they hold the rank's
    heads (`ssm_layout`): the state of its heads, the conv inputs of its
    heads' x channels, then of all B/C channels.  (The reference's cache
    specs split the conv inputs evenly over all channels instead: a
    layout of the same values.)"""
    g, n = _groups(cfg), cfg.ssm_state
    _, count, _ = ssm_layout(cfg, local_ctx() if ctx is None else ctx)
    cc = count * cfg.ssm_head_dim + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cc), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, count, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def ssd_scan(x, dt, A, B, C, chunk: int,
             init_state: Optional[torch.Tensor] = None):
    """x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n).

    Returns (y:(b,s,h,p), final_state:(b,h,p,n)) — fp32 state."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    out_dtype = x.dtype
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk
    l = chunk

    xb = x.reshape(b, nc, l, h, p).float()
    dtb = dt.reshape(b, nc, l, h).float()
    Bb = B.reshape(b, nc, l, g, n).float()
    Cb = C.reshape(b, nc, l, g, n).float()
    A32 = A.float()

    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ii = torch.arange(l, device=x.device)
    mask = (ii[:, None] >= ii[None, :])[None, :, :, None, None]
    ys = []
    for i in range(nc):
        xc, dtc, Bc, Cc = xb[:, i], dtb[:, i], Bb[:, i], Cb[:, i]
        dA = dtc * A32                  # (b,l,h) — negative
        cs = torch.cumsum(dA, dim=1)    # inclusive
        # inter-chunk: y_i += C_i . state0 decayed to i
        state_g = state.reshape(b, g, hg, p, n)
        y_inter = torch.einsum("blgn,bghpn->blghp", Cc, state_g)
        y_inter = y_inter.reshape(b, l, h, p) * torch.exp(cs)[..., None]
        # intra-chunk quadratic
        scores = torch.einsum("bign,bjgn->bijg", Cc, Bc)        # (b,l,l,g)
        csr = cs.reshape(b, l, g, hg)
        diff = csr[:, :, None] - csr[:, None]                   # (b,i,j,g,hg)
        L = torch.exp(torch.where(mask, diff, NEG_INF))
        xdt = (xc * dtc[..., None]).reshape(b, l, g, hg, p)
        y_intra = torch.einsum("bijg,bijgq,bjgqp->bigqp",
                               scores, L, xdt).reshape(b, l, h, p)
        # state update
        decay_last = torch.exp(cs[:, -1])                       # (b,h)
        decay_g = torch.exp(cs[:, -1][:, None] - cs             # (b,l,h)
                            ).reshape(b, l, g, hg)
        contrib = torch.einsum("blgq,blgn,blgqp->bgqpn",
                               decay_g, Bc, xdt).reshape(b, h, p, n)
        state = state * decay_last[..., None, None] + contrib
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(b, sp, h, p)[:, :s]
    return y.to(out_dtype), state


def ssd_step(state, x, dt, A, B, C):
    """One decode step. state:(b,h,p,n) x:(b,h,p) dt:(b,h) B,C:(b,g,n)."""
    b, h, p, n = state.shape
    g = B.shape[1]
    hg = h // g
    da = torch.exp(dt.float() * A.float())                        # (b,h)
    Bh = B.repeat_interleave(hg, dim=1).float()                   # (b,h,n)
    Ch = C.repeat_interleave(hg, dim=1).float()
    inc = torch.einsum("bh,bhn,bhp->bhpn", dt.float(), Bh, x.float())
    state = state * da[..., None, None] + inc
    y = torch.einsum("bhn,bhpn->bhp", Ch, state)
    return state, y.to(x.dtype)


# ---------------------------------------------------------------------------
# full mixer
# ---------------------------------------------------------------------------

def _causal_conv(xbc, w, bias, cache: Optional[torch.Tensor]):
    """xbc:(b,s,cc), w:(width,cc). Returns (out, new_cache)."""
    b, s, cc = xbc.shape
    width = w.shape[0]
    if cache is None:
        padded = F.pad(xbc, (0, 0, width - 1, 0))
        new_cache = None
    else:
        padded = torch.cat([cache.to(xbc.dtype), xbc], dim=1)
        new_cache = padded[:, -(width - 1):] if width > 1 else cache
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + padded[:, i:i + s] * w[i].to(xbc.dtype)
    out = out + bias.to(xbc.dtype)
    return F.silu(out), new_cache


def _gated_norm(y: torch.Tensor, gamma: torch.Tensor, eps: float,
                ctx: ShardCtx, width: int) -> torch.Tensor:
    """`rms_norm` of y (B, S, w), the rank's w of all `width` channels,
    over all of them: the rank's mean of squares weighted by w / width,
    summed over the model group (`tp.reduce`).  At one rank the weight is
    1.0 and the sum a copy, so the result is `rms_norm`'s bit for bit."""
    if ctx.mesh is None:
        return rms_norm(y, gamma, eps)
    dt = y.dtype
    y32 = y.float()
    sq = torch.square(y32)
    if y.shape[-1]:
        part = torch.mean(sq, dim=-1, keepdim=True) * (y.shape[-1] / width)
    else:
        part = sq.sum(-1, keepdim=True)     # no channels here: zeros
    var = tpc.reduce(part, ctx.tp_group)
    out = y32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(dt)


def apply_mamba(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor,
                cache: Optional[Dict] = None,
                ctx: Optional[ShardCtx] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B,S,d), the whole sequence on every rank.  Returns (out,
    new_cache); under a mesh `out` is the rank's terms of the output
    and the cache holds its heads (module docstring)."""
    ctx = local_ctx() if ctx is None else ctx
    dt_ = x.dtype
    b, s, d = x.shape
    h, pdim, g, n = (cfg.ssm_heads, cfg.ssm_head_dim, _groups(cfg),
                     cfg.ssm_state)
    din = h * pdim
    start, count, groups = ssm_layout(cfg, ctx)
    c0, cn = start * pdim, count * pdim         # the rank's x channels
    specs = leaf_specs(init_mamba, cfg, ctx)
    even = h % ctx.tp_size == 0

    def part(name, dim, lo, size):
        return local_part(p[name], specs[name], dim, lo, size, ctx, even)

    def conv_part(name):
        # the rank's x channels, then every B/C channel
        w = local_part(p[name], specs[name], p[name].ndim - 1, 0,
                       din + 2 * g * n, ctx)
        if cn == din:
            return w
        return torch.cat([w[..., c0:c0 + cn], w[..., din:]], dim=-1)

    z = torch.einsum("bsd,de->bse", x, part("in_z", 1, c0, cn).to(dt_))
    xs = torch.einsum("bsd,de->bse", x, part("in_x", 1, c0, cn).to(dt_))
    bc = torch.einsum("bsd,de->bse", x, p["in_bc"].to(dt_))
    dt_raw = torch.einsum("bsd,dh->bsh", x,
                          part("in_dt", 1, start, count).to(dt_))

    xbc = torch.cat([xs, bc], dim=-1)
    conv_cache = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, conv_part("conv_w"),
                                 conv_part("conv_b"), conv_cache)
    xs, Bm, Cm = (xbc[..., :cn],
                  xbc[..., cn:cn + g * n],
                  xbc[..., cn + g * n:])

    dt = F.softplus(dt_raw.float() +
                    part("dt_bias", 0, start, count).float())
    A = -torch.exp(part("A_log", 0, start, count).float())
    xh = xs.reshape(b, s, count, pdim)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)
    if groups is not None:
        idx = torch.tensor(groups, dtype=torch.long, device=x.device)
        Bm, Cm = Bm.index_select(2, idx), Cm.index_select(2, idx)

    if count == 0:
        # only padded heads here: no scan; the norm's sum and `out`'s
        # empty product still hang on x, so that this rank runs the
        # model group's collectives as the others do
        y = torch.zeros_like(xh)
        new_cache = None if cache is None else {"conv": new_conv,
                                                "ssm": cache["ssm"]}
    elif cache is None:
        y, _ = ssd_scan(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
        new_cache = None
    elif s == 1:
        st, y1 = ssd_step(cache["ssm"], xh[:, 0], dt[:, 0], A,
                          Bm[:, 0], Cm[:, 0])
        y = y1[:, None]
        new_cache = {"conv": new_conv, "ssm": st}
    else:
        y, st = ssd_scan(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                         init_state=cache["ssm"])
        new_cache = {"conv": new_conv, "ssm": st}

    y = y + xh * part("D", 0, start, count).to(dt_)[None, None, :, None]
    y = y.reshape(b, s, cn)
    y = _gated_norm(y * F.silu(z), part("gamma", 0, c0, cn), cfg.norm_eps,
                    ctx, din)
    out = torch.einsum("bse,ed->bsd", y, part("out", 0, c0, cn).to(dt_))
    return out, new_cache
