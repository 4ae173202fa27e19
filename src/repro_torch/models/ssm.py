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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Builder, rms_norm

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


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> Dict:
    g, n = _groups(cfg), cfg.ssm_state
    din = cfg.ssm_heads * cfg.ssm_head_dim
    cc = din + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cc), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
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


def apply_mamba(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor,
                cache: Optional[Dict] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B,S,d). Returns (out, new_cache)."""
    dt_ = x.dtype
    b, s, d = x.shape
    h, pdim, g, n = (cfg.ssm_heads, cfg.ssm_head_dim, _groups(cfg),
                     cfg.ssm_state)
    din = h * pdim

    z = torch.einsum("bsd,de->bse", x, p["in_z"].to(dt_))
    xs = torch.einsum("bsd,de->bse", x, p["in_x"].to(dt_))
    bc = torch.einsum("bsd,de->bse", x, p["in_bc"].to(dt_))
    dt_raw = torch.einsum("bsd,dh->bsh", x, p["in_dt"].to(dt_))

    xbc = torch.cat([xs, bc], dim=-1)
    conv_cache = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_cache)
    xs, Bm, Cm = (xbc[..., :din],
                  xbc[..., din:din + g * n],
                  xbc[..., din + g * n:])

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(b, s, h, pdim)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)

    if cache is None:
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

    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(b, s, din)
    y = rms_norm(y * F.silu(z), p["gamma"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out"].to(dt_))
    return out, new_cache
