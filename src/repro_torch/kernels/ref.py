"""Plain PyTorch versions of the port's thirteen kernels: the slot
engine's six and its flow-ordered segment sum, the per-packet
`jsq_route` and `plb_select`, the prefill and decode attention, and the
int8 gradient codec.

Each function computes, operation for operation, what the reference
package's jnp oracle computes, and what its CUDA kernel in
`csrc/netsim_kernels.cu` or `csrc/model_kernels.cu` computes.  The
kernel wrappers run these for tensors on the CPU; the tests and
`chip_smoke.py` hold the kernels against them.

Sums over the short trailing axes (planes, spines) run left to right
(`lsum`), the order the CUDA kernels use, so a kernel and its plain
version agree bit for bit wherever the math is + - * / min max.  Python
scalars are cast to the tensor's dtype before they meet it, as both
frameworks do, and divisions by a scalar stay true divisions (`sdiv`).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def sdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """`x / c`, correctly rounded on every device: PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal,
    which can land one ulp off the quotient; a 0-d device tensor as the
    divisor keeps a true division."""
    return x / x.new_full((), c)


def lsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis strictly left to right (contiguous
    result, whatever the layout of `x`)."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s.contiguous()


def plane_split_ref(rate, eligible, demand, *, mode: str,
                    min_rate: float = 0.0) -> torch.Tensor:
    """Fluid NIC plane split.  `rate`/`eligible`: (F, P) per-plane CC
    allowance and PLB eligibility; `demand`: (F,) offered rate.

    mode:
      'spx'   — rate-filter planes (allowance > min_rate), then weight
                by allowance.
      'dcqcn' — plane-oblivious equal split, capped by allowance.
      'agg'   — one aggregate context ('global'/'esr' NICs): min
                allowance shared equally across eligible planes.
      'swlb'  — software LB: equal split over eligible planes only.
    """
    P = rate.shape[-1]
    d = demand[:, None]
    if mode == "dcqcn":
        w = sdiv(torch.ones_like(rate), P)
        return torch.minimum(d * w, rate)
    if mode in ("swlb", "agg"):
        n_up = eligible.sum(1, keepdim=True).clamp_min(1)
        if mode == "swlb":
            return torch.where(eligible, d / n_up, 0.0)
        shared = rate.amin(1, keepdim=True)
        return torch.where(eligible, d * shared / n_up, 0.0)
    if mode != "spx":
        raise ValueError(f"unknown plane-split mode {mode!r}")
    elig = eligible & (rate > min_rate + 1e-9)
    any_ok = elig.any(1, keepdim=True)
    elig = torch.where(any_ok, elig, eligible)
    w = torch.where(elig, rate, 0.0)
    s = lsum(w)[:, None]
    w = torch.where(s > 0, w / s.clamp_min(1e-12), 1.0 / P)
    return torch.minimum(d * w, torch.where(elig, rate, 0.0))


def pair_score_softmax_ref(q, cap, w, *, nbins: int, temperature: float,
                           qmax: float = 8.0) -> torch.Tensor:
    """Quantized-JSQ spine scoring + softmax over the trailing spine
    axis.  `q`/`cap`/`w`: (..., S) summed pair queue, path capacity, and
    path weight; returns (..., S) spine fractions."""
    up = cap > 1e-9
    qbin = torch.floor(torch.clamp(sdiv(q, qmax), 0.0, 1 - 1e-9) * nbins) + 1.0
    score = qbin / w.clamp_min(1e-9)
    logit = torch.where(up, sdiv(-score, temperature), NEG_INF)
    logit = logit - logit.amax(-1, keepdim=True)
    e = torch.exp(logit)
    sums = lsum(e)[..., None]
    return torch.where(sums > 0, e / sums.clamp_min(1e-30), 0.0)


def bottleneck_ref(cap, load, *, eps: float = 1e-12) -> torch.Tensor:
    """Per-link bottleneck scaling factor min(1, cap/load)."""
    return torch.clamp_max(cap / load.clamp_min(eps), 1.0)


def queue_update_ref(q, load, cap, *, q_cap: float, eps: float = 1e-12):
    """Fluid queue integrator: one slot of (load - cap)/cap growth,
    clipped to [0, q_cap], dead links (cap <= eps) pinned to empty.
    Returns `(q_new, util)` with util = load/cap."""
    denom = cap.clamp_min(eps)
    q_new = torch.clamp(q + (load - cap) / denom, 0.0, q_cap)
    q_new = torch.where(cap <= eps, 0.0, q_new)
    return q_new, load / denom


def nic_update_ref(qmean, rate, alpha, esr, *, mode: str,
                   base_rtt_us: float, slot_us: float, ecn_thresh: float,
                   target_rtt_us: float, min_rate: float, md: float,
                   ai: float, rtt_gain: float, dcqcn_ai: float,
                   alpha_g: float):
    """Queue-derived RTT/ECN signals plus one step of the CC rate law.
    All inputs (F, P) except `esr` (F, 1) bool, ESR's extra
    multiplicative cut read only by 'agg'.  Returns
    `(rtt, ecn, rate_new, alpha_new)`; alpha changes only under 'dcqcn'.

    mode: 'spx' (per-plane AIMD with ECN-proportional cut and RTT trim;
    also swlb's law), 'dcqcn' (EWMA alpha, cut on any-plane ECN) or
    'agg' (one aggregate context across planes, 'global'/'esr')."""
    rtt = base_rtt_us + qmean * slot_us * 0.5
    ecn = torch.where(qmean > ecn_thresh,
                      torch.clamp_max(sdiv(qmean, 4 * ecn_thresh), 1.0), 0.0)
    if mode == "dcqcn":
        marked = ecn.amax(-1, keepdim=True) > 0
        alpha_new = ((1 - alpha_g) * alpha
                     + alpha_g * marked.to(alpha.dtype))
        cut = rate * (1 - sdiv(alpha_new, 2))
        grow = torch.clamp_max(rate + dcqcn_ai, 1.0)
        new = torch.clamp(torch.where(marked, cut, grow), min_rate, 1.0)
        return rtt, ecn, new, alpha_new
    if mode == "agg":
        marked = ecn.amax(-1, keepdim=True) > 0
        agg_rtt = rtt.amax(-1, keepdim=True)
        cut = rate * md
        rtt_err = sdiv(agg_rtt - target_rtt_us, target_rtt_us)
        trim = rate * (1 - rtt_gain * torch.clamp(rtt_err, 0.0, 2.0))
        grow = torch.clamp_max(rate + ai, 1.0)
        new = torch.where(marked, cut,
                          torch.where(rtt_err > 0.25, trim, grow))
        # x * 1.0 == x exactly, so cutting only where it applies is the
        # reference's multiply by where(esr & marked, 0.85, 1.0)
        new = torch.where(esr & marked, new * 0.85, new)
        return rtt, ecn, torch.clamp(new, min_rate, 1.0), alpha
    if mode != "spx":
        raise ValueError(f"unknown nic-update mode {mode!r}")
    rtt_err = sdiv(rtt - target_rtt_us, target_rtt_us)
    cut = rate * (md + (1 - md) * torch.clamp(1 - ecn, 0.0, 1.0))
    trim = rate * (1 - rtt_gain * torch.clamp(rtt_err, 0.0, 2.0))
    grow = torch.clamp_max(rate + ai, 1.0)
    new = torch.clamp(
        torch.where(ecn > 0, cut, torch.where(rtt_err > 0.25, trim, grow)),
        min_rate, 1.0)
    return rtt, ecn, new, alpha


def load_bottleneck_ref(rate, plan, cap, *, eps: float = 1e-12,
                        ordered: bool = False):
    """ECMP link loads and their bottleneck scale.  `rate`: (..., F, P)
    flow rates; `plan`: (..., P, rows, C) flow indices per link bucket
    into the lane's own F rows, padded with F (which reads an appended
    zero row); `cap`: (..., P, rows); the leading lane axes are the same
    on all three.  Returns `(load, frac)`, both (..., P, rows).
    `ordered=True` sums each bucket strictly left to right from column 0
    (flow order, float64 parity mode); `ordered=False` takes PyTorch's
    reduction."""
    *lead, F, P = rate.shape
    lead = tuple(lead)
    B = math.prod(lead)
    R, C = plan.shape[-2:]
    pad = torch.cat([rate, rate.new_zeros(lead + (1, P))], -2)
    padT = pad.reshape(B, F + 1, P).transpose(1, 2)           # (B, P, F+1)
    dev = rate.device
    g = padT[torch.arange(B, device=dev)[:, None, None, None],
             torch.arange(P, device=dev)[None, :, None, None],
             plan.reshape(B, P, R, C).long()].reshape(lead + (P, R, C))
    load = lsum(g) if ordered else g.sum(-1)
    return load, bottleneck_ref(cap, load, eps=eps)


def segment_sum_ref(vals, offsets, entries, *, acc=None) -> torch.Tensor:
    """Flow-ordered bucket sums over a CSR plan (the reference's
    `link_load.py::segment_load` and, with `acc`, `segment_load_chunk`).
    `vals`: any shape, read flat; `offsets`: (K + 1,) positions into
    `entries`, bucket k's entries being `entries[offsets[k]:offsets[k +
    1]]`; `entries`: flat indices into `vals`, each bucket's in flow
    order.  Returns the (K,) sums, each bucket's entries added one at a
    time in plan order from 0, or, with `acc` (K,), from `acc`'s value,
    in place (a chunk of the flow axis continuing the chain of the chunks
    before it).  The adds go rank by rank: the r-th entry of every bucket
    that has one, so a bucket gains one term a step and every bucket's
    chain is its own left-to-right sum, on any device (no scatter with
    repeated indices, whose order a device may choose)."""
    x = vals.reshape(-1)
    K = offsets.numel() - 1
    out = x.new_zeros(K) if acc is None else acc
    start = offsets[:-1].long()
    counts = offsets[1:].long() - start
    if K == 0:
        return out
    # buckets by entry count, longest first: the buckets with an r-th
    # entry are a prefix of this order
    by_len = torch.argsort(counts, descending=True, stable=True)
    hist = torch.bincount(counts).tolist()
    have = K
    for r in range(len(hist) - 1):
        have -= hist[r]                      # buckets with > r entries
        b = by_len[:have]
        out[b] = out[b] + x[entries[start[b] + r].long()]
    return out


_MASK32 = 0xFFFFFFFF
_HASH_MUL = 2654435761


def _hash_tie(pkt_hash, lanes: int, step: int) -> torch.Tensor:
    """(N, lanes) float32 tie-break in [0, 1): the low 16 bits of
    `mix ^ (mix >> 16)`, `mix = h * 2654435761 + lane * step` in uint32
    arithmetic, carried out in int64 (the product is split at bit 16 so
    no int64 product overflows)."""
    h = pkt_hash.to(torch.int64)[:, None] & _MASK32
    lo, hi = h & 0xFFFF, h >> 16
    hm = (lo * _HASH_MUL + (((hi * _HASH_MUL) & 0xFFFF) << 16)) & _MASK32
    lane = torch.arange(lanes, dtype=torch.int64, device=h.device)[None]
    mix = (hm + lane * step) & _MASK32
    mix = mix ^ (mix >> 16)
    return sdiv((mix & 0xFFFF).to(torch.float32), 65536.0)


def jsq_route_ref(queues, up_mask, weights, pkt_hash, *, nbins: int = 16,
                  qmax: float = 1.0) -> torch.Tensor:
    """Per-packet quantized-JSQ egress port.  `queues`/`up_mask`/
    `weights`: (ports,); `pkt_hash`: (N,) 32-bit hashes.  Returns (N,)
    int32: the first port of least score + 0.5 x hashed tie-break,
    computed in float32; down ports score 1e30."""
    q = queues.to(torch.float32)
    w = weights.to(torch.float32)
    up = up_mask.to(torch.float32) > 0
    qbin = torch.floor(torch.clamp(sdiv(q, qmax), 0.0, 1.0 - 1e-6) * nbins)
    score = (qbin + 1.0) / w.clamp_min(1e-6)
    score = torch.where(up, score, 1e30)
    tie = _hash_tie(pkt_hash, q.shape[0], 40503)
    return torch.argmin(score[None, :] + tie * 0.5, dim=1).to(torch.int32)


def plb_select_ref(rate_allow, eligible, local_queue, tx_rate,
                   pkt_hash) -> torch.Tensor:
    """Per-packet NIC plane choice (the paper's two-stage PLB).
    `rate_allow`/`eligible`/`local_queue`: (P,); `tx_rate`/`pkt_hash`:
    (N,).  Planes whose allowance covers the packet's rate (or, if none
    does, every eligible plane) compete on local queue + 1e-3 x hashed
    tie-break, in float32.  Returns (N,) int32, first index on ties."""
    rate = rate_allow.to(torch.float32)
    elig = eligible.to(torch.float32) > 0
    queue = local_queue.to(torch.float32)
    tx = tx_rate.to(torch.float32)
    ok = elig[None, :] & (rate[None, :] >= tx[:, None])
    ok = torch.where(ok.any(1, keepdim=True), ok, elig[None, :])
    tie = _hash_tie(pkt_hash, rate.shape[0], 97)
    score = torch.where(ok, queue[None, :] + 1e-3 * tie, 1e30)
    return torch.argmin(score, dim=1).to(torch.int32)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, H, Sk, D).  Softmax attention in
    float32, output in q's dtype.  The causal mask is top-left aligned
    (query i sees keys 0..i, whatever Sk is); `window > 0` keeps keys
    with q_pos - k_pos < window.  Masked scores are the finite NEG_INF,
    so a row with no key left averages v uniformly."""
    D = q.shape[-1]
    Sq, Sk = q.shape[2], k.shape[2]
    s = sdiv(torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()),
             D ** 0.5)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_bshd_ref(q, k, v, *, causal: bool = True,
                             window: int = 0) -> torch.Tensor:
    """Model layout, as the JAX package's `ops.flash_attention_bshd`:
    q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D); the kv heads are repeated to
    Hq and the result is (B, Sq, Hq, D), contiguous."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
    return out.transpose(1, 2).contiguous()


def decode_attention_ref(q, k, v, lengths) -> torch.Tensor:
    """q: (B, H, 1, D); k/v: (B, H, S, D); lengths: (B,) valid cache
    sizes.  Keys at or past `lengths[b]` score NEG_INF, so a row of
    length 0 averages v uniformly."""
    D, S = q.shape[-1], k.shape[2]
    s = sdiv(torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()),
             D ** 0.5)
    valid = (torch.arange(S, device=q.device)[None, None, None, :]
             < lengths.to(q.device)[:, None, None, None])
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def decode_attention_bshd_ref(q, k, v, lengths) -> torch.Tensor:
    """Model layout: q (B, 1, Hq, D), k/v (B, S, Hkv, D); the kv heads
    are repeated to Hq and `decode_attention_ref` runs on the (B, H, S,
    D) transposes.  Returns (B, 1, Hq, D), contiguous."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    out = decode_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), lengths)
    return out.transpose(1, 2).contiguous()


def int8_encode_ref(x, noise):
    """Per-row int8 code with stochastic rounding.  x, noise: (R, C),
    noise ~ U(-0.5, 0.5).  Returns (q int8 (R, C), scale float32
    (R, 1)): scale = max(|x| row max, 1e-12) / 127 (a true division),
    q = clip(round_half_even(x / scale + noise), -127, 127)."""
    xf = x.float()
    amax = xf.abs().amax(1, keepdim=True)
    scale = sdiv(amax.clamp_min(1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale + noise.float()), -127, 127)
    return q.to(torch.int8), scale


def int8_decode_ref(q, scale, dtype=torch.float32) -> torch.Tensor:
    """q int8 (R, C) times the per-row scale (R, 1), cast to `dtype`."""
    return (q.float() * scale.float()).to(dtype)
