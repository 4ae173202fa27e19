"""The gradient of the prefill attention: the port's plain backward
(`ref.flash_attention_bwd_ref`, the algorithm of the CUDA backward
kernel) and autograd of its plain forward (`ref.flash_attention_bshd_ref`)
against `jax.grad` of the JAX package's oracle
(`repro.kernels.ref.flash_attention_ref`, kv heads repeated as
`repro.kernels.ops.flash_attention_bshd` repeats them), on the CPU.

Inputs are float32 from numpy seeds.  The backward takes the forward's
output and log-sum-exp from the port's plain versions
(`flash_attention_bshd_ref`, `flash_attention_lse_ref`; the lse is held
to `jax.nn.logsumexp` of the oracle's scores too).  Tolerance: 1e-5 of
each gradient's largest magnitude (float32 sums over up to 200 keys in
another order).  Causal, windowed, GQA, MQA, rows that see no key, and
lengths that are not multiples of 64 (the kernel's tile).

The bf16 kernels' precision model (bf16 inputs, P and dS rounded to bf16
before their products, float32 sums) is held to the same `jax.grad` on
bf16-valued inputs within the GPU tests' bf16 bound, 1e-2 of each
gradient's largest: the rounding points fit the bound.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = 1e-5


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _jax_grads(q, k, v, dout, causal, window):
    """jax.grad of <oracle(q, k, v), dout> in the model layout."""
    rep = q.shape[2] // k.shape[2]

    def f(q, k, v):
        kr = jnp.repeat(k, rep, axis=2)
        vr = jnp.repeat(v, rep, axis=2)
        out = jref.flash_attention_ref(
            q.transpose(0, 2, 1, 3), kr.transpose(0, 2, 1, 3),
            vr.transpose(0, 2, 1, 3), causal=causal, window=window)
        return jnp.sum(out.transpose(0, 2, 1, 3) * dout)

    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _jax_lse(q, k, causal, window):
    rep = q.shape[2] // k.shape[2]
    D = q.shape[-1]
    s = jnp.einsum("bqhd,bkhd->bhqk", q, jnp.repeat(k, rep, axis=2)) \
        / (D ** 0.5)
    qp = jnp.arange(q.shape[1])[:, None]
    kp = jnp.arange(k.shape[1])[None, :]
    mask = jnp.ones(s.shape[-2:], bool)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    return jax.nn.logsumexp(jnp.where(mask, s, jref.NEG_INF), axis=-1)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# (B, Sq, Sk, Hq, Hkv, D, causal, window)
CASES = [
    (2, 64, 64, 4, 4, 16, True, 0),              # MHA, one whole tile
    (2, 70, 70, 8, 2, 16, True, 0),              # GQA 4, ragged tile
    (1, 100, 100, 8, 1, 32, True, 17),           # MQA, a window
    (1, 65, 130, 4, 2, 16, True, 0),             # Sq < Sk, top-left
    (1, 150, 70, 4, 1, 16, False, 20),           # rows that see no key
    (2, 129, 129, 4, 2, 64, False, 0),           # not causal
    (1, 200, 200, 6, 3, 16, True, 64),           # window of one tile
    (1, 130, 90, 4, 4, 8, True, 33),             # causal rows past Sk
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", CASES)
def test_plain_backward_matches_jax_grad(B, Sq, Sk, Hq, Hkv, D, causal,
                                         window):
    rng = np.random.default_rng(Sq * 31 + Sk + Hq + D)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    want = _jax_grads(*map(jnp.asarray, (q, k, v, dout)), causal=causal,
                      window=window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))

    out = ref.flash_attention_bshd_ref(tq, tk, tv, causal=causal,
                                       window=window)
    lse = ref.flash_attention_lse_ref(tq, tk, tv, causal=causal,
                                      window=window)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    _close(lse, _jax_lse(jnp.asarray(q), jnp.asarray(k), causal=causal,
                         window=window))
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse,
                                      causal=causal, window=window)
    for g, w in zip(got, want):
        _close(g, w)

    # autograd of the plain forward
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    ref.flash_attention_bshd_ref(*leaves, causal=causal,
                                 window=window).backward(tdo)
    for t, w in zip(leaves, want):
        _close(t.grad, w)

    # the ops entries on CPU tensors: the forward with its lse and the
    # backward are the plain versions
    o2, l2 = ops.flash_attention_fwd(tq, tk, tv, causal=causal,
                                     window=window)
    assert torch.equal(o2, out) and torch.equal(l2, lse)
    for g, g2 in zip(got, ops.flash_attention_bwd(
            tq, tk, tv, out, tdo, lse, causal=causal, window=window)):
        assert torch.equal(g, g2)


def _bf16_kernel_model(q, k, v, out, dout, lse, causal, window):
    """The bf16 backward kernels' precision model on the CPU: bf16
    inputs, float32 sums, P rounded to bf16 before dV += P^T dO and dS
    rounded to bf16 before dQ += dS K and dK += dS^T Q (dS itself from
    the unrounded P), each gradient rounded to bf16 once at the end."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf, kf, vf, do, of = (t.float() for t in (q, k, v, dout, out))
    kr, vr = (t.repeat_interleave(G, dim=2) for t in (kf, vf))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) / D ** 0.5
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    p = torch.where(mask.any(-1)[:, None], p, 1.0 / Sk)
    delta = (do * of).sum(-1).transpose(1, 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vr)
    ds = torch.where(mask, p * (dp - delta[..., None]), 0.0)
    pb, dsb = (t.to(torch.bfloat16).float() for t in (p, ds))
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, do)
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kr) / D ** 0.5
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qf) / D ** 0.5
    dk = dk.reshape(B, Sk, Hkv, G, D).sum(3)
    dv = dv.reshape(B, Sk, Hkv, G, D).sum(3)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (2, 64, 64, 4, 4, 64, True, 0),              # MHA, causal
    (1, 100, 100, 8, 2, 64, True, 17),           # GQA 4, a window
    (1, 150, 70, 4, 1, 64, False, 20),           # rows that see no key
    (1, 130, 130, 4, 2, 128, True, 0),           # D 128, ragged
    (1, 129, 97, 8, 1, 128, True, 33)])          # MQA 8, a window
def test_bf16_precision_model_within_the_kernel_bound(B, Sq, Sk, Hq, Hkv,
                                                      D, causal, window):
    """Rounding P and dS to bf16 before their products, with float32
    sums, keeps the gradients within the bf16 kernels' bound (1e-2 of
    each gradient's largest) of jax.grad of the oracle on the same
    bf16-valued inputs: the rounding points fit the bound."""
    rng = np.random.default_rng(Sq * 7 + Sk + Hq + D)
    q, dout = (torch.from_numpy(rng.standard_normal(
        (B, Sq, Hq, D)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (B, Sk, Hkv, D)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(2))
    want = _jax_grads(*(jnp.asarray(t.float().numpy())
                        for t in (q, k, v, dout)), causal=causal,
                      window=window)
    out = ref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                       window=window)
    lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = _bf16_kernel_model(q, k, v, out, dout, lse, causal, window)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g.float(), w, tol=1e-2)


def test_bhsd_layout_entries_match_the_model_layout():
    """`ops.flash_attention` takes (B, H, S, D) operands: its output and
    its autograd gradients are the model-layout entries' on the
    transposed tensors, transposed back (gradients within TOL)."""
    rng = np.random.default_rng(9)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 3, 50, 16)).astype(np.float32)) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, window=9)
    out.backward(do)
    bshd = [t.transpose(1, 2) for t in (q, k, v)]
    o2, lse = ops.flash_attention_fwd(*bshd, window=9)
    assert torch.equal(out.detach(), o2.transpose(1, 2))
    want = ops.flash_attention_bwd(*bshd, o2, do.transpose(1, 2), lse,
                                   window=9)
    for t, w in zip(leaves, want):
        _close(t.grad, w.transpose(1, 2))


def test_autograd_of_the_cpu_entry_reaches_every_input():
    """On CPU tensors `ops.flash_attention_bshd` is the plain version,
    whose graph autograd walks (on CUDA the kernels' Function does)."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 20, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(1, 20, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(1, 20, 2, 16, generator=g, requires_grad=True)
    ops.flash_attention_bshd(q, k, v).sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (q, k, v))
