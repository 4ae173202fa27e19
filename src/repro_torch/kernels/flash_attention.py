"""Fused prefill attention, causal and/or sliding-window:

  * `flash_attention` ((B, H, S, D) layout) replaces the Pallas kernel
    `repro/kernels/flash_attention.py::_flash_kernel`.  CPU tensors take
    `ref.flash_attention_ref`; CUDA tensors launch
    `model_flash_attention`.  Operations bound it (4 D flops per
    query-key pair the masks keep: 137 GFLOP, 0.139 ms at the bf16
    tensor-core peak, for a llama3-8b prefill of 4096 tokens), so bf16
    runs on the tensor cores: a warp-specialised Hopper kernel in which
    one producer thread brings Q and a two-stage ring of K and V tiles
    (128 keys at head_dim <= 128, 64 above) in by TMA and two consumer
    warpgroups (64 query rows each, 128 a block) run S = Q K^T and
    O += P V as `wgmma`, the online softmax of one tile in registers
    while the previous tile's P V is on the tensor cores, P rounded to
    bf16 (within 2e-2 of the float32 plain version).  float32 runs on
    the tensor cores too, as split "3xTF32" products (`mma.sync`): each
    operand is split into a TF32 high and low part and three TF32
    products are summed in float32, about 2^-20 of each product off,
    where one TF32 product (11 bits an operand) would miss the 1e-4
    tolerance; 128 query rows a block, K and V tiles (64 keys at
    head_dim <= 128, 16 above) double-buffered by cp.async, and S and
    each tile's P V summed in short chains joined by float32 adds.
  * `flash_attention_bshd` is the model-layout entry of
    `repro.kernels.ops`: q (B, S, Hq, D), k/v (B, S, Hkv, D).  CPU tensors
    take `ref.flash_attention_bshd_ref`, which repeats the kv heads and
    transposes as the JAX wrapper does; on the GPU the same kernel reads
    that layout through its strides and kv head h // (Hq / Hkv), so
    nothing is copied.

Both entries are differentiable: on CUDA they go through
`_FlashAttention`, a `torch.autograd.Function` whose forward launches the
kernel, which also writes the log-sum-exp of each row (`lse`, (B, Hq, Sq)
float32; `flash_attention_fwd`), and whose backward launches
`model_flash_attention_bwd` (`flash_attention_bwd`), the gradient that
the reference takes by autodiff of its pure-JAX `chunked_attention`
(none of its Pallas kernels has a backward).  Under no_grad or with no
input that requires grad the Function records no graph; writing the
log-sum-exp costs the forward no measurable time.  The backward replaces
no TPU kernel.  It is FlashAttention-2's split, three kernels under one
entry point, on the tensor cores (`mma.sync`; 10 D flops a kept pair
bound it, and the split does 14 D): a pass that takes
delta = rowsum(dO * O) a row; a block a (batch, kv head, key tile of
32-64 keys) that walks every query head of its GQA group and every query
tile the masks let see its keys, recomputes S^T = K Q^T and P^T from the
log-sum-exp and accumulates dK and dV in registers; a block a (batch,
query head, 64-row tile) that walks its key tiles and accumulates dQ.
Four warps a block own 16 output rows each, so P and dS stay in the
accumulator fragments that feed the next product.  bf16 runs m16n8k16
with P and dS rounded to bf16 there (as the forward rounds P), operands
read by `ldmatrix` from XOR-swizzled shared memory; float32 runs split
3xTF32 (m16n8k8), summed in short chains joined by float32 adds; tiles
arrive by cp.async, two stages.  No atomics: a step's gradients are
bitwise repeatable.

TMA reads a bf16 tensor through a descriptor whose strides must be
multiples of 16 bytes and whose base is 16-byte aligned; the wrapper
raises on any other layout rather than copy or fall back.
"""
from __future__ import annotations

import torch

from . import build, ref

HEAD_DIMS = (64, 128, 192, 256)
# the (head, sequence) axes of q, k and v in each layout
_AXES = {"bhsd": (1, 2), "bshd": (2, 1)}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, H, Sk, D).  Returns (B, H, Sq, D) in
    q's dtype (see `ref.flash_attention_ref`)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
    return _FlashAttention.apply(q, k, v, "bhsd", causal, window)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Model layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) with Hkv
    dividing Hq.  Returns (B, Sq, Hq, D)."""
    if q.device.type == "cpu":
        return ref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                            window=window)
    return _FlashAttention.apply(q, k, v, "bshd", causal, window)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """Model layout, as `flash_attention_bshd`: (out, lse (B, Hq, Sq)
    float32), what the backward needs.  CPU tensors take the plain
    versions."""
    if q.device.type == "cpu":
        return (ref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                             window=window),
                ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                            window=window))
    return _launch(q, k, v, "bshd", causal, window)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """Model layout: (dq, dk, dv) of the attention whose forward gave
    `out` and `lse` (`flash_attention_fwd`) for the output gradient
    `dout`, each in its input's dtype.  CPU tensors take
    `ref.flash_attention_bwd_ref`; CUDA tensors launch
    `model_flash_attention_bwd`."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                           causal=causal, window=window)
    return _launch_bwd(q, k, v, out, dout, lse, "bshd", causal, window)


class _FlashAttention(torch.autograd.Function):
    """The kernel forward (with the log-sum-exp) and the kernel
    backward, in either layout."""

    @staticmethod
    def forward(ctx, q, k, v, layout, causal, window):
        out, lse = _launch(q, k, v, layout, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (layout, causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        layout, causal, window = ctx.meta
        dq, dk, dv = _launch_bwd(q, k, v, out, dout.contiguous(), lse,
                                 layout, causal, window)
        return dq, dk, dv, None, None, None


def _check(q, k, v, layout, kernel="flash_attention"):
    """Check the operands and return (device, dtype, B, Hq, Hkv, Sq, Sk,
    D, h_ax, s_ax)."""
    h_ax, s_ax = _AXES[layout]
    dev = build.cuda_device(kernel, q)
    dt = build.float_dtype(kernel, q)
    B, D = q.shape[0], q.shape[3]
    kv_shape = list(q.shape)
    kv_shape[h_ax], kv_shape[s_ax] = k.shape[h_ax], k.shape[s_ax]
    build.check("q", q, device=dev, dtype=dt, shape=q.shape)
    build.check("k", k, device=dev, dtype=dt, shape=kv_shape)
    build.check("v", v, device=dev, dtype=dt, shape=kv_shape)
    Hq, Sq = q.shape[h_ax], q.shape[s_ax]
    Hkv, Sk = kv_shape[h_ax], kv_shape[s_ax]
    if D not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {D}; the kernel takes "
                         f"{HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{kernel}: {Hkv} kv heads do not divide "
                         f"{Hq} query heads")
    if min(B, Sq, Sk) < 1 or B * Hq > build.MAX_GRID_Y:
        raise ValueError(f"{kernel}: B={B}, Hq={Hq}, Sq={Sq}, "
                         f"Sk={Sk}; the kernel takes 1 <= B*Hq <= "
                         f"{build.MAX_GRID_Y} and non-empty sequences")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.aligned(name, t)
    return dev, dt, B, Hq, Hkv, Sq, Sk, D, h_ax, s_ax


def _strides(q, k, h_ax, s_ax):
    qs, ks = q.stride(), k.stride()
    return (qs[0], qs[h_ax], qs[s_ax], ks[0], ks[h_ax], ks[s_ax])


def _launch(q, k, v, layout, causal, window):
    """Check the operands and launch the forward: (out, lse), the
    output and each row's log-sum-exp."""
    dev, dt, B, Hq, Hkv, Sq, Sk, D, h_ax, s_ax = _check(q, k, v, layout)
    if dt == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _tma_strides(name, t)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    build.launch("flash_attention", dt, dev, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Hq, Hkv,
                 Sq, Sk, D, *_strides(q, k, h_ax, s_ax), int(bool(causal)),
                 int(window), 1.0 / D ** 0.5)
    return out, lse


def _launch_bwd(q, k, v, out, dout, lse, layout, causal, window):
    """Check the operands and launch the backward: (dq, dk, dv), laid
    out as q, k and v.  `out` and `dout` must be laid out as q."""
    dev, dt, B, Hq, Hkv, Sq, Sk, D, h_ax, s_ax = _check(
        q, k, v, layout, "flash_attention_bwd")
    for name, t in (("out", out), ("dout", dout)):
        build.check(name, t, device=dev, dtype=dt, shape=q.shape)
        build.aligned(name, t)
    build.check("lse", lse, device=dev, dtype=torch.float32,
                shape=(B, Hq, Sq))
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    build.launch("flash_attention_bwd", dt, dev, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv,
                 Sq, Sk, D, *_strides(q, k, h_ax, s_ax), int(bool(causal)),
                 int(window), 1.0 / D ** 0.5)
    return dq, dk, dv


def _tma_strides(name: str, t: torch.Tensor) -> None:
    """Raise unless TMA can read `t`: unit stride along D and every other
    stride a multiple of 8 bf16 elements (16 bytes)."""
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
        raise ValueError(f"flash_attention: {name} strides {t.stride()}; "
                         "TMA needs stride 1 along D and the others "
                         "multiples of 8 elements")
