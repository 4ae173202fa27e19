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

TMA reads a bf16 tensor through a descriptor whose strides must be
multiples of 16 bytes and whose base is 16-byte aligned; the wrapper
raises on any other layout rather than copy or fall back.
"""
from __future__ import annotations

import torch

from . import build, ref

HEAD_DIMS = (64, 128, 192, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, H, Sk, D).  Returns (B, H, Sq, D) in
    q's dtype (see `ref.flash_attention_ref`)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
    B, H, _, D = q.shape
    return _launch(q, k, v, (B, H, k.shape[2], D), 1, 2, causal, window)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Model layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) with Hkv
    dividing Hq.  Returns (B, Sq, Hq, D)."""
    if q.device.type == "cpu":
        return ref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                            window=window)
    B, _, _, D = q.shape
    return _launch(q, k, v, (B, k.shape[1], k.shape[2], D), 2, 1, causal,
                   window)


def _launch(q, k, v, kv_shape, h_ax, s_ax, causal, window):
    """Check the operands (k and v must have `kv_shape`) and launch the
    kernel; `h_ax`/`s_ax` are the head and sequence axes of the layout."""
    dev = build.cuda_device("flash_attention", q)
    dt = build.float_dtype("flash_attention", q)
    build.check("q", q, device=dev, dtype=dt, shape=q.shape)
    build.check("k", k, device=dev, dtype=dt, shape=kv_shape)
    build.check("v", v, device=dev, dtype=dt, shape=kv_shape)
    B, D = q.shape[0], q.shape[3]
    Hq, Sq = q.shape[h_ax], q.shape[s_ax]
    Hkv, Sk = kv_shape[h_ax], kv_shape[s_ax]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D}; the kernel takes "
                         f"{HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hkv} kv heads do not divide "
                         f"{Hq} query heads")
    if min(B, Sq, Sk) < 1 or B * Hq > build.MAX_GRID_Y:
        raise ValueError(f"flash_attention: B={B}, Hq={Hq}, Sq={Sq}, "
                         f"Sk={Sk}; the kernel takes 1 <= B*Hq <= "
                         f"{build.MAX_GRID_Y} and non-empty sequences")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.aligned(name, t)
        if dt == torch.bfloat16:
            _tma_strides(name, t)
    out = torch.empty_like(q)
    qs, ks = q.stride(), k.stride()
    build.launch("flash_attention", dt, dev, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
                 qs[0], qs[h_ax], qs[s_ax], ks[0], ks[h_ax], ks[s_ax],
                 int(bool(causal)), int(window), 1.0 / D ** 0.5)
    return out


def _tma_strides(name: str, t: torch.Tensor) -> None:
    """Raise unless TMA can read `t`: unit stride along D and every other
    stride a multiple of 8 bf16 elements (16 bytes)."""
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
        raise ValueError(f"flash_attention: {name} strides {t.stride()}; "
                         "TMA needs stride 1 along D and the others "
                         "multiples of 8 elements")
