"""Per-row int8 gradient codec with stochastic rounding:

  * `int8_encode` replaces the Pallas kernel
    `repro/kernels/int8_codec.py::_encode_kernel`.  CPU tensors take
    `ref.int8_encode_ref`; CUDA tensors launch `model_int8_encode` (one
    block per row: a max-reduce of |x|, the scale as a true division,
    rintf of x / scale + noise).
  * `int8_decode` replaces `_decode_kernel`.  CPU tensors take
    `ref.int8_decode_ref`; CUDA tensors launch `model_int8_decode`.

Both move a few bytes per flop, so bytes bound them.  The caller supplies
the U(-0.5, 0.5) noise, so the kernel and its plain version agree bit for
bit.
"""
from __future__ import annotations

import torch

from . import build, ref


def int8_encode(x: torch.Tensor, noise: torch.Tensor):
    """x: (R, C) float32 or bfloat16; noise: (R, C) float32.  Returns
    (q int8 (R, C), scale float32 (R, 1))."""
    if x.device.type == "cpu":
        return ref.int8_encode_ref(x, noise)
    dev = build.cuda_device("int8_encode", x)
    dt = build.float_dtype("int8_encode", x)
    R, C = x.shape
    build.check("x", x, device=dev, dtype=dt, shape=(R, C))
    build.check("noise", noise, device=dev, dtype=torch.float32,
                shape=(R, C))
    q = torch.empty((R, C), dtype=torch.int8, device=dev)
    scale = torch.empty((R, 1), dtype=torch.float32, device=dev)
    build.launch("int8_encode", dt, dev, x.data_ptr(), noise.data_ptr(),
                 q.data_ptr(), scale.data_ptr(), R, C)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor, *,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q: (R, C) int8; scale: (R, 1) float32.  Returns q x scale as
    `dtype` (float32 or bfloat16)."""
    if q.device.type == "cpu":
        return ref.int8_decode_ref(q, scale, dtype)
    dev = build.cuda_device("int8_decode", q)
    R, C = q.shape
    out = torch.empty((R, C), dtype=dtype, device=dev)
    build.float_dtype("int8_decode", out)
    build.check("q", q, device=dev, dtype=torch.int8, shape=(R, C))
    build.check("scale", scale, device=dev, dtype=torch.float32,
                shape=(R, 1))
    build.launch("int8_decode", dtype, dev, q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), R, C)
    return out
