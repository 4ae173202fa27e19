"""Per-row int8 gradient codec with stochastic rounding:

  * `int8_encode` replaces the Pallas kernel
    `repro/kernels/int8_codec.py::_encode_kernel`.  CPU tensors take
    `ref.int8_encode_ref`; CUDA tensors launch `model_int8_encode` (one
    block per row, which reads the row once: a max-reduce of |x|, the
    scale as a true division, rintf of x / scale + noise) in the
    instance `encode_instance` picks.
  * `int8_decode` replaces `_decode_kernel`.  CPU tensors take
    `ref.int8_decode_ref`; CUDA tensors launch `model_int8_decode`.

Both move a few bytes per flop, so bytes bound them.  The caller supplies
the U(-0.5, 0.5) noise, so the kernel and its plain version agree bit for
bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build, ref

# the encode kernel's instances, as `model_kernels.cu` numbers them
ENCODE_INSTANCES = ("registers", "shared", "two_pass")
ENC_THREADS = 512               # threads of an encode block, most
ENC_MAX_LOADS = 8               # the register instance's loads and
ENC_MAX_ELEMS = 16              # elements a thread, at most
# a row the shared instance stages: a block's 227 KB of shared memory
# less an mbarrier (16 bytes) and the reduce's scratch (a float for each
# of 16 warps)
ENC_ROW_BYTES = 232_448 - 16 - ENC_THREADS // 32 * 4


def encode_instance(x: torch.Tensor,
                    noise: torch.Tensor) -> Tuple[str, int]:
    """(instance, elements of x a load) of the encode kernel for these
    (R, C) operands.  A load is 16 bytes (4 float32 or 8 bfloat16) when
    C is a multiple of that and `x` and `noise` start on 16 bytes (the
    codes, which `int8_encode` allocates, always start on 16), else one
    element.  Rows of at most ENC_THREADS x ENC_MAX_LOADS loads and
    ENC_THREADS x ENC_MAX_ELEMS elements (8,192) live in registers;
    longer ones up to ENC_ROW_BYTES are staged in shared memory (by a TMA
    bulk copy when a load is 16 bytes); longer still take two passes
    over global memory, in element loads."""
    C, isz = x.shape[1], x.element_size()
    width = 16 // isz
    if C % width or x.data_ptr() % 16 or noise.data_ptr() % 16:
        width = 1
    if C // width <= ENC_THREADS * ENC_MAX_LOADS and \
            C <= ENC_THREADS * ENC_MAX_ELEMS:
        return "registers", width
    if C * isz <= ENC_ROW_BYTES:
        return "shared", width
    return "two_pass", 1


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
    instance, width = encode_instance(x, noise)
    build.launch("int8_encode", dt, dev, x.data_ptr(), noise.data_ptr(),
                 q.data_ptr(), scale.data_ptr(), R, C,
                 ENCODE_INSTANCES.index(instance), int(width > 1))
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
