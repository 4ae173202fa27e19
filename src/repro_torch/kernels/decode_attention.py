"""Decode attention, one query token against a KV cache masked by
per-row lengths: replaces the Pallas kernel
`repro/kernels/decode_attention.py::_decode_kernel`.

CPU tensors take `ref.decode_attention_ref`; CUDA tensors launch
`model_decode_attention`: one block per (batch x head, 256-key chunk)
reads only the keys below `lengths[b]` (each block reads the length
itself, there is no scalar prefetch) and writes a partial max, sum and
weighted v into float32 scratch that this wrapper allocates; a second
pass in the same entry point combines the chunks.  Bytes bound it.
"""
from __future__ import annotations

import torch

from . import build, ref

HEAD_DIMS = (64, 128, 192, 256)
CHUNK = 256                     # keys per block (kChunk in the source)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, 1, D); k/v: (B, H, S, D); lengths: (B,) int32 valid
    cache sizes.  Returns (B, H, 1, D) in q's dtype."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths)
    dev = build.cuda_device("decode_attention", q)
    dt = build.float_dtype("decode_attention", q)
    B, H, _, D = q.shape
    S = k.shape[2]
    build.check("q", q, device=dev, dtype=dt, shape=(B, H, 1, D))
    build.check("k", k, device=dev, dtype=dt, shape=(B, H, S, D))
    build.check("v", v, device=dev, dtype=dt, shape=(B, H, S, D))
    build.check("lengths", lengths, device=dev, dtype=torch.int32,
                shape=(B,))
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {D}; the kernel "
                         f"takes {HEAD_DIMS}")
    if min(B, H, S) < 1 or B * H > build.MAX_GRID_Y:
        raise ValueError(f"decode_attention: B={B}, H={H}, S={S}; the "
                         f"kernel takes 1 <= B*H <= {build.MAX_GRID_Y} and "
                         "a non-empty cache")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.aligned(name, t)
    # the partials are freed when this returns, before the kernel has
    # run: PyTorch's allocator hands their blocks only to later work on
    # this stream, which runs after it
    n_split = -(-S // CHUNK)
    part_m = torch.empty((B * H, n_split), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * H, n_split, D), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    build.launch("decode_attention", dt, dev, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), lengths.data_ptr(), part_m.data_ptr(),
                 part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                 B * H, H, S, D, n_split, 1.0 / D ** 0.5)
    return out
