"""Decode attention, one query token against a KV cache masked by
per-row lengths: replaces the Pallas kernel
`repro/kernels/decode_attention.py::_decode_kernel`.

Two entries launch one kernel, `model_decode_attention`:

  * `decode_attention`, the Pallas entry's layout: q (B, H, 1, D), k/v
    (B, H, S, D), contiguous.
  * `decode_attention_bshd`, the model layout: q (B, 1, Hq, D) and the
    ring cache k/v (B, S, Hkv, D) with Hkv dividing Hq, read in place
    through their strides; query head h reads kv head h // (Hq / Hkv),
    so the kv heads are never repeated (at llama3-8b a repeated cache
    of batch 4 would copy 2 GB a step).

A third, `decode_attention_bshd_lse`, launches the same passes as
`model_decode_attention_lse` (counted apart) over a rank's slots of a
ring split along S (`models.attention._split_decode`): it returns the
output in float32 and each row's log-sum-exp, and a row of length 0
reads no key (output 0, log-sum-exp -inf), where the other entries
average v; the ranks' partials then merge exactly
(`models.attention.merge_partials`).

CPU tensors take `ref.decode_attention_ref` / `ref.decode_attention_bshd_ref`
/ `ref.decode_attention_bshd_lse_ref`.
On CUDA one block per (batch x head, 256-key chunk) reads only the keys
below `lengths[b]` (each block reads the length itself, there is no
scalar prefetch) and writes a partial max, sum and weighted v into
float32 buffers that the wrapper allocates; a second pass in the same
entry point combines the chunks.  Bytes bound it.

Neither package has a decode backward (the reference's decode is
inference only), so on CUDA an input that requires grad, with grad
enabled, raises `RuntimeError` rather than return an output without
its graph.
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
    return _launch(q, k, v, lengths, dev, dt, H, H, S,
                   (q.stride(0), q.stride(1)),
                   (k.stride(0), k.stride(1), k.stride(2)),
                   (v.stride(0), v.stride(1), v.stride(2)))


def decode_attention_bshd(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Model layout: q (B, 1, Hq, D); k/v (B, S, Hkv, D) with Hkv
    dividing Hq, any strides with unit stride along D and the others
    multiples of 16 bytes; lengths (B,) int32.  Returns (B, 1, Hq, D),
    contiguous, in q's dtype."""
    if q.device.type == "cpu":
        return ref.decode_attention_bshd_ref(q, k, v, lengths)
    return _launch_bshd(q, k, v, lengths, lse=False)


def decode_attention_bshd_lse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lengths: torch.Tensor):
    """`decode_attention_bshd` with each row's log-sum-exp, over a rank's
    slots of a ring split along S: returns (out (B, 1, Hq, D) float32,
    lse (B, Hq) float32, the log-sum-exp of the scaled scores of the keys
    below lengths[b]); a row of length <= 0 reads no key and gives 0 and
    -inf."""
    if q.device.type == "cpu":
        return ref.decode_attention_bshd_lse_ref(q, k, v, lengths)
    return _launch_bshd(q, k, v, lengths, lse=True)


def _launch_bshd(q, k, v, lengths, lse: bool):
    """Check the model layout's operands and launch (`_launch`)."""
    dev = build.cuda_device("decode_attention", q)
    dt = build.float_dtype("decode_attention", q)
    B, _, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    for name, t, shape in (("q", q, (B, 1, Hq, D)), ("k", k, (B, S, Hkv, D)),
                           ("v", v, (B, S, Hkv, D))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"decode_attention: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dt} {shape} on {dev}")
        _vector_strides(name, t)
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"decode_attention: {Hkv} kv heads do not divide "
                         f"{Hq} query heads")
    return _launch(q, k, v, lengths, dev, dt, Hq, Hkv, S,
                   (q.stride(0), q.stride(2)),
                   (k.stride(0), k.stride(2), k.stride(1)),
                   (v.stride(0), v.stride(2), v.stride(1)), lse)


def _vector_strides(name: str, t: torch.Tensor) -> None:
    """Raise unless each lane's slice of a row is one aligned vector
    load: unit stride along D, every other stride a multiple of 16
    bytes (`_launch` checks the data's own alignment)."""
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1 or any(st % per16 for st in t.stride()[:-1]):
        raise ValueError(f"decode_attention: {name} strides {t.stride()}; "
                         f"the kernel needs stride 1 along D and the others "
                         f"multiples of {per16} elements")


def _launch(q, k, v, lengths, dev, dt, H, Hkv, S, q_st, k_st, v_st,
            lse: bool = False):
    """Check what both layouts share and launch: q_st = (batch, head)
    strides of q, k_st / v_st = (batch, head, sequence) strides.  With
    `lse`, the log-sum-exp entry: returns (out float32, lse (B, H)
    float32)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("decode_attention: an input requires grad, and "
                           "the decode kernel has no backward (decoding "
                           "is inference only); run it under "
                           "torch.no_grad() or torch.inference_mode()")
    B, D = q.shape[0], q.shape[-1]
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
    # row b*H + h at D
    out = torch.empty(q.shape, dtype=torch.float32 if lse else dt,
                      device=dev)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            out.data_ptr())
    tail = (B * H, H, Hkv, S, D, n_split, *q_st, *k_st, *v_st,
            1.0 / D ** 0.5)
    if not lse:
        build.launch("decode_attention", dt, dev, *head, *tail)
        return out
    row_lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    build.launch("decode_attention_lse", dt, dev, *head,
                 row_lse.data_ptr(), *tail)
    return out, row_lse
