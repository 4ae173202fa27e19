"""Public entry points of the port's kernels, the counterpart of the JAX
package's `repro.kernels.ops`.

Each name dispatches on its operands' device: CPU tensors take the plain
PyTorch version (`ref`), CUDA tensors launch the hand-written kernel or
raise.  PyTorch runs eagerly, so there is nothing to jit; block-size
arguments of the Pallas entry points have no counterpart.
`flash_attention_bshd` and `decode_attention_bshd` take the model layout
and GQA by reading kv head h // (Hq / Hkv) in the kernel instead of
repeating the kv heads.
"""
from __future__ import annotations

from .decode_attention import decode_attention, decode_attention_bshd
from .flash_attention import flash_attention, flash_attention_bshd
from .int8_codec import int8_decode, int8_encode
from .jsq_route import jsq_route, pair_fractions
from .link_load import (bottleneck, bottleneck_many, bucket_load_bottleneck,
                        segment_sum, segment_sum_many)
from .plb_select import plane_split, plb_select
from .queue_ecn import nic_update, queue_update, queue_update_many

__all__ = ["bottleneck", "bottleneck_many", "bucket_load_bottleneck",
           "decode_attention", "decode_attention_bshd", "flash_attention",
           "flash_attention_bshd", "int8_decode", "int8_encode",
           "jsq_route", "nic_update", "pair_fractions", "plane_split",
           "plb_select", "queue_update", "queue_update_many",
           "segment_sum", "segment_sum_many"]
