"""Public entry points of the port's kernels, the counterpart of the JAX
package's `repro.kernels.ops`.

Each name dispatches on its operands' device: CPU tensors take the plain
PyTorch version (`ref`), CUDA tensors launch the hand-written kernel or
raise.  PyTorch runs eagerly, so there is nothing to jit; block-size
arguments of the Pallas entry points have no counterpart.
`flash_attention_bshd` and `decode_attention_bshd` take the model layout
and GQA by reading kv head h // (Hq / Hkv) in the kernel instead of
repeating the kv heads; `decode_attention_bshd_lse` is the decode
entry over a rank's slots of a ring split along S, with each row's
log-sum-exp.  Both flash entries are differentiable: under
grad on CUDA they run the forward kernel with its log-sum-exp and the
backward kernel (`flash_attention_fwd`, `flash_attention_bwd`).  The
decode entries are inference only and raise on CUDA when an input
requires grad.
"""
from __future__ import annotations

from .decode_attention import (decode_attention, decode_attention_bshd,
                               decode_attention_bshd_lse)
from .flash_attention import (flash_attention, flash_attention_bshd,
                              flash_attention_bwd, flash_attention_fwd)
from .int8_codec import int8_decode, int8_encode
from .jsq_route import jsq_route, pair_fractions
from .link_load import (bottleneck, bottleneck_many, bucket_load_bottleneck,
                        segment_sum, segment_sum_many)
from .plb_select import plane_split, plb_select
from .queue_ecn import nic_update, queue_update, queue_update_many

__all__ = ["bottleneck", "bottleneck_many", "bucket_load_bottleneck",
           "decode_attention", "decode_attention_bshd",
           "decode_attention_bshd_lse", "flash_attention",
           "flash_attention_bshd", "flash_attention_bwd",
           "flash_attention_fwd", "int8_decode", "int8_encode",
           "jsq_route", "nic_update", "pair_fractions", "plane_split",
           "plb_select", "queue_update", "queue_update_many",
           "segment_sum", "segment_sum_many"]
