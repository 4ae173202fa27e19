"""Public entry points of the port's kernels, the counterpart of the JAX
package's `repro.kernels.ops`.

Each name dispatches on its operands' device: CPU tensors take the plain
PyTorch version (`ref`), CUDA tensors launch the hand-written kernel or
raise.  PyTorch runs eagerly, so there is nothing to jit; block-size
arguments of the Pallas entry points have no counterpart.  The
attention and int8-codec entry points arrive with their kernels.
"""
from __future__ import annotations

from .jsq_route import jsq_route, pair_fractions
from .link_load import bottleneck, bucket_load_bottleneck
from .plb_select import plane_split, plb_select
from .queue_ecn import nic_update, queue_update

__all__ = ["bottleneck", "bucket_load_bottleneck", "jsq_route",
           "nic_update", "pair_fractions", "plane_split", "plb_select",
           "queue_update"]
