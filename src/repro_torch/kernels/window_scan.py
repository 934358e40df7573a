"""Inclusive f32 prefix sums (paper §4.1-4.2), in the reference's order.

Counterpart of ``repro/kernels/window_scan.py``.  :func:`prefix_sum` scans
the last axis of a ``[λ]`` vector or a ``[Q, λ]`` matrix.  On CUDA it is the
kernel in ``csrc/window_scan.cu`` (a cluster of 8 thread blocks per row,
the row and its chunk levels in their shared memory; a row longer than
:data:`SMEM_MAX_N` keeps its levels in a global scratch); on the CPU it is
:func:`prefix_sum_plain`, which is :func:`repro_torch.core.scan.cumsum`.
Both add in the order of ``jnp.cumsum`` on JAX's CPU backend, so the kernel,
the plain version and the reference agree bit for bit: the THRESHOLD cut and
the TWO-PRONG window compare these sums with k, and plans must match.
"""
from __future__ import annotations

import torch

from repro_torch.core.scan import SCAN_BASE, cumsum
from repro_torch.kernels import _lib

prefix_sum_plain = cumsum


#: the longest row the kernel scans in shared memory, on a cluster of 8
#: blocks (16^4: its levels from the third on fit one warp); a longer row
#: keeps its levels in a global scratch.  The card-only tests hold it equal
#: to the library's own answer.
SMEM_MAX_N = SCAN_BASE**4


@_lib.no_gradient
def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of the last axis of a ``[λ]`` or ``[Q, λ]``
    float32 tensor, bit-identical to ``jnp.cumsum`` on JAX's CPU backend."""
    if x.dtype != torch.float32 or x.dim() not in (1, 2):
        raise ValueError("x must be a [λ] or [Q, λ] float32 tensor")
    if x.device.type == "cpu":
        return prefix_sum_plain(x)
    _lib.require_cuda("prefix_sum", x)
    rows, n = (1, x.shape[0]) if x.dim() == 1 else x.shape
    out = torch.empty_like(x)
    if rows == 0 or n == 0:
        return out
    lib = _lib.load()
    stride = lib.nt_prefix_sum_scratch_floats(n)  # 0: the row fits in shared memory
    scratch = (torch.empty((rows * stride,), dtype=torch.float32, device=x.device)
               if stride else None)
    with torch.cuda.device(x.device):
        rc = lib.nt_prefix_sum(
            x.data_ptr(), rows, n, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stride, _lib.stream_of(x),
        )
    _lib.launched("prefix_sum", rc)
    return out
