"""Inclusive f32 prefix sums (paper §4.1-4.2), in the reference's order.

Counterpart of ``repro/kernels/window_scan.py``.  :func:`prefix_sum` scans
the last axis of a ``[λ]`` vector or a ``[Q, λ]`` matrix.  On CUDA it is the
kernel in ``csrc/window_scan.cu`` (one thread block per row); on the CPU it
is :func:`prefix_sum_plain`, which is :func:`repro_torch.core.scan.cumsum`.
Both add in the order of ``jnp.cumsum`` on JAX's CPU backend, so the kernel,
the plain version and the reference agree bit for bit: the THRESHOLD cut and
the TWO-PRONG window compare these sums with k, and plans must match.
"""
from __future__ import annotations

import torch

from repro_torch.core.scan import SCAN_BASE, cumsum
from repro_torch.kernels import _lib

prefix_sum_plain = cumsum


def scratch_floats(n: int) -> int:
    """Per-row scratch of the kernel: the chunk totals of every level whose
    length exceeds :data:`SCAN_BASE` (814 floats at n = 12,208)."""
    total = 0
    while n > SCAN_BASE:
        n = -(-n // SCAN_BASE)
        total += n
    return total


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
    stride = scratch_floats(n)
    scratch = torch.empty((max(rows * stride, 1),), dtype=torch.float32, device=x.device)
    lib = _lib.load()
    with torch.cuda.device(x.device):
        rc = lib.nt_prefix_sum(
            x.data_ptr(), rows, n, out.data_ptr(), scratch.data_ptr(), stride,
            _lib.stream_of(x),
        )
    _lib.launched("prefix_sum", rc)
    return out
