"""The two order-sensitive primitives of the planners, in the reference's order.

f32 prefix sums and binary searches over them decide which blocks a plan
takes, so their rounding has to match the JAX package's for the plans to
match.  ``torch.cumsum`` adds in another order than ``jnp.cumsum`` (and in
another order on the card than on the CPU), and ``torch.searchsorted`` and
``jnp.searchsorted`` can disagree where a long f32 prefix sum is not
monotone.  So the port computes both the way the reference computes them on
the CPU, with plain elementwise f32 operations that round the same on every
device:

* :func:`cumsum` — XLA's CPU lowering of ``jnp.cumsum`` (a reduce-window
  rewritten as a blocked scan, base 16): a sequential inclusive scan inside
  each 16-element chunk, the chunk totals scanned recursively the same way,
  and each chunk's exclusive offset added to it once.
* :func:`searchsorted_left` — ``jnp.searchsorted(..., side="left")``'s
  default ``"scan"`` method: ``ceil(log2(n + 1))`` halving steps of
  ``mid = (low + high) // 2``, going left where ``v <= a[mid]``.

Both work along the last axis of batched tensors.
"""
from __future__ import annotations

import math

import torch

SCAN_BASE = 16


def _sequential_inclusive(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right f32 inclusive scan of the last axis (short axes only)."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum of the last axis, bit-identical to
    ``jnp.cumsum`` on JAX's CPU backend."""
    n = x.shape[-1]
    if n <= SCAN_BASE:
        return _sequential_inclusive(x)
    m = -(-n // SCAN_BASE)
    padded = torch.nn.functional.pad(x, (0, m * SCAN_BASE - n))
    chunks = _sequential_inclusive(padded.reshape(*x.shape[:-1], m, SCAN_BASE))
    totals = cumsum(chunks[..., SCAN_BASE - 1])  # [..., m] inclusive
    offsets = torch.nn.functional.pad(totals[..., :-1], (1, 0))  # exclusive
    out = (chunks + offsets[..., None]).reshape(*x.shape[:-1], m * SCAN_BASE)
    return out[..., :n]


def searchsorted_left(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise ``jnp.searchsorted(a[i], v[i], side="left")`` (int64), the
    same halving steps in the same order, so an ``a`` that is not monotone
    gives the reference's answer too."""
    n = a.shape[-1]
    low = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    high = torch.full(v.shape, n, dtype=torch.int64, device=v.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = v <= torch.gather(a, -1, mid)
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high
