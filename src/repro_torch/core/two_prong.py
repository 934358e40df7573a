"""TWO-PRONG — locality-optimal any-k block selection (paper §4.2, Algorithm 2).

Counterpart of ``repro/core/two_prong.py``.  The reference vmaps a scalar
planner; here the batch dimension is written out:

* :func:`two_prong_select_batch` — prefix sums, then for every start block
  the smallest end with ``c[e] >= c[i] + k`` by binary search, then the
  shortest window (ties to the smallest start).  The scan and the search run
  in the reference's order (:mod:`repro_torch.core.scan`), so windows match
  even where a long f32 prefix sum is not monotone.
* :func:`two_prong_faithful` — Algorithm 2 line for line in float64 (numpy),
  copied from the reference: the oracle a window is judged against at
  full size.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.scan import cumsum, searchsorted_left

_INT32_MAX = 2**31 - 1


def two_prong_faithful(
    combined: np.ndarray, k: int, records_per_block: int
) -> tuple[int, int]:
    """Algorithm 2, line for line.  Returns ``[start, end)`` of the minimal
    window; ``(0, λ)`` when fewer than k records exist in total."""
    m = np.asarray(combined, dtype=np.float64) * records_per_block
    lam = m.shape[0]
    tau = 0.0
    start = end = 0
    min_start, min_end = 0, lam + 1  # sentinel: "no window found yet"
    while end < lam:
        while tau < k and end < lam:
            tau += m[end]
            end += 1
        while tau >= k and start < lam:
            if (end - start) < (min_end - min_start):
                min_end, min_start = end, start
            tau -= m[start]
            start += 1
    if min_end > lam:
        return 0, lam
    return min_start, min_end


class TwoProngResult(NamedTuple):
    start: torch.Tensor  # [Q] int64 inclusive
    end: torch.Tensor  # [Q] int64 exclusive
    expected_records: torch.Tensor  # [Q] f32


def two_prong_select_batch(
    combined: torch.Tensor,  # [Q, λ] f32
    k: torch.Tensor,  # [Q] f32 per-query record targets
    records_per_block: int,
) -> TwoProngResult:
    """Minimal TWO-PRONG window per row, bit-identical to the reference's
    ``two_prong_select_batch`` on the CPU."""
    nq, lam = combined.shape
    dev = combined.device
    if lam == 0:
        z = torch.zeros((nq,), dtype=torch.int64, device=dev)
        return TwoProngResult(z, z, torch.zeros((nq,), dtype=torch.float32, device=dev))
    m = combined * records_per_block
    c = torch.nn.functional.pad(cumsum(m), (1, 0))  # [Q, λ+1], c[:, 0] = 0
    targets = c[:, :-1] + k.to(torch.float32)[:, None]
    ends = searchsorted_left(c, targets)  # [Q, λ]
    starts = torch.arange(lam, dtype=torch.int64, device=dev)[None, :]
    feasible = ends <= lam
    lengths = torch.where(feasible, ends - starts, _INT32_MAX)
    shortest = lengths.min(dim=1, keepdim=True).values
    # first occurrence of the minimum == the smallest start
    best = torch.where(lengths == shortest, starts, lam).min(dim=1).values
    any_feasible = feasible.any(dim=1)
    start = torch.where(any_feasible, best, 0)
    best_end = torch.gather(ends, 1, best.clamp(max=lam - 1)[:, None])[:, 0]
    end = torch.where(any_feasible, best_end, lam)
    exp = torch.gather(c, 1, end[:, None])[:, 0] - torch.gather(c, 1, start[:, None])[:, 0]
    return TwoProngResult(start=start, end=end, expected_records=exp)


def two_prong_select(
    combined: torch.Tensor, k: float, records_per_block: int
) -> TwoProngResult:
    """Single-row form: ``[λ]`` densities -> scalar window tensors."""
    kk = torch.tensor([float(k)], dtype=torch.float32, device=combined.device)
    r = two_prong_select_batch(combined[None, :], kk, records_per_block)
    return TwoProngResult(r.start[0], r.end[0], r.expected_records[0])
