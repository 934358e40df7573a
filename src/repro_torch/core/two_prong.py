"""TWO-PRONG — locality-optimal any-k block selection (paper §4.2, Algorithm 2).

Counterpart of ``repro/core/two_prong.py``.  The reference vmaps a scalar
planner; here the batch dimension is written out:

* :func:`two_prong_select_batch` — prefix sums, then for every start block
  the smallest end with ``c[e] >= c[i] + k`` by binary search, then the
  shortest window (ties to the smallest start).  The scan
  (:func:`repro_torch.kernels.window_scan.prefix_sum`: the scan kernel on
  CUDA) and the search (:mod:`repro_torch.core.scan`) run in the
  reference's order, so windows match even where a long f32 prefix sum is
  not monotone.
* :func:`two_prong_select` — the single-query planner, a one-row batch.
* :func:`window_search` — the search itself over any ``[Q, n]`` record
  masses, shared with the sharded TWO-PRONG's group sums.
* :func:`two_prong_faithful` — Algorithm 2 line for line in float64 (numpy),
  copied from the reference: the oracle a window is judged against at
  full size.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.scan import searchsorted_left
from repro_torch.kernels.window_scan import prefix_sum

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


def window_search(m: torch.Tensor, k: torch.Tensor) -> TwoProngResult:
    """Shortest window of columns per row of ``m`` (``[Q, n]`` f32 record
    masses) holding at least ``k[q]`` records, ties to the smallest start;
    ``(0, n)`` where no window does.  The search of
    :func:`two_prong_select_batch` (columns are blocks) and of the sharded
    TWO-PRONG (columns are G-block groups), in the reference's f32 order."""
    nq, n = m.shape
    dev = m.device
    if n == 0:
        z = torch.zeros((nq,), dtype=torch.int64, device=dev)
        return TwoProngResult(z, z, torch.zeros((nq,), dtype=torch.float32, device=dev))
    c = torch.nn.functional.pad(prefix_sum(m), (1, 0))  # [Q, n+1], c[:, 0] = 0
    targets = c[:, :-1] + k.to(torch.float32)[:, None]
    ends = searchsorted_left(c, targets)  # [Q, n]
    starts = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    feasible = ends <= n
    lengths = torch.where(feasible, ends - starts, _INT32_MAX)
    shortest = lengths.min(dim=1, keepdim=True).values
    # first occurrence of the minimum == the smallest start
    best = torch.where(lengths == shortest, starts, n).min(dim=1).values
    any_feasible = feasible.any(dim=1)
    start = torch.where(any_feasible, best, 0)
    best_end = torch.gather(ends, 1, best.clamp(max=n - 1)[:, None])[:, 0]
    end = torch.where(any_feasible, best_end, n)
    exp = torch.gather(c, 1, end[:, None])[:, 0] - torch.gather(c, 1, start[:, None])[:, 0]
    return TwoProngResult(start=start, end=end, expected_records=exp)


def two_prong_select_batch(
    combined: torch.Tensor,  # [Q, λ] f32
    k: torch.Tensor,  # [Q] f32 per-query record targets
    records_per_block: int,
) -> TwoProngResult:
    """Minimal TWO-PRONG window per row, bit-identical to the reference's
    ``two_prong_select_batch`` on the CPU."""
    return window_search(combined * records_per_block, k)


def two_prong_select(
    combined: torch.Tensor, k: float, records_per_block: int
) -> TwoProngResult:
    """Single-row form: ``[λ]`` densities -> scalar window tensors."""
    kk = torch.tensor([float(k)], dtype=torch.float32, device=combined.device)
    r = two_prong_select_batch(combined[None, :], kk, records_per_block)
    return TwoProngResult(r.start[0], r.end[0], r.expected_records[0])
