"""THRESHOLD — density-optimal any-k block selection (paper §4.1, Algorithm 1).

Counterpart of ``repro/core/threshold.py``:

* :func:`threshold_select` — the sort + prefix-cut form for one ``[λ]`` row
  (the single-query planner): a fixed-shape id vector, -1 past
  ``num_selected``; :func:`threshold_refill` re-plans over the blocks not yet
  fetched.
* :func:`threshold_sort_batch` — the k-independent core of that form,
  batched over a ``[Q, λ]`` matrix: stable sort of ``-x`` ascending (ties by
  lower block id, as ``jnp.argsort(-x, stable=True)``), the sorted densities
  and their f32 prefix sums.
* :func:`threshold_cut` — the host-side prefix cut over one sorted row.

Prefix sums go through :func:`repro_torch.kernels.window_scan.prefix_sum`
(the scan kernel on CUDA, :func:`repro_torch.core.scan.cumsum` on the CPU),
in the reference's order, so every row and cut is bit-identical to the
reference's on the CPU.
* :func:`threshold_faithful` — Algorithm 1 line for line (numpy), copied
  from the reference as the tests' oracle.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.density_map import AND
from repro_torch.kernels.window_scan import prefix_sum


def _combine(vals: np.ndarray, op: str) -> float:
    return float(np.prod(vals)) if op == AND else float(min(np.sum(vals), 1.0))


def threshold_faithful(
    densities: np.ndarray,
    rows: np.ndarray,
    k: int,
    records_per_block: int,
    op: str = AND,
) -> list[int]:
    """Algorithm 1, line for line (host implementation).  Returns the
    selected block ids in decreasing density order."""
    dens = np.asarray(densities)[np.asarray(rows)]  # S: [gamma, lam]
    gamma, lam = dens.shape
    order = np.lexsort((np.arange(lam)[None, :].repeat(gamma, 0), -dens), axis=1)
    tau = 0.0
    R: list[int] = []
    seen: set[int] = set()
    in_R: set[int] = set()
    M: list[tuple[float, int]] = []  # max-heap via negated density, tie-break bid
    for i in range(lam):
        theta = _combine(
            np.array([dens[j, order[j, i]] for j in range(gamma)]), op
        )
        for j in range(gamma):
            bid = int(order[j, i])
            if bid not in seen:
                d = _combine(dens[:, bid], op)
                heapq.heappush(M, (-d, bid))
                seen.add(bid)
        # zero-estimated-density blocks are never fetched (§3.2)
        while M and -M[0][0] > 0 and (-M[0][0] > theta or np.isclose(-M[0][0], theta)):
            negd, bid = heapq.heappop(M)
            if bid in in_R:
                continue
            tau += (-negd) * records_per_block
            R.append(bid)
            in_R.add(bid)
            if tau >= k:
                return R
    return R


class ThresholdResult(NamedTuple):
    block_ids: torch.Tensor  # [λ] int32, density-desc order; -1 past num_selected
    num_selected: torch.Tensor  # [] int32
    expected_records: torch.Tensor  # [] f32 expected valid records in selection


def threshold_sort_batch(
    combined: torch.Tensor,  # [Q, λ] (or [λ]) f32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sort_idx int32, sorted_d f32, cum f32)`` along the last axis, each
    row bit-identical to the reference's ``_threshold_sort`` on the CPU.

    ``-x`` is sorted ascending with ``stable=True`` rather than ``x`` with
    ``descending=True``, so equal densities keep ascending block ids.  All
    densities are +0.0 or positive, so every key is -0.0 or negative and no
    +0.0/-0.0 pair can order differently in the two frameworks.
    """
    sort_idx = torch.sort(-combined, dim=-1, stable=True).indices
    sorted_d = torch.gather(combined, -1, sort_idx)
    return sort_idx.to(torch.int32), sorted_d, prefix_sum(sorted_d)


def threshold_select(
    combined: torch.Tensor, k: float, records_per_block: int
) -> ThresholdResult:
    """THRESHOLD for one ``[λ]`` row: sort by density descending, then the
    minimal prefix holding ≥ k expected records (every nonzero block if none
    does), bit-identical to the reference's ``threshold_select`` on the CPU.
    The data stays on ``combined``'s device."""
    lam = combined.shape[0]
    dev = combined.device
    if lam == 0:
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return ThresholdResult(combined.to(torch.int32), z, torch.zeros((), device=dev))
    sort_idx, sorted_d, cum = threshold_sort_batch(combined)
    cum_records = cum * torch.tensor(float(records_per_block), dtype=torch.float32, device=dev)
    reached = cum_records >= torch.tensor(float(k), dtype=torch.float32, device=dev)
    pos = torch.arange(lam, device=dev)
    first_hit = torch.where(reached, pos, lam).min()
    n_sel = torch.where(reached.any(), first_hit + 1, (sorted_d > 0.0).sum()).to(torch.int32)
    ids = torch.where(pos < n_sel, sort_idx, -1)
    exp = torch.where(n_sel > 0, cum_records[(n_sel.long() - 1).clamp(min=0)], 0.0)
    return ThresholdResult(block_ids=ids, num_selected=n_sel, expected_records=exp)


def threshold_refill(
    combined: torch.Tensor,  # [λ] f32
    excluded: torch.Tensor,  # [λ] bool, blocks already fetched
    k: float,
    records_per_block: int,
) -> ThresholdResult:
    """Re-execution step (paper §4.1): THRESHOLD over the blocks not yet
    looked up."""
    return threshold_select(torch.where(excluded, 0.0, combined), k, records_per_block)


def threshold_cut(
    sorted_d: np.ndarray, cum: np.ndarray, k: float, records_per_block: int
) -> int:
    """Host-side prefix cutoff over one presorted row: the minimal prefix
    with ``cum·rpb >= k``, else every nonzero block."""
    cum_records = cum * np.float32(records_per_block)
    reached = cum_records >= np.float32(k)
    if reached.any():
        return int(np.argmax(reached)) + 1
    return int(np.sum(sorted_d > 0.0))
