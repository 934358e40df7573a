"""THRESHOLD — density-optimal any-k block selection (paper §4.1, Algorithm 1).

Counterpart of ``repro/core/threshold.py`` for the device wave:

* :func:`threshold_sort_batch` — the k-independent core of the sort + cut
  form, batched over a ``[Q, λ]`` matrix: stable sort of ``-x`` ascending
  (ties by lower block id, as ``jnp.argsort(-x, stable=True)``), the sorted
  densities and their f32 prefix sums (:func:`repro_torch.core.scan.cumsum`,
  in the reference's order).
* :func:`threshold_cut` — the host-side prefix cut over one sorted row.
* :func:`threshold_faithful` — Algorithm 1 line for line (numpy), copied
  from the reference as the tests' oracle.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core.density_map import AND
from repro_torch.core.scan import cumsum


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


def threshold_sort_batch(
    combined: torch.Tensor,  # [Q, λ] f32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sort_idx [Q, λ] int32, sorted_d [Q, λ] f32, cum [Q, λ] f32)``, each
    row bit-identical to the reference's ``_threshold_sort`` on the CPU.

    ``-x`` is sorted ascending with ``stable=True`` rather than ``x`` with
    ``descending=True``, so equal densities keep ascending block ids.  All
    densities are +0.0 or positive, so every key is -0.0 or negative and no
    +0.0/-0.0 pair can order differently in the two frameworks.
    """
    sort_idx = torch.sort(-combined, dim=-1, stable=True).indices
    sorted_d = torch.gather(combined, -1, sort_idx)
    return sort_idx.to(torch.int32), sorted_d, cumsum(sorted_d)


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
