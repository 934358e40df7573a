"""The port's public kernel API, under the reference's names.

Counterpart of ``repro/kernels/ops.py``.  Each function calls the port's
wrapper, which launches its hand-written CUDA kernel for CUDA tensors and
runs its plain PyTorch version for CPU tensors; ``flash_attention`` and
``ssd_scan`` are the LM substrate's kernels.  :func:`threshold_bisect`
is the θ-bisection THRESHOLD planner, with the reference's f32 steps in the
reference's order: on CUDA all its rounds are one launch of the
``theta_stats`` kernel (:func:`repro_torch.kernels.theta_stats.
theta_bisect`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.density_combine import density_combine, density_combine_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.plan_wave import block_gather, plan_wave
from repro_torch.kernels.ssd_chunk import ssd_scan
from repro_torch.kernels.theta_stats import (
    bisect_steps, theta_bisect, theta_stats, theta_stats_batch, theta_stats_plain,
)
from repro_torch.kernels.window_scan import prefix_sum

__all__ = [
    "density_combine", "density_combine_batch", "prefix_sum", "theta_stats",
    "theta_stats_batch", "threshold_bisect", "threshold_bisect_plain",
    "bisect_rounds", "plan_wave", "block_gather", "flash_attention", "ssd_scan",
]


def bisect_rounds(
    combined: torch.Tensor,
    k,
    records_per_block: int,
    rounds: int = 3,
    fanout: int = 16,
    stats=None,
) -> tuple[torch.Tensor, torch.Tensor, list[tuple[torch.Tensor, torch.Tensor]]]:
    """The θ-bisection of :func:`threshold_bisect`: returns ``(lo, hi,
    [(thresholds, recsum)] per round)``, where ``lo`` is θ* and ``[lo, hi)``
    the final bracket: blocks at ≥ lo hold ≥ k expected records (unless lo
    = 0) and blocks at ≥ hi fewer, so the sort-based THRESHOLD cut's
    density lies in the bracket.  ``stats=None`` runs
    :func:`~repro_torch.kernels.theta_stats.theta_bisect` (one launch on
    CUDA, the plain steps on the CPU); an explicit ``stats`` runs the
    rounds step by step over it (``theta_stats_plain`` is the plain
    version; ``theta_stats`` one launch a round)."""
    if stats is None:
        return theta_bisect(combined, k, records_per_block, rounds, fanout)
    return bisect_steps(combined, k, records_per_block, rounds, fanout, stats)


def threshold_bisect(
    combined: torch.Tensor,  # [λ] f32
    k,
    records_per_block: int,
    rounds: int = 3,
    fanout: int = 16,
) -> torch.Tensor:
    """THRESHOLD via θ-bisection (paper §4.1 invariant, one launch of the
    ``theta_stats`` kernel on CUDA): the largest θ* on the bisection grid such
    that blocks with density ≥ θ* hold ≥ k expected records (θ* = 0 if even
    all nonzero blocks cannot).  A 0-dim f32 tensor on ``combined``'s
    device.  ``recsum`` is an f32 sum in another order than the
    reference's, so θ* may differ where ``recsum·rpb`` lies within rounding
    of k."""
    return bisect_rounds(combined, k, records_per_block, rounds, fanout)[0]


def threshold_bisect_plain(
    combined: torch.Tensor, k, records_per_block: int, rounds: int = 3, fanout: int = 16
) -> torch.Tensor:
    """:func:`threshold_bisect` on the plain statistics; any device."""
    return bisect_rounds(combined, k, records_per_block, rounds, fanout,
                         stats=theta_stats_plain)[0]

