"""The port's public kernel API, under the reference's names.

Counterpart of ``repro/kernels/ops.py``.  Each function calls the port's
wrapper, which launches its hand-written CUDA kernel for CUDA tensors and
runs its plain PyTorch version for CPU tensors; ``flash_attention`` and
``ssd_scan`` are the LM substrate's kernels.  :func:`threshold_bisect`
is the θ-bisection THRESHOLD planner on :func:`theta_stats`, with the
reference's f32 steps in the reference's order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.density_combine import density_combine, density_combine_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.plan_wave import block_gather, plan_wave
from repro_torch.kernels.ssd_chunk import ssd_scan
from repro_torch.kernels.theta_stats import theta_stats, theta_stats_batch, theta_stats_plain
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
    stats=theta_stats,
) -> tuple[torch.Tensor, torch.Tensor, list[tuple[torch.Tensor, torch.Tensor]]]:
    """The θ-bisection of :func:`threshold_bisect` over ``stats``: returns
    ``(lo, hi, [(thresholds, recsum)] per round)``, where ``lo`` is θ* and
    ``[lo, hi)`` the final bracket: blocks at ≥ lo hold ≥ k expected records
    (unless lo = 0) and blocks at ≥ hi fewer, so the sort-based THRESHOLD
    cut's density lies in the bracket.  Every step is the reference's f32
    operation in its order; the data stays on ``combined``'s device (no
    host round trip between rounds)."""
    dev = combined.device
    f32 = torch.float32
    k = torch.as_tensor(k, dtype=f32, device=dev)
    lo = torch.zeros((), dtype=f32, device=dev)
    # jnp.float32(1.0) + 1e-6: the Python float is rounded to f32 first
    hi = torch.tensor(np.float32(1.0) + np.float32(1e-6), dtype=f32, device=dev)
    steps = torch.arange(fanout, dtype=f32, device=dev) + 1.0
    # a tensor divisor: CUDA divides by a Python number as a multiply by its
    # reciprocal, which rounds differently unless fanout is a power of two
    fan = torch.tensor(float(fanout), dtype=f32, device=dev)
    pos = torch.arange(fanout, device=dev)
    trace = []
    for _ in range(rounds):
        ths = lo + (hi - lo) * steps / fan
        _, recsum = stats(combined, ths)
        trace.append((ths, recsum))
        ok = recsum * records_per_block >= k  # θ small enough to reach k
        any_ok = ok.any()
        # the largest θ that still reaches k
        idx = torch.where(any_ok, torch.where(ok, pos, -1).argmax(), 0)
        new_lo = torch.where(any_ok, ths[idx], lo)
        new_hi = torch.where(
            any_ok, torch.minimum(ths[torch.clamp(idx + 1, max=fanout - 1)], hi), ths[0]
        )
        lo, hi = new_lo, torch.where(idx == fanout - 1, hi, new_hi)
    return lo, hi, trace


def threshold_bisect(
    combined: torch.Tensor,  # [λ] f32
    k,
    records_per_block: int,
    rounds: int = 3,
    fanout: int = 16,
) -> torch.Tensor:
    """THRESHOLD via θ-bisection (paper §4.1 invariant, on the
    :func:`theta_stats` kernel): the largest θ* on the bisection grid such
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

