"""Batched multi-threshold statistics (paper §4.1).

Counterpart of ``repro/kernels/theta_stats.py``: for ``[Q, λ]`` combined rows
and ``[Q, T]`` per-query thresholds,

    counts[q, t] = #{b : x[q, b] >= θ[q, t]}
    recsum[q, t] = Σ_{b : x[q, b] >= θ[q, t]} x[q, b]

On CUDA this is the kernel in ``csrc/theta_stats.cu`` (one block per query,
fixed-order reduction); on the CPU it is :func:`theta_stats_batch_plain`.
``counts`` agree exactly.  ``recsum`` adds the same f32 terms in another order
than the reference, so it agrees to rounding only: the tests hold it with
``rtol=1e-5``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

MAX_T = 8  # the kernel keeps T thresholds in registers


def theta_stats_batch_plain(
    combined: torch.Tensor, thetas: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the form of ``repro.kernels.ref.
    theta_stats_batch_ref``; any device."""
    m = combined[:, None, :] >= thetas[:, :, None]  # [Q, T, λ]
    counts = m.sum(dim=2).to(torch.float32)
    recsum = torch.where(m, combined[:, None, :], 0.0).sum(dim=2)
    return counts, recsum


def theta_stats_batch(
    combined: torch.Tensor,  # [Q, λ] f32
    thetas: torch.Tensor,  # [Q, T] f32, T <= 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts [Q, T], recsum [Q, T])``, both float32."""
    if combined.dtype != torch.float32 or combined.dim() != 2:
        raise ValueError("combined must be a [Q, λ] float32 tensor")
    if thetas.dtype != torch.float32 or thetas.dim() != 2:
        raise ValueError("thetas must be a [Q, T] float32 tensor")
    nq, lam = combined.shape
    if thetas.shape[0] != nq:
        raise ValueError("combined and thetas disagree on Q")
    if combined.device.type == "cpu" and thetas.device.type == "cpu":
        return theta_stats_batch_plain(combined, thetas)
    _lib.require_cuda("theta_stats_batch", combined, thetas)
    T = thetas.shape[1]
    if not 1 <= T <= MAX_T:
        raise ValueError(f"theta_stats_batch takes 1..{MAX_T} thresholds, got {T}")
    counts = torch.empty((nq, T), dtype=torch.float32, device=combined.device)
    recsum = torch.empty((nq, T), dtype=torch.float32, device=combined.device)
    if nq == 0:
        return counts, recsum
    lib = _lib.load()
    with torch.cuda.device(combined.device):
        rc = lib.nt_theta_stats_batch(
            combined.data_ptr(), nq, lam, thetas.data_ptr(), T,
            counts.data_ptr(), recsum.data_ptr(), _lib.stream_of(combined),
        )
    _lib.launched("theta_stats_batch", rc)
    return counts, recsum
