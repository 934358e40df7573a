"""Multi-threshold statistics (paper §4.1).

Counterpart of ``repro/kernels/theta_stats.py``: for ``[Q, λ]`` combined rows
and ``[Q, T]`` per-query thresholds,

    counts[q, t] = #{b : x[q, b] >= θ[q, t]}
    recsum[q, t] = Σ_{b : x[q, b] >= θ[q, t]} x[q, b]

and :func:`theta_stats`, the same for one ``[λ]`` row and ``[T]``
thresholds (the statistics of the θ-bisection ``ops.threshold_bisect``).

On CUDA these are the kernels in ``csrc/theta_stats.cu`` (batched: one block
per query; single row: λ split over blocks, partials added in a second pass;
fixed-order reductions, no atomics); on the CPU they are
:func:`theta_stats_batch_plain` and :func:`theta_stats_plain`.
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


def theta_stats_plain(
    combined: torch.Tensor, thetas: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch single-row version; any device."""
    counts, recsum = theta_stats_batch_plain(combined[None, :], thetas[None, :])
    return counts[0], recsum[0]


def theta_stats(
    combined: torch.Tensor,  # [λ] f32
    thetas: torch.Tensor,  # [T] f32, any T >= 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts [T], recsum [T])``, both float32, of one row."""
    if combined.dtype != torch.float32 or combined.dim() != 1:
        raise ValueError("combined must be a [λ] float32 tensor")
    if thetas.dtype != torch.float32 or thetas.dim() != 1 or thetas.shape[0] < 1:
        raise ValueError("thetas must be a [T] float32 tensor with T >= 1")
    if combined.device.type == "cpu" and thetas.device.type == "cpu":
        return theta_stats_plain(combined, thetas)
    _lib.require_cuda("theta_stats", combined, thetas)
    lam, T = combined.shape[0], thetas.shape[0]
    dev = combined.device
    lib = _lib.load()
    tiles = int(lib.nt_theta_stats_tiles(lam))
    pcnt = torch.empty((max(tiles * T, 1),), dtype=torch.int32, device=dev)
    psum = torch.empty((max(tiles * T, 1),), dtype=torch.float32, device=dev)
    counts = torch.empty((T,), dtype=torch.float32, device=dev)
    recsum = torch.empty((T,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.nt_theta_stats(
            combined.data_ptr(), lam, thetas.data_ptr(), T, pcnt.data_ptr(),
            psum.data_ptr(), counts.data_ptr(), recsum.data_ptr(),
            _lib.stream_of(combined),
        )
    _lib.launched("theta_stats", rc)
    return counts, recsum
