"""Batched ⊕-combine of predicate density rows (paper §3.2).

Counterpart of ``repro/kernels/density_combine.py``: a ``[Q, γ_max]`` row
matrix (padded with -1) selects γ rows of the ``[rows, λ]`` density tensor per
query and folds them into ``[Q, λ]``: AND is the product, OR the sum clipped
to 1 after the last row, and padded slots contribute the ⊕-identity.

On CUDA the fold is the kernel in ``csrc/density_combine.cu``; on the CPU it
is :func:`density_combine_batch_plain`.  Both fold γ left to right in f32,
like the reference's ``_combine_local``, so all three agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def density_combine_batch_plain(
    densities: torch.Tensor, row_matrix: torch.Tensor, op: str = "and"
) -> torch.Tensor:
    """Plain PyTorch left fold over γ; any device."""
    gamma = row_matrix.shape[1]
    rm = row_matrix.long()
    sel = densities[rm.clamp(min=0)]  # [Q, γ_max, λ]
    valid = (rm >= 0)[..., None]
    ident = 1.0 if op == "and" else 0.0
    acc = torch.full((sel.shape[0], sel.shape[2]), ident,
                     dtype=torch.float32, device=densities.device)
    for j in range(gamma):
        term = torch.where(valid[:, j], sel[:, j], ident)
        acc = acc * term if op == "and" else acc + term
    if op == "or":
        acc = acc.clamp(max=1.0)
    return acc


def density_combine_batch(
    densities: torch.Tensor,  # [rows, λ] f32
    row_matrix: torch.Tensor,  # [Q, γ_max] int32, padded with -1
    op: str = "and",
) -> torch.Tensor:
    """``[Q, λ]`` ⊕-combined densities.

    Row ids must lie in ``[-1, rows)``; :func:`repro_torch.kernels.plan_wave.
    combine_wave` checks them on the host before they reach the card.
    """
    if op not in ("and", "or"):
        raise ValueError(f"unknown op {op!r}")
    if densities.dtype != torch.float32 or densities.dim() != 2:
        raise ValueError("densities must be a [rows, λ] float32 tensor")
    if row_matrix.dtype != torch.int32 or row_matrix.dim() != 2:
        raise ValueError("row_matrix must be a [Q, γ_max] int32 tensor")
    if densities.device.type == "cpu" and row_matrix.device.type == "cpu":
        return density_combine_batch_plain(densities, row_matrix, op)
    _lib.require_cuda("density_combine_batch", densities, row_matrix)
    nq, gamma = row_matrix.shape
    lam = densities.shape[1]
    if nq > 65535:
        raise ValueError("density_combine_batch takes at most 65535 queries")
    out = torch.empty((nq, lam), dtype=torch.float32, device=densities.device)
    if nq == 0 or lam == 0:
        return out
    lib = _lib.load()
    with torch.cuda.device(densities.device):
        rc = lib.nt_density_combine_batch(
            densities.data_ptr(), lam, row_matrix.data_ptr(), nq, gamma,
            int(op == "or"), out.data_ptr(), _lib.stream_of(densities),
        )
    _lib.launched("density_combine_batch", rc)
    return out
