"""⊕-combine of predicate density rows (paper §3.2).

Counterpart of ``repro/kernels/density_combine.py``: a ``[Q, γ_max]`` row
matrix (padded with -1) selects γ rows of the ``[rows, λ]`` density tensor per
query and folds them into ``[Q, λ]``: AND is the product, OR the sum clipped
to 1 after the last row, and padded slots contribute the ⊕-identity.
:func:`density_combine` is the single-query form, ``[γ]`` row ids → ``[λ]``.
:func:`density_combine_batch_sharded` is the wave form of a λ-sharded index:
each rank combines its own ``[rows, λ_local]`` slab for all Q queries, with
no collective, because ⊕ is elementwise in λ.

On CUDA the fold is the kernel in ``csrc/density_combine.cu`` (the single
query a Q = 1 launch of it and the sharded form a launch on the rank's slab,
each counted under its own name); on the CPU it is
:func:`density_combine_batch_plain` / :func:`density_combine_plain`.  Both
fold γ left to right in f32, like the reference's ``_combine_local`` and
``combine_densities_np``, so all agree bit for bit, and a rank's slab
combines to the matching columns of the whole index's combine.
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


def density_combine_plain(
    densities: torch.Tensor, row_ids: torch.Tensor, op: str = "and"
) -> torch.Tensor:
    """Plain PyTorch single-query fold; any device."""
    return density_combine_batch_plain(densities, row_ids[None, :], op)[0]


def _check(densities: torch.Tensor, rows: torch.Tensor, op: str, rows_dim: int) -> None:
    if op not in ("and", "or"):
        raise ValueError(f"unknown op {op!r}")
    if densities.dtype != torch.float32 or densities.dim() != 2:
        raise ValueError("densities must be a [rows, λ] float32 tensor")
    if rows.dtype != torch.int32 or rows.dim() != rows_dim:
        shape = "[γ]" if rows_dim == 1 else "[Q, γ_max]"
        raise ValueError(f"row ids must be a {shape} int32 tensor")


def density_combine(
    densities: torch.Tensor,  # [rows, λ] f32
    row_ids: torch.Tensor,  # [γ] int32, each in [0, rows)
    op: str = "and",
) -> torch.Tensor:
    """``[λ]`` ⊕-combined density of one query, bit-identical to the
    reference's ``combine_densities_np``.  Row ids must lie in ``[0, rows)``:
    :func:`repro_torch.core.density_map.combine_densities` checks them on the
    host before they reach the card."""
    _check(densities, row_ids, op, 1)
    if densities.device.type == "cpu" and row_ids.device.type == "cpu":
        return density_combine_plain(densities, row_ids, op)
    _lib.require_cuda("density_combine", densities, row_ids)
    lam = densities.shape[1]
    out = torch.empty((lam,), dtype=torch.float32, device=densities.device)
    if lam == 0:
        return out
    lib = _lib.load()
    with torch.cuda.device(densities.device):
        rc = lib.nt_density_combine(
            densities.data_ptr(), lam, row_ids.data_ptr(), row_ids.shape[0],
            int(op == "or"), out.data_ptr(), _lib.stream_of(densities),
        )
    _lib.launched("density_combine", rc)
    return out


def _launch_batch(name: str, densities: torch.Tensor, row_matrix: torch.Tensor,
                  op: str) -> torch.Tensor:
    """The batched fold on CUDA tensors, counted under ``name``."""
    _lib.require_cuda(name, densities, row_matrix)
    nq, gamma = row_matrix.shape
    lam = densities.shape[1]
    if nq > 65535:
        raise ValueError(f"{name} takes at most 65535 queries")
    out = torch.empty((nq, lam), dtype=torch.float32, device=densities.device)
    if nq == 0 or lam == 0:
        return out
    lib = _lib.load()
    with torch.cuda.device(densities.device):
        rc = lib.nt_density_combine_batch(
            densities.data_ptr(), lam, row_matrix.data_ptr(), nq, gamma,
            int(op == "or"), out.data_ptr(), _lib.stream_of(densities),
        )
    _lib.launched(name, rc)
    return out


def density_combine_batch(
    densities: torch.Tensor,  # [rows, λ] f32
    row_matrix: torch.Tensor,  # [Q, γ_max] int32, padded with -1
    op: str = "and",
) -> torch.Tensor:
    """``[Q, λ]`` ⊕-combined densities.

    Row ids must lie in ``[-1, rows)``; :func:`repro_torch.core.density_map.
    combine_densities_batch` checks them on the host before they reach the
    card.
    """
    _check(densities, row_matrix, op, 2)
    if densities.device.type == "cpu" and row_matrix.device.type == "cpu":
        return density_combine_batch_plain(densities, row_matrix, op)
    return _launch_batch("density_combine_batch", densities, row_matrix, op)


def density_combine_batch_sharded(
    densities_local: torch.Tensor,  # [rows, λ_local] f32, this rank's λ-shard
    row_matrix: torch.Tensor,  # [Q, γ_max] int32, padded with -1
    mesh=None,
    op: str = "and",
    axis: str = "data",
) -> torch.Tensor:
    """``[Q, λ_local]``: the wave's combine on this rank's slab of a λ-sharded
    index (:func:`repro_torch.core.sharded.shard_density_maps` cuts it).

    The counterpart of the reference's ``density_combine_batch_sharded``,
    whose ``shard_map`` runs #2 on each shard.  Here every rank is a process
    of its own and calls this on its own slab: the result is its λ-shard of
    the ``[Q, λ]`` combined wave, equal bit for bit to those columns of
    :func:`density_combine_batch` on the whole index.  No collective runs, so
    ``mesh`` and ``axis`` (the group the slab belongs to) are not read; they
    keep the reference's call shape.  CUDA tensors launch #2's kernel on the
    slab, counted as ``density_combine_batch_sharded``; CPU tensors take
    :func:`density_combine_batch_plain`, the reference's ``_combine_local``.
    """
    _check(densities_local, row_matrix, op, 2)
    if densities_local.device.type == "cpu" and row_matrix.device.type == "cpu":
        return density_combine_batch_plain(densities_local, row_matrix, op)
    return _launch_batch("density_combine_batch_sharded", densities_local, row_matrix, op)
