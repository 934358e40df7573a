"""⊕-combine of predicate density rows (paper §3.2).

Counterpart of ``repro/kernels/density_combine.py``: a ``[Q, γ_max]`` row
matrix (padded with -1) selects γ rows of the ``[rows, λ]`` density tensor per
query and folds them into ``[Q, λ]``: AND is the product, OR the sum clipped
to 1 after the last row, and padded slots contribute the ⊕-identity.
:func:`density_combine` is the single-query form, ``[γ]`` row ids → ``[λ]``,
optionally with the single-query planner's exclusion (listed blocks set to
+0.0) fused in.
:func:`density_combine_batch_sharded` is the wave form of a λ-sharded index:
each rank combines its own ``[rows, λ_local]`` slab for all Q queries, with
no collective, because ⊕ is elementwise in λ.

On CUDA the fold is the kernels in ``csrc/density_combine.cu`` (the
batched kernel, run by the sharded form on the rank's slab, and the
single-query kernel, which takes up to 64 row ids by value in its launch
parameters and writes the exclusion in the same launch; each counted under
its own name); on the CPU it is :func:`density_combine_batch_plain` /
:func:`density_combine_plain` followed by the exclusion.  Both
fold γ left to right in f32, like the reference's ``_combine_local`` and
``combine_densities_np``, so all agree bit for bit, and a rank's slab
combines to the matching columns of the whole index's combine.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _lib

#: row ids a single-query launch carries by value (``NT_COMBINE_BY_VALUE``);
#: more are copied to the card first and read there by the same kernel
MAX_IDS_BY_VALUE = 64


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


def exclusion_ids(exclude, lam: int) -> np.ndarray:
    """Host block ids to set to +0.0, as the single-query kernel takes them:
    int32 in ``[0, λ)``, sorted ascending, without duplicates.  Negative ids
    count from the end and ids outside ``[-λ, λ)`` raise ``IndexError``, as
    in the reference's ``combined[exclude] = 0.0``."""
    ex = np.asarray(exclude, dtype=np.int64).ravel()
    if ex.size and (ex.min() < -lam or ex.max() >= lam):
        raise IndexError(f"excluded block ids out of range [-{lam}, {lam})")
    return np.unique(np.where(ex < 0, ex + lam, ex)).astype(np.int32)


def density_combine(
    densities: torch.Tensor,  # [rows, λ] f32
    row_ids: torch.Tensor,  # [γ] int32, each in [0, rows)
    op: str = "and",
    exclude=None,  # host block ids, or None
) -> torch.Tensor:
    """``[λ]`` ⊕-combined density of one query, bit-identical to the
    reference's ``combine_densities_np``; the blocks in ``exclude`` are then
    +0.0, as the reference's planner sets ``combined[exclude] = 0.0``.

    Row ids on the host are range-checked there and, on CUDA, travel by
    value in the launch parameters (up to :data:`MAX_IDS_BY_VALUE`; more
    are copied to the card); row ids on the card are read where they lie,
    unchecked (:func:`repro_torch.core.density_map.combine_densities` checks
    them on the host first).  The exclusion runs in the same launch."""
    _check(densities, row_ids, op, 1)
    lam = densities.shape[1]
    host = row_ids.device.type == "cpu"
    if host:
        rows = np.ascontiguousarray(row_ids.numpy())
        if rows.size and (rows.min() < -1 or rows.max() >= densities.shape[0]):
            raise IndexError(f"row ids out of range [-1, {densities.shape[0]})")
    ex = exclusion_ids(exclude, lam) if exclude is not None else np.zeros(0, np.int32)
    if not (densities.device.type == "cpu" and host):
        _lib.require_cuda("density_combine", densities, *(() if host else (row_ids,)))
    excl = torch.from_numpy(ex).to(densities.device) if ex.size else None
    return combine_single(densities, row_ids, excl, op)


def combine_single(densities: torch.Tensor, row_ids: torch.Tensor,
                   excl: torch.Tensor | None, op: str) -> torch.Tensor:
    """:func:`density_combine` on checked arguments: ``excl`` is an int32
    array of block ids in ``[0, λ)``, sorted, without duplicates
    (:func:`exclusion_ids`), on ``densities``' device, or None.  CPU
    tensors take the plain fold and then the exclusion; on CUDA one launch
    of the single-query kernel, host row ids by value (up to
    :data:`MAX_IDS_BY_VALUE`, else copied to the card) or device row ids
    read where they lie."""
    if densities.device.type == "cpu" and row_ids.device.type == "cpu":
        out = density_combine_plain(densities, row_ids, op)
        if excl is not None:
            out[excl.long()] = 0.0
        return out
    dev = densities.device
    lam, gamma = densities.shape[1], row_ids.shape[0]
    out = torch.empty((lam,), dtype=torch.float32, device=dev)
    if lam == 0:
        return out
    host = row_ids.device.type == "cpu"
    rows = np.ascontiguousarray(row_ids.numpy()) if host else None
    dev_rows = None if host and gamma <= MAX_IDS_BY_VALUE else row_ids.to(dev)
    lib = _lib.load()
    with torch.cuda.device(dev):
        rc = lib.nt_density_combine_excl(
            densities.data_ptr(), lam, rows.ctypes.data if dev_rows is None else None,
            None if dev_rows is None else dev_rows.data_ptr(), gamma,
            None if excl is None else excl.data_ptr(), 0 if excl is None else excl.numel(),
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
