"""⊕-combine of predicate density rows (paper §3.2).

Counterpart of ``repro/kernels/density_combine.py``: a ``[Q, γ_max]`` row
matrix (padded with -1) selects γ rows of the ``[rows, λ]`` density tensor per
query and folds them into ``[Q, λ]``: AND is the product, OR the sum clipped
to 1 after the last row, and padded slots contribute the ⊕-identity.
:func:`density_combine` is the single-query form, ``[γ]`` row ids → ``[λ]``,
optionally with the single-query planner's exclusion (listed blocks set to
+0.0) fused in.
:func:`density_combine_wave` takes an op per query row and, optionally,
per-row exclusions (listed blocks set to +0.0), so a wave of AND and OR
queries is one call; :func:`density_combine_batch` is its one-op form.
:func:`density_combine_batch_sharded` / :func:`density_combine_wave_sharded`
are the wave forms of a λ-sharded index: each rank combines its own
``[rows, λ_local]`` slab for all Q queries, with no collective, because ⊕
is elementwise in λ.

On CUDA the fold is the kernels in ``csrc/density_combine.cu``: the wave
kernel (every batched and sharded form, counted as
``density_combine_batch`` or ``density_combine_batch_sharded``), which
takes the wave's ops and row ids by value in its launch parameters and
the exclusion as one CSR list in the same launch, and the single-query
kernel, which takes up to 64 row ids by value and writes the exclusion in
the same launch (``density_combine``).  On the CPU it is
:func:`density_combine_wave_plain` / :func:`density_combine_plain`
followed by the exclusion.  Both fold γ left to right in f32, like the
reference's ``_combine_local`` and ``combine_densities_np``, so all agree
bit for bit, and a rank's slab combines to the matching columns of the
whole index's combine.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _lib

#: row ids a single-query launch carries by value (``NT_COMBINE_BY_VALUE``);
#: more are copied to the card first and read there by the same kernel
MAX_IDS_BY_VALUE = 64
#: int32s of a wave's table (ops ``[Q]``, then row ids ``[Q, γ]``) a wave
#: launch carries by value (``NT_WAVE_BY_VALUE``); a larger table is copied
#: to the card first and read there by the same kernel
WAVE_BY_VALUE = 896


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
    return exclusion_csr([exclude], lam)[2:]


@_lib.no_gradient
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


def exclusion_csr(excludes, lam: int) -> np.ndarray:
    """Per-row host block ids to set to +0.0, as the wave kernel takes them:
    one int32 array of ``Q + 1`` row offsets, then each row's ids in ``[0,
    λ)``, ascending, without duplicates.  Negative ids count from the end
    and ids outside ``[-λ, λ)`` raise ``IndexError``, as in
    :func:`exclusion_ids`.  One sort for the whole wave."""
    parts = [np.asarray(e, dtype=np.int64).ravel() for e in excludes]
    nq = len(parts)
    flat = np.concatenate(parts) if nq else np.zeros(0, np.int64)
    if flat.size and (flat.min() < -lam or flat.max() >= lam):
        raise IndexError(f"excluded block ids out of range [-{lam}, {lam})")
    off = np.zeros(nq + 1, np.int64)
    if not flat.size:
        return off.astype(np.int32)
    row = np.repeat(np.arange(nq, dtype=np.int64), [p.size for p in parts])
    key = np.unique(row * lam + np.where(flat < 0, flat + lam, flat))
    np.cumsum(np.bincount(key // lam, minlength=nq), out=off[1:])
    if off[-1] > np.iinfo(np.int32).max:
        raise ValueError("the exclusion list holds more than 2^31 - 1 ids")
    return np.concatenate([off, key % lam]).astype(np.int32)


def density_combine_wave_plain(
    densities: torch.Tensor, row_matrix: torch.Tensor, is_or: torch.Tensor,
    excl: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`density_combine_wave`: each row's left
    fold under its op (``is_or`` ``[Q]`` bool), then the CSR exclusion
    ``excl`` (:func:`exclusion_csr`, or None) set to +0.0; any device."""
    out = density_combine_batch_plain(densities, row_matrix, "and")
    is_or = is_or.to(out.device)
    if bool(is_or.any()):
        out = torch.where(is_or[:, None], density_combine_batch_plain(densities, row_matrix, "or"),
                          out)
    if excl is not None:
        nq = row_matrix.shape[0]
        off = excl[:nq + 1].long()
        rows = torch.repeat_interleave(torch.arange(nq, device=off.device), off.diff())
        out[rows.to(out.device), excl[nq + 1:].long().to(out.device)] = 0.0
    return out


def _combine_wave(name: str, densities: torch.Tensor, row_matrix: torch.Tensor, ops,
                  exclude) -> torch.Tensor:
    """The wave's fold, each row under its own op, counted under ``name``.
    Host row ids are range-checked here; on CUDA the ops and ids travel by
    value in the launch (up to :data:`WAVE_BY_VALUE` int32s, else copied to
    the card) and the exclusion as one CSR list, all in one launch."""
    if densities.dtype != torch.float32 or densities.dim() != 2:
        raise ValueError("densities must be a [rows, λ] float32 tensor")
    if row_matrix.dtype != torch.int32 or row_matrix.dim() != 2:
        raise ValueError("row ids must be a [Q, γ_max] int32 tensor")
    nq, gamma = row_matrix.shape
    ops = list(ops)
    if len(ops) != nq or any(op not in ("and", "or") for op in ops):
        raise ValueError(f"ops must give 'and' or 'or' for each of the {nq} rows")
    if exclude is not None and len(exclude) != nq:
        raise ValueError(f"exclude must give a list of block ids for each of the {nq} rows")
    lam = densities.shape[1]
    host = row_matrix.device.type == "cpu"
    if host:
        rows = np.ascontiguousarray(row_matrix.numpy())
        if rows.size and (rows.min() < -1 or rows.max() >= densities.shape[0]):
            raise IndexError(f"row ids out of range [-1, {densities.shape[0]})")
    is_or = np.asarray([op == "or" for op in ops], dtype=np.int32)
    csr = exclusion_csr(exclude, lam) if exclude is not None else None
    if csr is not None and csr.size == nq + 1:
        csr = None  # nothing excluded
    if densities.device.type == "cpu" and host:
        return density_combine_wave_plain(densities, row_matrix, torch.from_numpy(is_or) > 0,
                                          None if csr is None else torch.from_numpy(csr))
    _lib.require_cuda(name, densities, *(() if host else (row_matrix,)))
    dev = densities.device
    out = torch.empty((nq, lam), dtype=torch.float32, device=dev)
    if nq == 0 or lam == 0:
        return out
    if host:
        tab = np.concatenate([is_or, rows.ravel()])
        dev_tab = None if tab.size <= WAVE_BY_VALUE else torch.from_numpy(tab).to(dev)
    else:
        tab, dev_tab = None, torch.cat([torch.from_numpy(is_or).to(dev), row_matrix.reshape(-1)])
    excl = None if csr is None else torch.from_numpy(csr).to(dev)
    lib = _lib.load()
    with torch.cuda.device(dev):
        rc = lib.nt_density_combine_wave(
            densities.data_ptr(), lam, tab.ctypes.data if dev_tab is None else None,
            None if dev_tab is None else dev_tab.data_ptr(), nq, gamma,
            None if excl is None else excl.data_ptr(), out.data_ptr(), _lib.stream_of(densities),
        )
    _lib.launched(name, rc)
    return out


@_lib.no_gradient
def density_combine_wave(
    densities: torch.Tensor,  # [rows, λ] f32
    row_matrix: torch.Tensor,  # [Q, γ_max] int32, padded with -1
    ops,  # Q of "and" / "or"
    exclude=None,  # Q lists of host block ids, or None
) -> torch.Tensor:
    """``[Q, λ]``: row q is the ⊕-combine of its row ids under ``ops[q]``,
    bit-identical to :func:`density_combine_batch` of its op, and then the
    blocks in ``exclude[q]`` are +0.0, as the host mirror's ``where(excl,
    0.0, combined)``.  Negative block ids count from the end, as in numpy
    indexing.  On CUDA one launch for the whole wave, whatever its ops,
    counted as ``density_combine_batch``; on the CPU
    :func:`density_combine_wave_plain`."""
    return _combine_wave("density_combine_batch", densities, row_matrix, ops, exclude)


@_lib.no_gradient
def density_combine_batch(
    densities: torch.Tensor,  # [rows, λ] f32
    row_matrix: torch.Tensor,  # [Q, γ_max] int32, padded with -1
    op: str = "and",
) -> torch.Tensor:
    """``[Q, λ]`` ⊕-combined densities, every row under ``op``: a
    :func:`density_combine_wave` of one op.

    Row ids must lie in ``[-1, rows)``; host ids are checked here, device
    ids are read where they lie, unchecked.
    """
    _check(densities, row_matrix, op, 2)
    return _combine_wave("density_combine_batch", densities, row_matrix,
                         [op] * row_matrix.shape[0], None)


@_lib.no_gradient
def density_combine_wave_sharded(
    densities_local: torch.Tensor,  # [rows, λ_local] f32, this rank's λ-shard
    row_matrix: torch.Tensor,  # [Q, γ_max] int32, padded with -1
    ops,  # Q of "and" / "or"
    mesh=None,
    axis: str = "data",
) -> torch.Tensor:
    """:func:`density_combine_batch_sharded` with an op per row: the wave's
    combine on this rank's slab in one launch whatever its ops, counted as
    ``density_combine_batch_sharded``."""
    return _combine_wave("density_combine_batch_sharded", densities_local, row_matrix, ops, None)


@_lib.no_gradient
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
    the plain fold, the reference's ``_combine_local``.
    """
    _check(densities_local, row_matrix, op, 2)
    return _combine_wave("density_combine_batch_sharded", densities_local, row_matrix,
                         [op] * row_matrix.shape[0], None)
