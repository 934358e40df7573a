"""One round of the device wave: combine → sort → cut → θ-stats → window.

Counterpart of ``repro/kernels/plan_wave.py``.  :func:`plan_wave` turns a
wave's ``[Q, λ]`` densities, exclusion masks and record needs into each
query's THRESHOLD prefix and TWO-PRONG window on the device:

1. **combine** — :func:`repro_torch.core.density_map.combine_densities_batch`
   (host-checked row ids), the
   :func:`repro_torch.kernels.density_combine.density_combine_batch` kernel.
2. **sort + cut** — :func:`repro_torch.core.threshold.threshold_sort_batch`
   over the exclusion-masked rows and the prefix cut :func:`_cut_batch`,
   kept as a ``[Q, λ]`` selection mask.
3. **θ-stats** — :func:`repro_torch.kernels.theta_stats.theta_wave`, one
   launch of the batched θ-statistics kernel that also takes each query's
   cut threshold θ_q from the sorted rows: how many blocks clear θ_q (≥ the
   prefix length; ties) and the record mass they hold (the §4.1
   running-threshold invariant, checked on the device).
4. **window** — :func:`repro_torch.core.two_prong.two_prong_select_batch`.

:func:`pack_plan` flattens a round into one ``int32 [Q, λ+3]`` matrix, the
round's single device→host transfer; :func:`unpack_plan` is its host-side
inverse; :func:`apply_chosen` replays the host's per-query choice onto the
device-resident exclusion mask, and :func:`join_wave_slots` seats joining
queries in slot rows.

:func:`block_gather` fetches the wave's deduplicated block union from the
device-resident ``[λ, R, ·]`` slabs: the kernel in ``csrc/block_gather.cu``
on CUDA, :func:`block_gather_plain` on the CPU.

The reference runs the combine and θ-stats of this round as jnp (its Pallas
kernels sit behind ``use_kernel=False``); the port runs its kernels on every
CUDA round, and the plain versions on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.density_map import combine_densities_batch
from repro_torch.core.threshold import threshold_sort_batch
from repro_torch.core.two_prong import two_prong_select_batch
from repro_torch.kernels import _lib
from repro_torch.kernels.theta_stats import theta_wave


class PlanWaveResult(NamedTuple):
    """One wave's plans; every tensor stays on the wave's device."""

    combined: torch.Tensor  # [Q, λ] f32 exclusion-masked combined densities
    th_mask: torch.Tensor  # [Q, λ] bool THRESHOLD selection (the prefix cut)
    n_sel: torch.Tensor  # [Q] i32 prefix length
    theta: torch.Tensor  # [Q] f32 cut threshold (density of the last selected)
    theta_count: torch.Tensor  # [Q] f32 #blocks clearing θ_q (≥ n_sel: ties)
    expected_records: torch.Tensor  # [Q] f32 record mass clearing θ_q (§4.1 τ)
    tp_start: torch.Tensor  # [Q] i32 TWO-PRONG window start (inclusive)
    tp_end: torch.Tensor  # [Q] i32 TWO-PRONG window end (exclusive)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 where none), like ``jnp.argmax``
    of a bool row; written out so no backend's tie rule is relied on."""
    n = mask.shape[1]
    pos = torch.arange(n, dtype=torch.int64, device=mask.device)[None, :]
    first = torch.where(mask, pos, n).min(dim=1).values
    return torch.where(first == n, 0, first)


def _cut_batch(sorted_d: torch.Tensor, cum: torch.Tensor, needs: torch.Tensor,
               rpb: int) -> torch.Tensor:
    """Prefix cut per row, bit-identical to the reference's ``_cut_batch``
    (the same f32 ops): the minimal prefix with ``cum·rpb >= need``, else
    every nonzero block."""
    cum_records = cum * torch.tensor(float(rpb), dtype=torch.float32, device=cum.device)
    reached = cum_records >= needs[:, None]
    any_hit = reached.any(dim=1)
    nonzero = (sorted_d > 0.0).sum(dim=1)
    return torch.where(any_hit, _first_true(reached) + 1, nonzero).to(torch.int32)


def plan_wave_from_combined(
    combined0: torch.Tensor,  # [Q, λ] f32 base combined densities (no exclusions)
    excl: torch.Tensor,  # [Q, λ] bool blocks already planned/fetched per query
    needs: torch.Tensor,  # [Q] f32 per-query record targets
    records_per_block: int,
) -> PlanWaveResult:
    """Plan one refill round on the device from an already-combined wave
    matrix (the per-round body: round 0 combines once, later rounds only
    change ``excl``)."""
    qa, lam = combined0.shape
    dev = combined0.device
    if lam == 0:  # degenerate λ=0 store: nothing to plan
        zi = torch.zeros((qa,), dtype=torch.int32, device=dev)
        zf = torch.zeros((qa,), dtype=torch.float32, device=dev)
        return PlanWaveResult(
            combined=combined0, th_mask=torch.zeros((qa, 0), dtype=torch.bool, device=dev),
            n_sel=zi, theta=zf, theta_count=zf, expected_records=zf,
            tp_start=zi, tp_end=zi,
        )
    masked = torch.where(excl, 0.0, combined0)
    si, sd, cum = threshold_sort_batch(masked)
    n_sel = _cut_batch(sd, cum, needs, records_per_block)
    # the prefix as a [Q, λ] mask: rank si[q, j] = j is selected iff j < n_sel[q]
    # (si is a permutation per row, so the scatter cannot collide)
    sel_sorted = torch.arange(lam, device=dev)[None, :] < n_sel[:, None].long()
    th_mask = torch.zeros((qa, lam), dtype=torch.bool, device=dev)
    th_mask.scatter_(1, si.long(), sel_sorted)
    theta, theta_count, expected = theta_wave(masked, sd, n_sel, records_per_block)
    tp = two_prong_select_batch(masked, needs, records_per_block)
    return PlanWaveResult(
        combined=masked,
        th_mask=th_mask,
        n_sel=n_sel,
        theta=theta,
        theta_count=theta_count,
        expected_records=expected,
        tp_start=tp.start.to(torch.int32),
        tp_end=tp.end.to(torch.int32),
    )


def plan_wave(
    densities: torch.Tensor,  # [rows, λ] f32 density tensor
    row_matrix: np.ndarray,  # [Q, γ_max] int32, padded with -1
    excl: torch.Tensor,  # [Q, λ] bool
    needs: torch.Tensor,  # [Q] f32
    records_per_block: int,
    op: str = "and",
) -> PlanWaveResult:
    """Combine, then plan: the single-shot form (round 0 of a wave)."""
    combined0 = combine_densities_batch(densities, row_matrix, op)
    return plan_wave_from_combined(combined0, excl, needs, records_per_block)


# --------------------------------------------------------------------------
# One-transfer round protocol: pack on the device, unpack on the host.
# --------------------------------------------------------------------------

def pack_plan(
    th_mask: torch.Tensor,  # [Q, λ] bool
    n_sel: torch.Tensor,  # [Q] i32
    tp_start: torch.Tensor,  # [Q] i32
    tp_end: torch.Tensor,  # [Q] i32
) -> torch.Tensor:
    """One ``int32 [Q, λ+3]`` matrix: columns ``[0:λ)`` the THRESHOLD mask,
    then ``n_sel`` and the TWO-PRONG window."""
    return torch.cat(
        [
            th_mask.to(torch.int32),
            n_sel.to(torch.int32)[:, None],
            tp_start.to(torch.int32)[:, None],
            tp_end.to(torch.int32)[:, None],
        ],
        dim=1,
    )


def unpack_plan(packed: np.ndarray, lam: int):
    """Host-side inverse of :func:`pack_plan`:
    ``(th_mask [Q, λ] bool, n_sel [Q], tp_start [Q], tp_end [Q])``."""
    packed = np.asarray(packed)
    return (
        packed[:, :lam].astype(bool),
        packed[:, lam],
        packed[:, lam + 1],
        packed[:, lam + 2],
    )


def apply_chosen(
    excl: torch.Tensor,  # [Q, λ] bool
    th_mask_prev: torch.Tensor,  # [Q, λ] bool previous round's THRESHOLD mask
    tp_prev: torch.Tensor,  # [Q, 2] i32 previous round's TWO-PRONG window
    chosen_prev: torch.Tensor,  # [Q] i8: 0=threshold, 1=two_prong, -1=no-op
) -> torch.Tensor:
    """Replay the host's per-query algo choice onto the exclusion mask: the
    fetched set is the THRESHOLD prefix, or the window minus what was
    already excluded (threshold prefixes never hold excluded blocks, whose
    density is zero)."""
    lam = excl.shape[1]
    pos = torch.arange(lam, dtype=torch.int32, device=excl.device)[None, :]
    win = (pos >= tp_prev[:, :1]) & (pos < tp_prev[:, 1:2])
    new = torch.where(
        (chosen_prev == 0)[:, None],
        th_mask_prev,
        ((chosen_prev == 1)[:, None]) & win & ~excl,
    )
    return excl | new


def join_wave_slots(
    combined0: torch.Tensor,  # [Qb, λ] f32 base combined densities
    excl: torch.Tensor,  # [Qb, λ] bool
    th_mask: torch.Tensor,  # [Qb, λ] bool previous round's THRESHOLD mask
    tp_win: torch.Tensor,  # [Qb, 2] i32 previous round's TWO-PRONG window
    idx: torch.Tensor,  # [J] int64 slot rows being (re)occupied
    rows: torch.Tensor,  # [J, λ] f32 joiners' base combined densities
    excl_rows: torch.Tensor,  # [J, λ] bool joiners' prior exclusions
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seat joining queries in slot rows of a device-resident wave: their
    base rows and prior exclusions are scattered in and the previous
    occupant's prefix cursors cleared.  Other rows are untouched, so their
    plans do not change."""
    idx = (idx,)
    return (
        combined0.index_put(idx, rows),
        excl.index_put(idx, excl_rows),
        th_mask.index_put(idx, torch.zeros_like(excl_rows)),
        tp_win.index_put(idx, torch.zeros((rows.shape[0], 2), dtype=tp_win.dtype,
                                          device=tp_win.device)),
    )


# --------------------------------------------------------------------------
# block_gather: the wave's deduplicated union in one launch per slab.
# --------------------------------------------------------------------------

_GATHER_DTYPES = (torch.int32, torch.float32, torch.int8)


def block_gather_plain(slab: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``slab[block_ids]``; any device."""
    return slab[block_ids.long()]


@_lib.no_gradient
def block_gather(slab: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """``slab[block_ids]`` for a ``[λ, R, d]`` or ``[λ, R]`` slab of int32,
    float32 or int8 and ``[U]`` int32 ids (repeats allowed, ``U = 0`` gives
    an empty result with no launch).  Ids must lie in ``[0, λ)``:
    :meth:`repro_torch.data.block_store.BlockStore.fetch` checks them
    on the host."""
    if slab.dtype not in _GATHER_DTYPES or slab.dim() not in (2, 3):
        raise ValueError("slab must be a [λ, R(, d)] int32/float32/int8 tensor")
    if block_ids.dtype != torch.int32 or block_ids.dim() != 1:
        raise ValueError("block_ids must be a [U] int32 tensor")
    if slab.device.type == "cpu" and block_ids.device.type == "cpu":
        return block_gather_plain(slab, block_ids)
    _lib.require_cuda("block_gather", slab, block_ids)
    u = block_ids.shape[0]
    out = torch.empty((u, *slab.shape[1:]), dtype=slab.dtype, device=slab.device)
    block_bytes = slab[0].numel() * slab.element_size() if slab.shape[0] else 0
    if u == 0 or block_bytes == 0:
        return out
    lib = _lib.load()
    with torch.cuda.device(slab.device):
        rc = lib.nt_block_gather(
            slab.data_ptr(), block_ids.data_ptr(), u, block_bytes,
            out.data_ptr(), _lib.stream_of(slab),
        )
    _lib.launched("block_gather", rc)
    return out
