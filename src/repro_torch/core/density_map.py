"""DensityMap index (paper §3).

Counterpart of ``repro/core/density_map.py``.  For every (dimension
attribute, value) pair the index stores the fraction of each block's records
that match ``A_i == V_i^j``: a dense ``[num_rows, λ]`` float32 tensor whose
rows are addressed through :class:`PredicateVocab`.  The per-row sorted
variants (paper §4.1) are built with it, as in the reference.

:func:`build_density_maps` computes the index in numpy with the reference's
operations in the reference's order, so the bytes are the same, and only
then moves it to the requested device.  The §3.2 ⊕-combine of a query's
rows runs on the index's device: :func:`combine_densities` for one query
(the ``density_combine`` kernel on CUDA, its row ids passed by value and the
planner's exclusion fused in), :func:`combine_densities_batch` for a
``[Q, γ_max]`` row matrix and :func:`combine_densities_wave` for a wave
with an op per query and, optionally, per-query exclusions (one
``density_combine_batch`` launch).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.density_combine import (
    density_combine, density_combine_batch, density_combine_wave,
)

AND = "and"
OR = "or"
PAD_ROW = -1


@dataclasses.dataclass(frozen=True)
class PredicateVocab:
    """Maps (attr_id, value) -> row index in the density tensor."""

    attr_offsets: np.ndarray  # [r+1] int64; rows of attr i are [off[i], off[i+1])
    attr_cards: np.ndarray  # [r] int64 distinct values per attribute

    @property
    def num_rows(self) -> int:
        return int(self.attr_offsets[-1])

    def row(self, attr: int, value: int) -> int:
        if not (0 <= value < self.attr_cards[attr]):
            raise ValueError(f"value {value} out of range for attr {attr}")
        return int(self.attr_offsets[attr]) + int(value)

    def rows(self, predicates: Sequence[tuple[int, int]]) -> np.ndarray:
        return np.asarray([self.row(a, v) for a, v in predicates], dtype=np.int32)


@dataclasses.dataclass
class DensityMapIndex:
    """The index: densities + sorted variants, as tensors on one device."""

    vocab: PredicateVocab
    densities: torch.Tensor  # [num_rows, λ] f32
    sorted_block_ids: torch.Tensor  # [num_rows, λ] int32, per-row desc-density order
    sorted_densities: torch.Tensor  # [num_rows, λ] f32, densities in that order
    records_per_block: int
    num_records: int

    def to(self, device: str | torch.device) -> "DensityMapIndex":
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            densities=self.densities.to(dev),
            sorted_block_ids=self.sorted_block_ids.to(dev),
            sorted_densities=self.sorted_densities.to(dev),
        )


def build_density_maps(
    dims: np.ndarray,
    cards: Sequence[int],
    records_per_block: int,
    device: str | torch.device = "cuda",
) -> DensityMapIndex:
    """Build the index from an ``[N, r]`` dimension-attribute table.

    The last block may be padded; padding matches no value, so its densities
    are fractions of ``records_per_block`` like the paper's.
    """
    dev = resolve_device(device)
    dims = np.asarray(dims)
    n, r = dims.shape
    cards = np.asarray(cards, dtype=np.int64)
    if r != len(cards):
        raise ValueError("cards length must equal number of dim attributes")
    lam = -(-n // records_per_block)  # ceil
    offsets = np.concatenate([[0], np.cumsum(cards)])
    vocab = PredicateVocab(attr_offsets=offsets, attr_cards=cards)

    dens = np.zeros((vocab.num_rows, lam), dtype=np.float32)
    block_of = np.arange(n) // records_per_block
    for attr in range(r):
        rows = offsets[attr] + dims[:, attr]
        flat = rows * lam + block_of  # 2-D histogram over (row, block)
        counts = np.bincount(flat, minlength=vocab.num_rows * lam)
        dens += counts.reshape(vocab.num_rows, lam) / float(records_per_block)
    order = np.argsort(-dens, axis=1, kind="stable").astype(np.int32)
    sdens = np.take_along_axis(dens, order, axis=1)
    return DensityMapIndex(
        vocab=vocab,
        densities=torch.from_numpy(dens).to(dev),
        sorted_block_ids=torch.from_numpy(order).to(dev),
        sorted_densities=torch.from_numpy(sdens).to(dev),
        records_per_block=records_per_block,
        num_records=n,
    )


def pack_row_matrix(vocab: PredicateVocab, predicate_lists) -> np.ndarray:
    """[(attr, value), ...] per query -> ``[Q, γ_max]`` int32 row matrix,
    right-padded with :data:`PAD_ROW` (the ⊕-identity)."""
    row_lists = [vocab.rows(p) for p in predicate_lists]
    gmax = max(max((r.size for r in row_lists), default=1), 1)
    out = np.full((len(row_lists), gmax), PAD_ROW, dtype=np.int32)
    for q, r in enumerate(row_lists):
        out[q, : r.size] = r
    return out


def combine_densities(densities: torch.Tensor, rows, op: str = AND,
                      exclude=None) -> torch.Tensor:
    """Paper §3.2 for one query: the ``[λ]`` density of the conjunction
    (AND: product) or disjunction (OR: sum clipped to 1) of the ``[γ]`` host
    row ids, on ``densities``' device; bit-identical to the reference's
    ``combine_densities_np``.  The blocks in ``exclude`` (host ids) are then
    +0.0, as the reference's planner sets them.  The ids stay on the host:
    the kernel takes them (up to 64) in its launch parameters."""
    rows = np.asarray(rows, dtype=np.int32)
    if rows.size and rows.min() < 0:
        raise IndexError("a query's row ids must be >= 0")
    return density_combine(densities, torch.from_numpy(rows), op, exclude)


def combine_densities_batch(
    densities: torch.Tensor, row_matrix: np.ndarray, op: str = AND
) -> torch.Tensor:
    """Batched §3.2 combine: a host ``[Q, γ_max]`` row matrix padded with
    :data:`PAD_ROW` -> ``[Q, λ]`` on ``densities``' device, each row
    bit-identical to its single-query combine.  The ids are range-checked
    on the host and, on CUDA, travel in the launch parameters."""
    return density_combine_batch(densities, torch.from_numpy(np.asarray(row_matrix, np.int32)),
                                 op)


def combine_densities_wave(densities: torch.Tensor, row_matrix: np.ndarray, ops,
                           exclude=None) -> torch.Tensor:
    """:func:`combine_densities_batch` with an op per query (``ops[q]``, AND
    or OR) and, optionally, each query's excluded blocks (``exclude[q]``,
    host ids) set to +0.0: one ``density_combine_batch`` launch on CUDA,
    whatever the wave's ops."""
    return density_combine_wave(densities, torch.from_numpy(np.asarray(row_matrix, np.int32)),
                                ops, exclude)
