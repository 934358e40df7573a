"""Block-oriented storage (paper §3: block-level reasoning).

Counterpart of ``repro/data/block_store.py``.  A :class:`Table` is the logical
table (dimension attributes + measures, numpy).  A :class:`BlockStore` is its
physical layout on one device: fixed-size blocks of ``records_per_block``
rows held as ``[λ, R, ·]`` tensors, with the DensityMap index beside them.
Every read goes through :meth:`BlockStore.fetch`, one
:func:`repro_torch.kernels.plan_wave.block_gather` launch per tensor, usually
behind the engine's :class:`repro_torch.core.block_cache.BlockLRUCache`.
A store tells registered listeners which blocks were rewritten
(:meth:`BlockStore.notify_invalidated`), so a cache can evict just those.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.density_map import AND, DensityMapIndex, build_density_maps
from repro_torch.device import resolve_device


@dataclasses.dataclass
class Table:
    dims: np.ndarray  # [N, r] int32 dimension attributes
    measures: np.ndarray  # [N, s] float32 measure attributes
    cards: np.ndarray  # [r] distinct-value counts

    @property
    def num_records(self) -> int:
        return int(self.dims.shape[0])

    def valid_mask(self, predicates: Sequence[tuple[int, int]], op: str = AND) -> np.ndarray:
        masks = [self.dims[:, a] == v for a, v in predicates]
        return np.logical_and.reduce(masks) if op == AND else np.logical_or.reduce(masks)


@dataclasses.dataclass
class BlockStore:
    """Physical blocked layout + the DensityMap index, on one device."""

    dims: torch.Tensor  # [λ, R, r] int32, padded with -1 (matches no value)
    measures: torch.Tensor  # [λ, R, s] f32, padded with 0
    valid_rows: torch.Tensor  # [λ, R] bool, False on padding
    index: DensityMapIndex
    records_per_block: int
    num_records: int

    def __post_init__(self):
        # callbacks fired with the dirtied block ids when blocks are rewritten
        self._invalidation_listeners: list = []

    @property
    def num_blocks(self) -> int:
        return int(self.dims.shape[0])

    @property
    def device(self) -> torch.device:
        return self.dims.device

    def to(self, device: str | torch.device) -> "BlockStore":
        """A copy of the store (slabs and index) on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            dims=self.dims.to(dev),
            measures=self.measures.to(dev),
            valid_rows=self.valid_rows.to(dev),
            index=self.index.to(dev),
        )

    # ------------------------------------------------- cache invalidation
    def register_invalidation_listener(self, callback) -> None:
        """Register ``callback(block_ids)`` to run when blocks are rewritten.

        Bound methods are held weakly: a store outlives throwaway engines,
        and a strong reference here would pin every dead engine's block
        cache (on the card, up to the store's own size in device memory).
        """
        if any(ref() == callback for ref in self._invalidation_listeners):
            return
        if hasattr(callback, "__self__"):
            ref = weakref.WeakMethod(callback)
        else:  # a plain function or lambda: kept strongly (it pins nothing big)
            ref = lambda cb=callback: cb  # noqa: E731
        self._invalidation_listeners.append(ref)

    def unregister_invalidation_listener(self, callback) -> None:
        self._invalidation_listeners = [
            ref for ref in self._invalidation_listeners
            if ref() is not None and ref() != callback
        ]

    def notify_invalidated(self, block_ids) -> None:
        """Call every live listener with ``block_ids`` (int64); dead weak
        references are dropped."""
        alive = []
        for ref in self._invalidation_listeners:
            cb = ref()
            if cb is not None:
                cb(np.asarray(block_ids, dtype=np.int64))
                alive.append(ref)
        self._invalidation_listeners = alive

    # ------------------------------------------------------------- reads
    def fetch(
        self, block_ids
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Gather blocks from the store's slabs: ``(dims [B, R, r],
        measures [B, R, s], valid [B, R] bool)`` on the store's device, one
        ``block_gather`` launch each (valid rows travel as int8, a zero-copy
        view of the bool slab).  Values are byte-identical to
        ``slab[block_ids]``; the reference returns host arrays, the port
        keeps the slabs on the card.

        ``block_ids`` is host data (a list or numpy array); the ids are
        range-checked here, before they reach the card.
        """
        from repro_torch.kernels.plan_wave import block_gather

        ids = np.asarray(block_ids, dtype=np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_blocks):
            raise IndexError(f"block ids out of range [0, {self.num_blocks})")
        ids_t = torch.from_numpy(ids.astype(np.int32)).to(self.device)
        return (
            block_gather(self.dims, ids_t),
            block_gather(self.measures, ids_t),
            block_gather(self.valid_rows.view(torch.int8), ids_t) != 0,
        )

    def predicate_mask(
        self, block_dims: torch.Tensor, predicates: Sequence[tuple[int, int]], op: str = AND
    ) -> torch.Tensor:
        """[B, R] bool — which records in the fetched blocks satisfy the query."""
        masks = [block_dims[..., a] == v for a, v in predicates]
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if op == AND else (out | m)
        return out

    def data_nbytes(self) -> int:
        return int(self.dims.numel() * 4 + self.measures.numel() * 4)


def build_block_store(
    table: Table, records_per_block: int, device: str | torch.device = "cuda"
) -> BlockStore:
    """Lay ``table`` out in blocks and build its index, on ``device``.

    The slabs are built in numpy exactly as the reference builds them, then
    moved to the device.
    """
    dev = resolve_device(device)
    n, r = table.dims.shape
    s = table.measures.shape[1]
    lam = -(-n // records_per_block)
    pad = lam * records_per_block - n
    dims = np.concatenate(
        [table.dims, np.full((pad, r), -1, dtype=table.dims.dtype)]
    ).reshape(lam, records_per_block, r)
    meas = np.concatenate(
        [table.measures, np.zeros((pad, s), dtype=table.measures.dtype)]
    ).reshape(lam, records_per_block, s)
    valid = np.concatenate(
        [np.ones(n, dtype=bool), np.zeros(pad, dtype=bool)]
    ).reshape(lam, records_per_block)
    index = build_density_maps(table.dims, table.cards, records_per_block, device=dev)
    return BlockStore(
        dims=torch.from_numpy(np.ascontiguousarray(dims, dtype=np.int32)).to(dev),
        measures=torch.from_numpy(np.ascontiguousarray(meas, dtype=np.float32)).to(dev),
        valid_rows=torch.from_numpy(valid).to(dev),
        index=index,
        records_per_block=records_per_block,
        num_records=n,
    )
