"""Background compaction: re-sort the appended tail by density (§4.1 locality).

Counterpart of ``repro/storage/compact.py``, on the store's device.  After
heavy appends the tail interleaves values, so the dense, contiguous block
prefixes the THRESHOLD/TWO-PRONG planners and the prefetcher assume
degrade into scattered sparse blocks.  This module restores them between
waves:

* :func:`compact_tail` re-sorts the valid rows of every block from
  ``tail_start`` on lexicographically by their dimension values (attribute
  0 major): the reference's ``np.lexsort`` becomes stable sorts on the card
  by attribute r−1 down to 0, which give the same permutation.  The rows
  are re-blocked through :func:`repro_torch.data.append.rebuild_store`, and
  the standard invalidation listeners are notified with the rewritten id
  range, so block caches, tier stacks and prefetchers drop the stale bytes
  exactly as on append.
* :class:`TailCompactor` runs compaction between waves: it watches the
  engine's store for invalidations, remembers the dirty low-water mark, and
  on :meth:`TailCompactor.compact` rewrites that tail and swaps the engine
  onto the compacted store (``NeedleTailEngine.compact``).

Compaction *permutes* tail rows: the compacted store is a new store
version, and results match the sequential oracle on that version.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from repro_torch.data.append import rebuild_store, valid_rows_flat

__all__ = ["compact_tail", "TailCompactor"]


def lexsort_rows(rows: torch.Tensor) -> torch.Tensor:
    """The permutation ``np.lexsort(rows.T[::-1])`` gives (column 0 major,
    stable): stable sorts by the last column first, on ``rows``' device."""
    perm = torch.arange(rows.shape[0], device=rows.device)
    for a in range(rows.shape[1] - 1, -1, -1):
        perm = perm[torch.sort(rows[perm, a], stable=True).indices]
    return perm


def compact_tail(store, tail_start: int):
    """A successor of ``store`` whose blocks ≥ ``tail_start`` are re-sorted.

    Valid rows of the tail are ordered lexicographically by dimension values
    (attribute 0 major); rows before ``tail_start * records_per_block`` keep
    their layout, and density columns for the untouched prefix are reused.
    Listeners on ``store`` are notified with the rewritten id range and
    carried over."""
    rpb = store.records_per_block
    lam = store.num_blocks
    tail_start = int(tail_start)
    if not (0 <= tail_start < lam):
        raise ValueError(f"tail_start {tail_start} outside [0, {lam})")
    dims_flat, meas_flat = valid_rows_flat(store)
    lo = tail_start * rpb
    order = lexsort_rows(dims_flat[lo:])
    touched = np.arange(tail_start, lam, dtype=np.int64)
    fresh = rebuild_store(store, [dims_flat[:lo], dims_flat[lo:][order]],
                          [meas_flat[:lo], meas_flat[lo:][order]], touched)
    store.notify_invalidated(touched)
    return fresh


class TailCompactor:
    """Compaction between waves for a ``NeedleTailEngine``.

    Registers an invalidation listener on the engine's store (re-registered
    whenever the engine adopts a successor store) and tracks the lowest
    dirtied block id since the last compaction.  :meth:`compact` rewrites
    that tail through ``engine.compact``; its own rewrite notification is
    kept out of the dirty tracking so a compaction does not schedule itself
    again.
    """

    def __init__(self, engine):
        self._engine_ref = weakref.ref(engine)
        self._store = None
        self.dirty_since: int | None = None
        self.compactions = 0
        self._suspend = False
        self._sync_store()

    def _sync_store(self) -> None:
        eng = self._engine_ref()
        if eng is None or eng.store is self._store:
            return
        if self._store is not None:
            self._store.unregister_invalidation_listener(self._on_invalidate)
        self._store = eng.store
        self._store.register_invalidation_listener(self._on_invalidate)

    def _on_invalidate(self, block_ids) -> None:
        if self._suspend:
            return
        ids = np.asarray(list(block_ids), dtype=np.int64)
        if ids.size == 0:
            return
        low = int(ids.min())
        self.dirty_since = low if self.dirty_since is None else min(self.dirty_since, low)

    def pending_blocks(self) -> int:
        """Blocks the next :meth:`compact` would rewrite (0 = clean tail)."""
        eng = self._engine_ref()
        if eng is None or self.dirty_since is None:
            return 0
        self._sync_store()
        return max(eng.store.num_blocks - min(self.dirty_since, eng.store.num_blocks), 0)

    def compact(self, min_blocks: int = 1) -> int:
        """Compact the dirty tail if it spans ≥ ``min_blocks``; returns the
        blocks rewritten."""
        eng = self._engine_ref()
        if eng is None:
            return 0
        self._sync_store()
        n = self.pending_blocks()
        if n < max(int(min_blocks), 1):
            return 0
        self._suspend = True
        try:
            eng.compact(eng.store.num_blocks - n)
        finally:
            self._suspend = False
        self.dirty_since = None
        self.compactions += 1
        self._sync_store()
        return n
