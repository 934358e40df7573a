"""Engine-lifetime block LRU cache + cross-batch plan-order memoization.

Counterpart of ``repro/core/block_cache.py``.  Two caches live here:

* :class:`BlockLRUCache` — block slabs ``(dims [R, r], measures [R, s],
  valid [R])`` keyed on block id, byte-budgeted with LRU eviction and the
  reference's hit/miss/eviction/invalidation counters.  ``get_many`` reads
  every miss from the store in ONE ascending-id :meth:`BlockStore.fetch`
  call (§4.1 fetch order), so a wave whose union fits the budget reads each
  block from the store at most once.  The bookkeeping (which ids hit, which
  are read, which are evicted, in which order) is the reference's step for
  step, so the counters agree with it on the same call sequence.
* :class:`PlanOrderCache` — per-(combined-row, exclusion) THRESHOLD sorted
  orders, per-(row, need) TWO-PRONG windows (shared by the host and sharded
  planners) and per-(row, need) sharded THRESHOLD id sets, keyed on the row
  *bytes*, host arrays as in the reference.

Where the slabs live.  The reference keeps host copies of each block.  Here
the cached slabs stay on the store's device, in a slot pool: three tensors
``[C, R, ·]`` that grow by doubling (never past the store's λ blocks, nor
past the byte budget's block count), with each cached block owning one slot.
Admission fills the slots of the fetched misses with one copy per tensor,
and a read is one ``block_gather`` launch per tensor over the slots, so the
slabs never leave the card.  An unbounded cache (``capacity_bytes=None``)
can therefore grow to the store's own size in device memory (3.2 GB for the
10⁸-record airline-like store), plus a transient copy while the pool grows;
:meth:`BlockLRUCache.ensure` grows it once and fills it a piece at a time,
so filling it with a whole store holds one piece's gather beside the pool.

Invalidation contract: entries only go stale when the store's blocks are
rewritten; the store reports the dirtied ids to its listeners
(:meth:`BlockStore.notify_invalidated`), and :meth:`BlockLRUCache.
invalidate` evicts exactly those.  Anything that swaps the store calls
:meth:`BlockLRUCache.clear`.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import TYPE_CHECKING, Iterable, Sequence

import numpy as np
import torch

from repro_torch.kernels.plan_wave import block_gather

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.data.block_store import BlockStore

Slabs = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class CacheStats:
    """Monotonic counters; ``bytes_cached`` / ``blocks_cached`` are gauges."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0
    # re-reads of invalidated blocks: the store dirtied them, so their next
    # admission is churn, not a cold miss (kept out of ``misses``)
    invalidation_rereads: int = 0
    store_fetch_calls: int = 0  # BlockStore.fetch round trips
    store_blocks_fetched: int = 0  # blocks read from the store's slabs
    bytes_cached: int = 0
    blocks_cached: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = round(self.hit_rate, 4)
        return d


# ``ensure`` fetches and admits its misses this many blocks at a time
_ENSURE_BLOCKS = 1024


def _slab_nbytes(slabs: Slabs) -> int:
    """Bytes of one block's slabs (bool rows count one byte, as numpy's)."""
    return sum(int(t[0].numel()) * t.element_size() for t in slabs)


class BlockLRUCache:
    """Byte-budgeted LRU over block slabs on the store's device.

    ``capacity_bytes``: ``None`` — unbounded (bounded by the store's size);
    ``0`` — caching off, every ``get_many`` goes straight to the store (the
    cache-less reference behaviour); otherwise LRU eviction keeps
    ``bytes_cached + incoming <= capacity_bytes`` (a block larger than the
    whole budget is still admitted alone, as in the reference).

    ``get_many(store, ids)`` returns slabs byte-identical to
    ``store.fetch(ids)`` for any sequence of calls and any budget: caching
    changes which reads reach the store, never the data.
    """

    def __init__(self, capacity_bytes: int | None = None):
        self.capacity_bytes = capacity_bytes
        self.stats = CacheStats()
        # when set (to a list), every id array read from the store is
        # appended: run_batch uses it for per-batch I/O accounting
        self.fetch_log: list | None = None
        # block id -> (pool slot, nbytes), least recently used first
        self._slabs: "OrderedDict[int, tuple[int, int]]" = OrderedDict()
        # ids the store reported dirtied: their next admission books as
        # ``invalidation_rereads`` instead of ``misses`` (one-shot marks)
        self._invalidated: set[int] = set()
        self._pool: Slabs | None = None  # [C, R, r], [C, R, s], [C, R] bool
        self._free: list[int] = []  # free pool slots, lowest last

    # ------------------------------------------------------------------ admin
    def __contains__(self, block_id: int) -> bool:
        return int(block_id) in self._slabs

    def __len__(self) -> int:
        return len(self._slabs)

    @property
    def nbytes(self) -> int:
        return self.stats.bytes_cached

    def clear(self) -> None:
        """Drop everything (a store swap): the next reads are cold misses."""
        self.stats.invalidations += len(self._slabs)
        self._slabs.clear()
        self._invalidated.clear()
        self._pool, self._free = None, []
        self.stats.bytes_cached = 0
        self.stats.blocks_cached = 0

    def invalidate(self, block_ids: Iterable[int]) -> int:
        """Evict exactly ``block_ids`` (the dirtied blocks); returns #evicted."""
        n = 0
        for b in block_ids:
            self._invalidated.add(int(b))
            entry = self._slabs.pop(int(b), None)
            if entry is not None:
                self._free.append(entry[0])
                self.stats.bytes_cached -= entry[1]
                n += 1
        if len(self._invalidated) > (1 << 20):  # marks degrade to plain misses
            self._invalidated.clear()
        self.stats.blocks_cached = len(self._slabs)
        self.stats.invalidations += n
        return n

    def _split_rereads(self, miss_set: set[int]) -> set[int]:
        """The invalidated ids among ``miss_set`` (consuming their marks)."""
        if not self._invalidated:
            return set()
        re_ids = self._invalidated & miss_set
        if re_ids:
            self._invalidated -= re_ids
        return re_ids

    def _evict_to_fit(self, incoming_nbytes: int) -> None:
        if self.capacity_bytes is None:
            return
        while self._slabs and self.stats.bytes_cached + incoming_nbytes > self.capacity_bytes:
            _, (slot, nb) = self._slabs.popitem(last=False)  # the LRU end
            self._free.append(slot)
            self.stats.bytes_cached -= nb
            self.stats.evictions += 1
        self.stats.blocks_cached = len(self._slabs)

    def _grow(self, like: Slabs, limit: int, need: int = 0) -> None:
        """Double the slot pool, or grow it to ``need`` slots if that is
        more (at least 16 slots, at most ``limit``), keeping the cached
        slabs; ``like`` gives the per-block shapes."""
        old = 0 if self._pool is None else self._pool[0].shape[0]
        new = min(limit, max(16, 2 * old, need))
        pool = tuple(torch.empty((new, *t.shape[1:]), dtype=t.dtype, device=t.device)
                     for t in like)
        if self._pool is not None:
            for n, o in zip(pool, self._pool):
                n[:old] = o
        self._pool = pool
        self._free.extend(range(new - 1, old - 1, -1))

    def _admit(self, store: "BlockStore", miss: np.ndarray, fetched: Slabs) -> None:
        """Insert the fetched misses (ascending ids) with the reference's
        evictions, then copy the slabs of those still cached into their
        slots.  A miss evicted by a later one of the same batch gave its
        slot away and is not copied."""
        nb = _slab_nbytes(fetched)
        limit = store.num_blocks
        if self.capacity_bytes is not None:
            limit = min(limit, max(1, self.capacity_bytes // max(nb, 1)))
        slot_of: dict[int, int] = {}
        for b in miss:
            self._evict_to_fit(nb)
            if not self._free:
                self._grow(fetched, limit)
            slot = self._free.pop()
            self._slabs[int(b)] = (slot, nb)
            slot_of[int(b)] = slot
            self.stats.bytes_cached += nb
        self.stats.blocks_cached = len(self._slabs)
        keep = [(off, slot_of[int(b)]) for off, b in enumerate(miss) if int(b) in self._slabs]
        if keep:
            dev = fetched[0].device
            offs = torch.as_tensor([o for o, _ in keep], dtype=torch.long, device=dev)
            slots = torch.as_tensor([s for _, s in keep], dtype=torch.long, device=dev)
            for pool, t in zip(self._pool, fetched):
                pool.index_copy_(0, slots, t.index_select(0, offs))

    def _gather(self, slots: Sequence[int]) -> Slabs:
        """The slabs of ``slots``, in order: one ``block_gather`` per tensor."""
        dims, meas, valid = self._pool
        ids = torch.as_tensor(np.asarray(slots, dtype=np.int32), device=dims.device)
        return (block_gather(dims, ids), block_gather(meas, ids),
                block_gather(valid.view(torch.int8), ids) != 0)

    def _book_read(self, ids: np.ndarray) -> None:
        """Book one store read of ``ids``."""
        self.stats.store_fetch_calls += 1
        self.stats.store_blocks_fetched += int(ids.size)
        if self.fetch_log is not None:
            self.fetch_log.append(ids.copy())

    def _read(self, store: "BlockStore", ids: np.ndarray) -> Slabs:
        """One store read, booked."""
        self._book_read(ids)
        return store.fetch(ids)

    # ------------------------------------------------------------------ fetch
    def ensure(self, store: "BlockStore", block_ids) -> int:
        """Admit every miss among ``block_ids``, booked as one ascending-id
        store read, without gathering.  The misses are fetched and admitted
        :data:`_ENSURE_BLOCKS` at a time, an unbounded pool first grown once
        to hold them all, so that filling the cache with a whole store holds
        the pool and one piece beside the store, not a second copy of it.
        The bookkeeping is the one-read call's.  Returns the number of
        blocks read."""
        if self.capacity_bytes == 0:
            return 0
        miss_set = {int(b) for b in np.asarray(block_ids).ravel()} - self._slabs.keys()
        if not miss_set:
            return 0
        miss = np.asarray(sorted(miss_set), dtype=np.int64)
        re_ids = self._split_rereads(miss_set)
        self.stats.misses += int(miss.size) - len(re_ids)
        self.stats.invalidation_rereads += len(re_ids)
        self._book_read(miss)
        for lo in range(0, miss.size, _ENSURE_BLOCKS):
            part = miss[lo:lo + _ENSURE_BLOCKS]
            fetched = store.fetch(part)
            if lo == 0 and self.capacity_bytes is None and len(self._free) < miss.size:
                self._grow(fetched, store.num_blocks, len(self._slabs) + int(miss.size))
            self._admit(store, part, fetched)
        return int(miss.size)

    def get_many(self, store: "BlockStore", block_ids) -> Slabs:
        """Slabs for ``block_ids`` (order preserved), reading every miss from
        the store in one ascending-id call: ``(dims [B, R, r], measures
        [B, R, s], valid [B, R] bool)`` on the store's device, byte-identical
        to ``store.fetch(block_ids)``."""
        ids = np.asarray(block_ids, dtype=np.int64)
        if ids.size == 0:
            return store.fetch(ids)
        if self.capacity_bytes == 0:  # caching off: the reference path
            self.stats.misses += int(ids.size)
            return self._read(store, ids)
        miss_set = {int(b) for b in ids} - self._slabs.keys()
        hits = sum(1 for b in ids if int(b) not in miss_set)
        self.stats.hits += hits
        re_ids = self._split_rereads(miss_set)
        n_re = sum(1 for b in ids if int(b) in re_ids) if re_ids else 0
        self.stats.misses += int(ids.size - hits) - n_re
        self.stats.invalidation_rereads += n_re
        fetched, fetched_off = None, {}
        if miss_set:
            miss = np.asarray(sorted(miss_set), dtype=np.int64)
            fetched = self._read(store, miss)
            fetched_off = {int(b): off for off, b in enumerate(miss)}
            self._admit(store, miss, fetched)
        if all(int(b) in self._slabs for b in ids):
            for b in ids:
                self._slabs.move_to_end(int(b))  # LRU touch
            return self._gather([self._slabs[int(b)][0] for b in ids])
        # a request larger than the budget: a miss evicted by this call's own
        # inserts is served from the fetched batch; a pre-call hit evicted by
        # them is the one case read again from the store
        parts = []
        for b in ids:
            entry = self._slabs.get(int(b))
            if entry is not None:
                self._slabs.move_to_end(int(b))
                parts.append(self._gather([entry[0]]))
            elif int(b) in fetched_off:
                off = fetched_off[int(b)]
                parts.append(tuple(t[off:off + 1] for t in fetched))
            else:
                parts.append(self._read(store, np.asarray([b], dtype=np.int64)))
        return tuple(torch.cat(ts) for ts in zip(*parts))

    def get_wave(
        self, union: np.ndarray, per_query: Sequence[np.ndarray]
    ) -> Slabs | None:
        """A wave's reads in one gather, after :meth:`ensure` of its
        ``union``.  When every union block is cached, books exactly what
        ``get_many`` of each query's blocks, in order, would book (all hits,
        the same LRU touches) and returns the union's slabs; otherwise
        returns ``None`` and books nothing (the caller then reads query by
        query)."""
        if self.capacity_bytes == 0 or any(int(b) not in self._slabs for b in union):
            return None
        for blocks in per_query:
            self.stats.hits += int(blocks.size)
            for b in blocks:
                self._slabs.move_to_end(int(b))
        return self._gather([self._slabs[int(b)][0] for b in union])


@dataclasses.dataclass
class PlanCacheStats:
    """Hit/miss counters per memo kind (monotonic): ``threshold_*`` the
    sorted-order memo, ``two_prong_*`` the window memo, ``sharded_threshold_*``
    the sharded planner's id-set memo."""

    threshold_hits: int = 0
    threshold_misses: int = 0
    two_prong_hits: int = 0
    two_prong_misses: int = 0
    sharded_threshold_hits: int = 0
    sharded_threshold_misses: int = 0

    @property
    def hits(self) -> int:
        return self.threshold_hits + self.two_prong_hits + self.sharded_threshold_hits


class PlanOrderCache:
    """Cross-batch memo of planner intermediates, keyed on combined-row bytes.

    THRESHOLD entries map ``row.tobytes()`` (exclusions already zeroed into
    the row) to host ``(sort_idx, sorted_d, cumsum)``; TWO-PRONG entries map
    ``(row_bytes, need)`` to ``(start, end)``; sharded THRESHOLD entries map
    ``(row_bytes, need)`` to the ascending block-id array the sharded
    planner selected (it gathers frontiers, not the whole sorted order).
    Every planner computes each row independently, so an entry is
    bit-identical to recomputing it: repeated (template, exclusion) pairs
    skip the sort and the scan.  ``max_entries`` bounds each memo, evicting
    the least recently touched.
    """

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self.stats = PlanCacheStats()
        self._threshold: "OrderedDict[bytes, tuple[np.ndarray, np.ndarray, np.ndarray]]" = (
            OrderedDict()
        )
        self._two_prong: "OrderedDict[tuple[bytes, float], tuple[int, int]]" = OrderedDict()
        self._sharded_threshold: "OrderedDict[tuple[bytes, float], np.ndarray]" = OrderedDict()

    def clear(self) -> None:
        self._threshold.clear()
        self._two_prong.clear()
        self._sharded_threshold.clear()

    def _touch(self, od: OrderedDict, key) -> None:
        od.move_to_end(key)
        while len(od) > self.max_entries:
            od.popitem(last=False)

    def peek_threshold(self, row_bytes: bytes):
        """:meth:`get_threshold` without counting or touching."""
        return self._threshold.get(row_bytes)

    def peek_two_prong(self, row_bytes: bytes, need: float):
        """:meth:`get_two_prong` without counting or touching."""
        return self._two_prong.get((row_bytes, float(need)))

    def get_threshold(self, row_bytes: bytes):
        hit = self._threshold.get(row_bytes)
        if hit is not None:
            self.stats.threshold_hits += 1
            self._touch(self._threshold, row_bytes)
        else:
            self.stats.threshold_misses += 1
        return hit

    def put_threshold(self, row_bytes: bytes, sort_idx, sorted_d, cum) -> None:
        # copies: the inputs are rows of batch results, and views would pin them
        self._threshold[row_bytes] = (np.array(sort_idx), np.array(sorted_d), np.array(cum))
        self._touch(self._threshold, row_bytes)

    def get_two_prong(self, row_bytes: bytes, need: float):
        hit = self._two_prong.get((row_bytes, float(need)))
        if hit is not None:
            self.stats.two_prong_hits += 1
            self._touch(self._two_prong, (row_bytes, float(need)))
        else:
            self.stats.two_prong_misses += 1
        return hit

    def put_two_prong(self, row_bytes: bytes, need: float, start: int, end: int) -> None:
        self._two_prong[(row_bytes, float(need))] = (int(start), int(end))
        self._touch(self._two_prong, (row_bytes, float(need)))

    def peek_sharded_threshold(self, row_bytes: bytes, need: float):
        """:meth:`get_sharded_threshold` without counting or touching."""
        return self._sharded_threshold.get((row_bytes, float(need)))

    def get_sharded_threshold(self, row_bytes: bytes, need: float):
        hit = self._sharded_threshold.get((row_bytes, float(need)))
        if hit is not None:
            self.stats.sharded_threshold_hits += 1
            self._touch(self._sharded_threshold, (row_bytes, float(need)))
        else:
            self.stats.sharded_threshold_misses += 1
        return hit

    def put_sharded_threshold(self, row_bytes: bytes, need: float, ids) -> None:
        self._sharded_threshold[(row_bytes, float(need))] = np.asarray(ids, dtype=np.int64)
        self._touch(self._sharded_threshold, (row_bytes, float(need)))
