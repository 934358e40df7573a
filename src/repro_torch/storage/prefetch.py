"""Memo-driven tier prefetch and demand I/O pricing under the cache state.

Counterpart of ``repro/storage/prefetch.py``.  The plan memo
(:class:`~repro_torch.core.block_cache.PlanOrderCache`) can often say which
blocks a pending wave's round 0 will read: the same stat-free peek the
residency probe uses (:func:`repro_torch.storage.residency.
_round0_plan_from_memo`).  :class:`TierPrefetcher` predicts the pending
requests' round-0 union, subtracts what is already resident at the target
tier, and promotes the rest into it, so the wave's first read is a pure
tier hit and reads **zero backing-store blocks** on round 0.

Two modes:

* **synchronous** (default): ``kick`` promotes inline through
  :meth:`TierStack.prefetch`; deterministic, what the tests drive.
* **asynchronous** (``async_fetch=True``): on a card, ``kick`` reads the
  misses on a CUDA side stream into a fresh buffer (never into the tier's
  pool, which may grow and move) and records an event there; ``drain``
  makes the current stream wait on that event before
  ``TierStack.prefetch(..., slabs=)`` admits the blocks.  The buffer is
  kept until the drain and marked used on the current stream
  (``record_stream``).  On the CPU the read runs at once.  The reference
  reads on a daemon thread; a side stream is the card's way to overlap the
  read with planning.

Correctness under appends: the prefetcher registers an invalidation
listener, so blocks dirtied by an append are forgotten, both the
speculative hit ledger and any in-flight reads, exactly as the tier stack
drops its own residents.  A prediction is only a *plan* peek; a wrong or
stale one costs bandwidth, never correctness.

:func:`effective_block_cost` is the shared pricing primitive (the online
aggregate's answer-now arm, the cost-fed admission probe
:func:`make_missed_cost_probe`); with a :class:`~repro_torch.storage.tiers.
TierStack` it prices by ``effective_io_time``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.storage.residency import _ROW_CACHE_MAX, _round0_plan_from_memo


@dataclasses.dataclass
class PrefetchStats:
    kicks: int = 0  # prediction passes that found at least one request
    predicted_requests: int = 0  # pending requests whose plan was memoized
    issued: int = 0  # blocks handed to the fetch/promote stage
    fetched: int = 0  # blocks the cache actually read/admitted for us
    hits: int = 0  # prefetched blocks later touched by a demand wave
    invalidated: int = 0  # prefetched blocks dirtied by append before use
    truncated: int = 0  # predicted blocks dropped by the per-kick cap

    @property
    def hit_rate(self) -> float:
        return self.hits / self.issued if self.issued else 0.0

    def snapshot(self) -> dict:
        return {**dataclasses.asdict(self), "hit_rate": self.hit_rate}


def predicted_wave_blocks(
    engine, requests: Sequence, row_cache: dict | None = None
) -> tuple[np.ndarray, int]:
    """The union of round-0 blocks the plan memo predicts for ``requests``:
    ``(ids ascending int64, n_predicted)``, ``n_predicted`` counting the
    requests whose plan was memoized.  Stat-free and side-effect-free."""
    union: list[np.ndarray] = []
    n_pred = 0
    for r in requests:
        plan = _round0_plan_from_memo(
            engine, r.predicates, r.k, getattr(r, "op", "and"), row_cache
        )
        if plan is None:
            continue
        n_pred += 1
        if plan.size:
            union.append(np.asarray(plan, dtype=np.int64))
    if not union:
        return np.asarray([], dtype=np.int64), n_pred
    return np.unique(np.concatenate(union)), n_pred


def _tiered(cache) -> bool:
    return hasattr(cache, "effective_io_time") and hasattr(cache, "residency_tier")


def effective_block_cost(engine, block_ids, *, missed_only: bool = False) -> float:
    """Modeled demand I/O of reading ``block_ids`` under the engine's cache
    state: with a :class:`~repro_torch.storage.tiers.TierStack`, its
    ``effective_io_time`` (residents at their tier's model, misses under the
    engine's backing model; ``missed_only`` drops residents first, a
    resident set prices at 0.0); with the flat cache, the non-cached
    blocks under the engine's model, scaled by the plan ledger's
    correction.  0.0 for no blocks."""
    ids = np.asarray(block_ids, dtype=np.int64)
    if ids.size == 0:
        return 0.0
    cache = engine.block_cache
    if _tiered(cache):
        if missed_only:
            ids = ids[cache.residency_tier(ids) >= len(cache.tiers)]
        return float(cache.effective_io_time(ids, backing=engine.cost))
    missed = np.asarray([int(b) for b in ids if int(b) not in cache], dtype=np.int64)
    t = float(engine.cost.io_time(missed))
    lg = getattr(engine, "ledger", None)
    return t * lg.correction(engine.cost.name) if lg is not None else t


def make_missed_cost_probe(engine) -> Callable[[Sequence], float | None]:
    """A cost probe for an admission controller: the effective I/O time of
    a pending wave's *missed* predicted blocks, or ``None`` unless EVERY
    request's round-0 plan is memoized.  Keep ONE probe per engine alive
    across polls (it memoizes template row bytes)."""
    row_cache: dict = {}

    def probe(requests: Sequence) -> float | None:
        reqs = list(requests)
        if not reqs:
            return None
        union, n_pred = predicted_wave_blocks(engine, reqs, row_cache)
        if n_pred < len(reqs):
            return None
        price = effective_block_cost(engine, union, missed_only=True)
        _record_priced_decision(engine, "admission", union, price)
        return price

    return probe


def _record_priced_decision(engine, site: str, union: np.ndarray, price: float) -> None:
    """Ledger a cost-fed decision (``admission`` gate / ``prefetch`` kick):
    the quoted price of the union's missed blocks vs the timing backend's
    cost at the level that would serve them.  Skipped without a ledger and
    backend, for unmeasurable levels, and for backends wrapping the engine's
    own store (observing would re-read what the quote is about)."""
    lg = getattr(engine, "ledger", None)
    be = getattr(engine, "timing_backend", None)
    if lg is None or be is None or union.size == 0:
        return
    if getattr(be, "store", None) is engine.store:
        return
    cache = engine.block_cache
    if hasattr(cache, "residency_tier"):
        missed = union[cache.residency_tier(union) >= len(cache.tiers)]
        level = cache.backing.name
    else:
        missed = np.asarray([int(b) for b in union if int(b) not in cache], dtype=np.int64)
        level = engine.cost.name
    from repro_torch.storage.calibration import measurable

    if missed.size and measurable(be, level):
        lg.record(site, level, price, be.io_seconds(level, missed))


class _InflightFetch:
    """One asynchronous backing-store read: its ids, the misses it reads,
    their slabs (a fresh buffer), the event recorded after the read on the
    side stream (``None`` on the CPU) and the ids invalidated while in
    flight."""

    def __init__(self, ids: np.ndarray, miss: np.ndarray):
        self.ids = ids
        self.miss = miss
        self.slabs = None
        self.event = None
        self.stale: set[int] = set()

    def done(self) -> bool:
        return self.event is None or self.event.query()


class TierPrefetcher:
    """Promote the predicted next wave's block union into a cache tier.

    ``engine``'s ``plan_cache`` gives the predictions and its
    ``block_cache`` takes the promotions (a :class:`~repro_torch.storage.
    tiers.TierStack`; the flat cache degrades to ``ensure``).  ``tier`` is
    the target tier, ``max_blocks`` the per-kick cap, ``async_fetch`` the
    side-stream mode.  The prefetcher registers itself as an invalidation
    listener on the engine's store and follows the engine to a successor
    store; keep it alive as long as the loop that kicks it.
    """

    def __init__(self, engine, tier: int = 0, max_blocks: int = 512,
                 async_fetch: bool = False):
        self.engine = engine
        self.tier = tier
        self.max_blocks = max_blocks
        self.async_fetch = async_fetch
        self.stats = PrefetchStats()
        self.prefetched: set[int] = set()  # issued, not yet demand-touched
        self._inflight: list[_InflightFetch] = []
        self._row_cache: dict = {}
        self._store = None
        self._stream = None
        self._sync_store()

    # ------------------------------------------------------------ invalidation
    def _sync_store(self) -> None:
        """Track the engine's current store: re-register the listener when
        the engine swapped to a store we are not wired to."""
        store = self.engine.store
        if store is self._store:
            return
        if self._store is not None:
            self._store.unregister_invalidation_listener(self._on_invalidate)
        store.register_invalidation_listener(self._on_invalidate)
        self._store = store
        # a different store means different bytes: all speculation is stale
        self.prefetched.clear()
        self._row_cache.clear()

    def _on_invalidate(self, block_ids: np.ndarray) -> None:
        """Forget speculative state for the dirtied ``block_ids`` (the tier
        stack drops its own residents through its own listener)."""
        dirty = {int(b) for b in np.asarray(block_ids).ravel()}
        self.stats.invalidated += len(self.prefetched & dirty)
        self.prefetched -= dirty
        for rec in self._inflight:
            rec.stale |= dirty

    # ------------------------------------------------------------------- kick
    def kick(self, requests: Sequence) -> int:
        """Predict ``requests``' round-0 union and start warming it.  Returns
        the number of blocks issued (0 when nothing is predicted or all is
        warm)."""
        self._sync_store()
        if not requests:
            return 0
        engine = self.engine
        if len(self._row_cache) >= _ROW_CACHE_MAX:
            self._row_cache.clear()
        union, n_pred = predicted_wave_blocks(engine, requests, self._row_cache)
        if n_pred:
            self.stats.kicks += 1
            self.stats.predicted_requests += n_pred
        if union.size == 0:
            return 0
        cache = engine.block_cache
        inflight = {int(b) for rec in self._inflight for b in rec.ids}
        tiered = hasattr(cache, "residency_tier")
        if tiered:
            want = [int(b) for b, t in zip(union, cache.residency_tier(union))
                    if int(t) > self.tier and int(b) not in inflight]
        else:
            want = [int(b) for b in union if int(b) not in cache and int(b) not in inflight]
        if not want:
            return 0
        # cap AFTER sorting: the §4.1 ascending order keeps the
        # locality-dense prefix, and the drop is never silent
        want = sorted(want)
        if len(want) > self.max_blocks:
            self.stats.truncated += len(want) - self.max_blocks
            want = want[: self.max_blocks]
        ids = np.asarray(want, dtype=np.int64)
        self.stats.issued += int(ids.size)
        _record_priced_decision(engine, "prefetch", ids,
                                effective_block_cost(engine, ids, missed_only=True))
        self.prefetched.update(int(b) for b in ids)
        fetched0 = cache.stats.store_blocks_fetched
        if self.async_fetch:
            self._issue_async(ids)
        elif tiered:
            cache.prefetch(self._store, ids, self.tier)
            self.stats.fetched += int(cache.stats.store_blocks_fetched - fetched0)
        else:
            cache.ensure(self._store, ids)
            self.stats.fetched += int(cache.stats.store_blocks_fetched - fetched0)
        return int(ids.size)

    def _issue_async(self, ids: np.ndarray) -> None:
        cache = self.engine.block_cache
        miss = np.asarray([int(b) for b in ids if int(b) not in cache], dtype=np.int64)
        rec = _InflightFetch(ids, miss)
        self._inflight.append(rec)
        if not miss.size:
            return
        store = self._store
        if store.device.type != "cuda":
            rec.slabs = store.fetch(miss)
            return
        cur = torch.cuda.current_stream(store.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(store.device)
        self._stream.wait_stream(cur)  # the store's slabs as the current stream left them
        with torch.cuda.stream(self._stream):
            rec.slabs = store.fetch(miss)
            rec.event = torch.cuda.Event()
            rec.event.record(self._stream)
        for t in rec.slabs:  # the drain reads them on the current stream
            t.record_stream(cur)

    def drain(self, wait: bool = False) -> int:
        """Admit completed asynchronous reads into the tier (promoting
        residents too); reads still in flight stay queued unless ``wait``.
        Returns the number of blocks admitted or promoted."""
        self._sync_store()
        moved = 0
        still: list[_InflightFetch] = []
        cache = self.engine.block_cache
        for rec in self._inflight:
            if not wait and not rec.done():
                still.append(rec)
                continue
            if rec.event is not None:
                torch.cuda.current_stream(self._store.device).wait_event(rec.event)
            live = np.asarray([int(b) for b in rec.ids if int(b) not in rec.stale],
                              dtype=np.int64)
            slabs = {}
            if rec.slabs is not None:
                slabs = {int(b): tuple(t[off] for t in rec.slabs)
                         for off, b in enumerate(rec.miss) if int(b) not in rec.stale}
            got = 0
            if live.size and hasattr(cache, "prefetch"):
                got = int(cache.prefetch(self._store, live, self.tier, slabs=slabs))
            elif live.size:
                got = int(cache.ensure(self._store, live))
            # credit only what the cache reports moved/admitted: a stale or
            # budget-rejected read is wasted bandwidth, not a fetch
            self.stats.fetched += got
            moved += got
        self._inflight = still
        return moved

    # ------------------------------------------------------------------ credit
    def observe_wave(self, block_ids) -> int:
        """Credit speculative hits: ``block_ids`` a demand wave just touched,
        each prefetched block once.  Returns the hits credited."""
        ids = {int(b) for b in np.asarray(block_ids, dtype=np.int64).ravel()}
        hit = self.prefetched & ids
        self.stats.hits += len(hit)
        self.prefetched -= hit
        return len(hit)
