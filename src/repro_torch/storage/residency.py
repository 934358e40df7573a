"""Residency-aware admission: peek tier residency + plan-memo hits.

Counterpart of ``repro/storage/residency.py``; the probe is installed on
the :class:`~repro_torch.serving.admission.AdmissionController` by
``ServeEngine(exemplar_residency=True)``.

The SLO admission controller normally launches on occupancy or deadline
only.  But a wave whose every query (a) has a memoized plan and (b) plans
only blocks already resident in the cache tiers would complete with **zero
backing-store I/O** — holding it back to accumulate a fuller wave buys no
shared-fetch savings (there is nothing left to share) and costs pure
latency.  :func:`wave_is_resident` is the stat-free peek the controller's
``residency_probe`` hook uses to detect exactly that wave and launch it
early.

The peek is *conservative and side-effect-free*: it consults the plan memo
through ``PlanOrderCache.peek_*`` (no hit/miss counters, no LRU touches) and
cache residency through ``__contains__`` / ``residency_tier`` only.  A memo
miss, an unknown algorithm trajectory, or a single non-resident block all
answer ``False`` — the wave then launches under the normal full/deadline
policy.  Because wave composition never changes per-query results
(``run_batch`` preserves byte-identity regardless of batching), an early
launch is always safe: it changes *when* queries run, never *what* they
return.

Which memo feeds the peek depends on how the engine plans: host-mirror
waves fill the THRESHOLD sorted-order memo, mesh-attached engines fill the
materialized sharded-THRESHOLD memo instead (both share the TWO-PRONG
window memo when the sharded planner is exact, ``two_prong_group == 1``) —
the probe checks whichever applies.  **Device waves
(``any_k_batch(device=True)``, the port's default) never write the memo at
all** (their plans live on the card; there are no row bytes to key on), so
a probe after device waves only observes what host-mirror waves memoized;
each poll's probe cost is one density combine (the first memo miss
short-circuits).

The guarantee is for the **first refill round**: the peeked plan is round
0's, so a launched resident wave performs its initial fetch entirely from
tiers.  A query whose density estimate under-delivers replans and may read
the store on refill — the probe is an opportunistic latency win, not an
I/O-freedom proof for pathological layouts.
"""
from __future__ import annotations

import weakref
from typing import Callable, Sequence

import numpy as np

#: bound on a probe's per-template row-bytes memo (hot serving pools repeat
#: a few predicate templates; the combine is the only real work in a peek)
_ROW_CACHE_MAX = 512


def _row_bytes(engine, predicates, op: str, row_cache: dict | None) -> bytes:
    """The combined-density row bytes the plan memo is keyed on, memoized
    per (template, op) when the template is hashable (pair-predicate lists;
    Predicate trees recombine each time).  Entries pin the store they were
    computed against through a weakref identity check, so an engine that
    appends or swaps stores (new densities, same template) can never be
    served stale bytes — a dead or different store invalidates the entry."""
    key = None
    if row_cache is not None:
        try:
            key = (tuple((int(a), int(v)) for a, v in predicates), op)
        except (TypeError, ValueError):
            key = None
        if key is not None:
            hit = row_cache.get(key)
            if hit is not None and hit[0]() is engine.store:
                return hit[1]
    combined = engine.combined_density(predicates, op).cpu().numpy()
    rb = np.ascontiguousarray(combined, dtype=np.float32).tobytes()
    if key is not None:
        if len(row_cache) >= _ROW_CACHE_MAX:
            row_cache.clear()  # tiny, template-shaped: wholesale reset is fine
        row_cache[key] = (weakref.ref(engine.store), rb)
    return rb


def _round0_plan_from_memo(engine, predicates, k: int, op: str,
                           row_cache: dict | None = None):
    """The blocks the engine's ``auto`` planner would pick for round 0, from
    the memo alone.  Returns ``None`` unless BOTH candidate plans are
    memoized for this (template, k): the TWO-PRONG window plus either the
    host THRESHOLD sorted order or (mesh-attached, exact planner) the
    sharded materialized id set."""
    from repro_torch.core.threshold import threshold_cut

    rb = _row_bytes(engine, predicates, op, row_cache)
    need = float(k)
    tp = engine.plan_cache.peek_two_prong(rb, need)
    if tp is None:
        return None
    bt = None
    th = engine.plan_cache.peek_threshold(rb)
    if th is not None:
        si, sd, cum = th
        n = threshold_cut(sd, cum, need, engine.store.records_per_block)
        bt = np.asarray(si[:n], dtype=np.int64)
    else:
        dist = getattr(engine, "distributed", None)
        if dist is not None and getattr(dist, "two_prong_group", 1) == 1:
            ids = engine.plan_cache.peek_sharded_threshold(rb, need)
            if ids is not None:
                bt = np.asarray(ids, dtype=np.int64)
    if bt is None:
        return None
    b2 = np.arange(int(tp[0]), int(tp[1]), dtype=np.int64)
    # the §7.2 arbitration the wave itself will apply (residency-aware when
    # the engine is): peek must predict the plan that actually runs
    cost = getattr(engine, "plan_cost", engine.cost.io_time)
    return bt if cost(bt) <= cost(b2) else b2


def wave_is_resident(engine, requests: Sequence, max_tier: int | None = None,
                     row_cache: dict | None = None) -> bool:
    """``True`` iff every request's round-0 ``auto`` plan is memoized and
    every planned block is resident in the engine's cache tiers.

    Parameters
    ----------
    engine : repro_torch.core.engine.NeedleTailEngine
        The engine the wave would run on; its ``plan_cache`` is peeked
        (stat-free) and its ``block_cache`` (flat LRU or
        :class:`~repro_torch.storage.tiers.TierStack`) answers residency.
    requests : Sequence
        Objects with ``predicates`` / ``k`` / ``op`` attributes
        (``ExemplarRequest``, ``BatchQuery``, ...).
    max_tier : int | None
        With a :class:`~repro_torch.storage.tiers.TierStack` attached, only count
        residency at tiers ``<= max_tier`` (e.g. ``0`` = "fully HBM-resident
        waves only").  ``None`` accepts any cache tier.
    row_cache : dict | None
        Optional per-probe memo of template → combined-row bytes (see
        :func:`make_residency_probe`), so repeated polls over a hot template
        pool skip the density combine.

    The first failing request short-circuits the scan.
    """
    cache = engine.block_cache
    for r in requests:
        plan = _round0_plan_from_memo(
            engine, r.predicates, r.k, getattr(r, "op", "and"), row_cache
        )
        if plan is None:
            return False
        if max_tier is not None and hasattr(cache, "residency_tier"):
            if plan.size and int(np.max(cache.residency_tier(plan))) > max_tier:
                return False
        elif any(int(b) not in cache for b in plan):
            return False
    return True


def make_residency_probe(engine, max_tier: int | None = None) -> Callable[[Sequence], bool]:
    """Bind :func:`wave_is_resident` to `engine` for
    ``AdmissionController(residency_probe=...)``.  The returned probe keeps
    a private template → row-bytes memo, so keep ONE probe per engine alive
    across polls (``ServeEngine`` caches it) instead of rebuilding it each
    tick."""
    row_cache: dict = {}
    return lambda requests: wave_is_resident(
        engine, requests, max_tier=max_tier, row_cache=row_cache
    )
