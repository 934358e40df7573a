"""The port's engine caches against the JAX package's, on the CPU.

``BlockLRUCache.get_many`` must return ``store.fetch``'s bytes in every
cache state (cold, warm, evicting, invalidated, disabled), and its counters
must equal the reference cache's on the same call sequence over a store
built from the same table (after ``tests/test_block_cache.py``, without the
sharded case).  The plan-order memo must hit across batches, and the
engine's results must not depend on the cache's state.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro.core.block_cache import BlockLRUCache as JaxCache
from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro.data.synthetic import make_clustered_table
from repro_torch.core.block_cache import BlockLRUCache, PlanOrderCache
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery
from repro_torch.data.block_store import Table, build_block_store

RPB = 64
STAT_FIELDS = ("hits", "misses", "evictions", "invalidations", "invalidation_rereads",
               "store_fetch_calls", "store_blocks_fetched", "bytes_cached", "blocks_cached")


def _table(kind: str, seed: int, n: int = 3_000):
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        t = make_clustered_table(num_records=n, num_dims=4, density=0.15, seed=seed,
                                 mean_cluster=48)
        return t.dims, t.measures, np.asarray(t.cards)
    if kind == "uniform":
        return (rng.integers(0, 3, (n, 4)).astype(np.int32),
                rng.normal(size=(n, 2)).astype(np.float32), np.asarray([3, 3, 3, 3]))
    dims = np.zeros((n, 4), np.int32)  # skewed: density piled at one end
    dims[: n // 10, 0] = 1
    dims[:, 1] = rng.integers(0, 2, n)
    dims[:, 2] = (np.arange(n) // RPB) % 3
    dims[:, 3] = rng.integers(0, 3, n)
    return dims, rng.normal(size=(n, 2)).astype(np.float32), np.asarray([2, 2, 3, 3])


_STORES: dict = {}


def _stores(kind: str, seed: int = 0):
    """(reference store, port store) over the same table."""
    if (kind, seed) not in _STORES:
        dims, meas, cards = _table(kind, seed)
        _STORES[kind, seed] = (jax_build_block_store(JaxTable(dims, meas, cards), RPB),
                               build_block_store(Table(dims, meas, cards), RPB, device="cpu"))
    return _STORES[kind, seed]


def _block_nbytes(store) -> int:
    return store.records_per_block * (store.dims.shape[-1] * 4 + store.measures.shape[-1] * 4 + 1)


def _assert_slabs(mine, ref):
    for m, r in zip(mine, ref):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))
        assert m.numpy().dtype == np.asarray(r).dtype


def _assert_stats(mine, ref):
    assert {f: getattr(mine.stats, f) for f in STAT_FIELDS} == \
        {f: getattr(ref.stats, f) for f in STAT_FIELDS}


# call sequences over block ids: (op, ids); "inv" invalidates, "ens" ensures
SEQUENCES = {
    "cold_then_warm": [("get", [0, 1, 2]), ("get", [2, 1, 0]), ("get", [5, 1, 9])],
    "lru_touch_then_evict": [("get", [0, 1, 2]), ("get", [0]), ("get", [3]), ("get", [1, 2])],
    "oversized_request": [("get", [0, 1, 2, 3, 4, 5]), ("get", [5, 0, 3])],
    "evicts_precall_hits": [("get", [7, 8]), ("get", [1, 2, 7, 3, 8, 4])],
    "invalidated_rereads": [("get", [0, 1, 2, 3]), ("inv", [2, 3, 40]), ("get", [3, 0, 2]),
                            ("get", [2])],
    "ensure_then_get": [("ens", [4, 2, 9, 2]), ("get", [2, 4]), ("ens", [9, 10]),
                        ("get", [10, 11, 4])],
    "repeated_ids": [("get", [3, 3, 1]), ("get", [1, 3, 6, 6])],
}


@pytest.mark.parametrize("budget", [None, 3, 0], ids=["unbounded", "three_blocks", "off"])
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_get_many_bytes_and_counters_equal_the_reference(seq, budget):
    jstore, pstore = _stores("uniform")
    cap = None if budget is None else budget * _block_nbytes(pstore)
    mine, ref = BlockLRUCache(cap), JaxCache(cap)
    mine.fetch_log, ref.fetch_log = [], []
    for op, ids in SEQUENCES[seq]:
        ids = np.asarray(ids, dtype=np.int64)
        if op == "get":
            _assert_slabs(mine.get_many(pstore, ids), ref.get_many(jstore, ids))
            _assert_slabs(mine.get_many(pstore, ids[:0]), ref.get_many(jstore, ids[:0]))
        elif op == "ens":
            assert mine.ensure(pstore, ids) == ref.ensure(jstore, ids)
        else:
            assert mine.invalidate(ids) == ref.invalidate(ids)
        _assert_stats(mine, ref)
        assert sorted(mine._slabs) == sorted(ref._slabs)
        assert list(mine._slabs) == list(ref._slabs)  # the same LRU order
    assert [list(a) for a in mine.fetch_log] == [list(a) for a in ref.fetch_log]
    assert mine.stats.snapshot() == ref.stats.snapshot()


@pytest.mark.parametrize("budget", [None, 5], ids=["unbounded", "five_blocks"])
def test_ensure_in_pieces_books_one_read_and_ends_as_the_reference(budget, monkeypatch):
    """``ensure`` fetches its misses a few blocks at a time, yet books one
    store read and ends in the reference's state; unbounded, its pool grows
    once for a whole store's fill, to the store's block count."""
    import repro_torch.core.block_cache as bc

    monkeypatch.setattr(bc, "_ENSURE_BLOCKS", 3)
    jstore, pstore = _stores("uniform")
    cap = None if budget is None else budget * _block_nbytes(pstore)
    mine, ref = BlockLRUCache(cap), JaxCache(cap)
    mine.fetch_log, ref.fetch_log = [], []
    grows = []
    grow = mine._grow
    monkeypatch.setattr(mine, "_grow", lambda *a: (grows.append(a[1:]), grow(*a)))
    everything = np.arange(pstore.num_blocks)[::-1]
    for op, ids in [("ens", [0, 1]), ("inv", [1]), ("ens", everything), ("get", [4, 0, 7])]:
        ids = np.asarray(ids, dtype=np.int64)
        if op == "ens":
            n_grows = len(grows)
            assert mine.ensure(pstore, ids) == ref.ensure(jstore, ids)
        elif op == "inv":
            assert mine.invalidate(ids) == ref.invalidate(ids)
        else:
            _assert_slabs(mine.get_many(pstore, ids), ref.get_many(jstore, ids))
        _assert_stats(mine, ref)
        assert list(mine._slabs) == list(ref._slabs)
    assert [list(a) for a in mine.fetch_log] == [list(a) for a in ref.fetch_log]
    kept = np.asarray(list(mine._slabs), dtype=np.int64)
    _assert_slabs(mine.get_many(pstore, kept), jstore.fetch(kept))
    if budget is None:
        assert len(grows) - n_grows == 1 and mine._pool[0].shape[0] == pstore.num_blocks
    else:
        assert mine._pool[0].shape[0] <= budget


def test_byte_budget_never_exceeded_and_bytes_hold_under_churn():
    jstore, pstore = _stores("uniform", 1)
    nb = _block_nbytes(pstore)
    cache = BlockLRUCache(capacity_bytes=4 * nb)
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = np.sort(rng.choice(pstore.num_blocks, size=rng.integers(1, 7), replace=False))
        _assert_slabs(cache.get_many(pstore, ids), jstore.fetch(ids))
        assert cache.stats.bytes_cached <= 4 * nb
        assert len(cache) <= 4
    assert cache.stats.evictions > 0


def test_clear_and_invalidate_evict_exactly():
    _, pstore = _stores("uniform", 2)
    cache = BlockLRUCache()
    cache.get_many(pstore, np.arange(8))
    assert cache.invalidate([2, 3, 99]) == 2
    assert 2 not in cache and 3 not in cache and all(b in cache for b in (0, 1, 4, 5, 6, 7))
    assert cache.stats.invalidations == 2
    cache.clear()
    assert len(cache) == 0 and cache.nbytes == 0 and cache.stats.invalidations == 8
    _assert_slabs(cache.get_many(pstore, np.asarray([7, 0])),
                  _stores("uniform", 2)[0].fetch(np.asarray([7, 0])))


def test_get_wave_books_what_per_query_get_many_would():
    """The wave's one-gather read books the hits and LRU touches of the
    per-query reads it stands for, and declines when the budget cannot hold
    the union."""
    _, pstore = _stores("clustered")
    per_query = [np.asarray([1, 4, 6]), np.asarray([4]), np.asarray([0, 6, 9])]
    union = np.unique(np.concatenate(per_query))
    a, b = BlockLRUCache(), BlockLRUCache()
    a.ensure(pstore, union)
    b.ensure(pstore, union)
    slabs = a.get_wave(union, per_query)
    for ids in per_query:
        b.get_many(pstore, ids)
    _assert_slabs(slabs, pstore.fetch(union))
    _assert_stats(a, b)
    assert list(a._slabs) == list(b._slabs)
    small = BlockLRUCache(2 * _block_nbytes(pstore))
    small.ensure(pstore, union)
    assert small.get_wave(union, per_query) is None
    assert BlockLRUCache(0).get_wave(union, per_query) is None


def test_dead_engines_do_not_pin_their_caches():
    dims, meas, cards = _table("uniform", 3)
    store = build_block_store(Table(dims, meas, cards), RPB, device="cpu")
    eng = NeedleTailEngine(store, device="cpu")
    eng.any_k([(0, 1)], 20, algo="threshold")
    cache_ref = weakref.ref(eng.block_cache)
    for _ in range(5):
        NeedleTailEngine(store, device="cpu")
    del eng
    gc.collect()
    assert cache_ref() is None
    store.notify_invalidated(np.asarray([0]))  # dead listeners prune silently
    assert len(store._invalidation_listeners) == 0


def test_store_notifies_the_engine_cache():
    _, pstore = _stores("skewed")
    eng = NeedleTailEngine(pstore, device="cpu")
    eng.any_k([(0, 1)], 40, algo="threshold")
    cached = [b for b in range(pstore.num_blocks) if b in eng.block_cache]
    assert cached
    calls = []

    def listener(ids):
        calls.append(ids)

    pstore.register_invalidation_listener(listener)
    pstore.register_invalidation_listener(listener)  # registered once
    pstore.notify_invalidated(np.asarray(cached[:1]))
    assert cached[0] not in eng.block_cache and len(calls) == 1
    pstore.unregister_invalidation_listener(listener)
    pstore.unregister_invalidation_listener(eng.block_cache.invalidate)


QUERY_POOL = [
    ([(0, 1)], 40, "and"), ([(0, 1), (1, 1)], 120, "and"), ([(1, 1), (2, 1)], 60, "or"),
    ([(2, 0)], 25, "and"), ([(0, 1), (2, 1), (3, 1)], 200, "and"), ([(3, 1), (1, 0)], 90, "or"),
]


@pytest.mark.parametrize("algo", ["threshold", "two_prong", "auto"])
@pytest.mark.parametrize("kind", ["clustered", "uniform", "skewed"])
def test_engine_results_and_counters_across_cache_states(kind, algo):
    """Cold, warm, budget-constrained and disabled caches give the same
    bytes; every state's batch counters equal the reference engine's."""
    from test_torch_engine import _assert_query_equal

    jstore, pstore = _stores(kind)
    spec = QUERY_POOL[:5] if kind != "skewed" else QUERY_POOL[1:]
    qs, jqs = [BatchQuery(*q) for q in spec], [JaxQuery(*q) for q in spec]
    tiny = 3 * _block_nbytes(pstore)
    for cache_bytes in (None, tiny, 0):
        mine = NeedleTailEngine(pstore, cache_bytes=cache_bytes, device="cpu")
        ref = JaxEngine(jstore, cache_bytes=cache_bytes)
        for _ in range(2):  # cold, then warm
            for device in (False, True):
                m = mine.any_k_batch(qs, algo=algo, device=device)
                r = ref.any_k_batch(jqs, algo=algo, device=device)
                for a, b in zip(m.results, r.results):
                    _assert_query_equal(a, b)
                assert (m.store_blocks_fetched, m.cache_hits, m.rounds) == \
                    (r.store_blocks_fetched, r.cache_hits, r.rounds)
                assert m.modeled_store_io_s == r.modeled_store_io_s
                assert m.store_dedup_ratio == r.store_dedup_ratio
                _assert_stats(mine.block_cache, ref.block_cache)
        for q in spec[:2]:
            _assert_query_equal(mine.any_k(*q[:2], op=q[2], algo=algo),
                                ref.any_k(*q[:2], op=q[2], algo=algo))
            _assert_stats(mine.block_cache, ref.block_cache)
        if cache_bytes == tiny:
            assert mine.block_cache.stats.evictions > 0


def test_plan_order_memo_hits_across_batches():
    jstore, pstore = _stores("clustered", 1)
    eng = NeedleTailEngine(pstore, device="cpu")
    ref = JaxEngine(jstore)
    qs = [BatchQuery(*q) for q in QUERY_POOL[:4]]
    jqs = [JaxQuery(*q) for q in QUERY_POOL[:4]]
    for _ in range(2):
        eng.any_k_batch(qs, algo="auto", device=False)
        ref.any_k_batch(jqs, algo="auto")
        assert eng.plan_cache.stats == type(eng.plan_cache.stats)(
            **{f: getattr(ref.plan_cache.stats, f) for f in
               ("threshold_hits", "threshold_misses", "two_prong_hits", "two_prong_misses")})
    assert eng.plan_cache.stats.threshold_hits > 0 and eng.plan_cache.stats.two_prong_hits > 0
    assert eng.plan_cache.stats.threshold_misses > 0  # the cold batch


def test_plan_order_memo_bounds_its_entries():
    memo = PlanOrderCache(max_entries=2)
    for i in range(3):
        memo.put_threshold(bytes([i]), np.arange(3), np.ones(3), np.arange(3.0))
        memo.put_two_prong(bytes([i]), 5.0, i, i + 1)
    assert memo.get_threshold(bytes([0])) is None and memo.get_two_prong(bytes([0]), 5.0) is None
    assert memo.get_two_prong(bytes([2]), 5.0) == (2, 3)
    np.testing.assert_array_equal(memo.get_threshold(bytes([1]))[0], np.arange(3))
    assert (memo.stats.hits, memo.stats.threshold_misses, memo.stats.two_prong_misses) == (2, 1, 1)
    memo.clear()
    assert memo.get_threshold(bytes([1])) is None


def test_cached_slabs_are_device_tensors_in_a_slot_pool():
    """The cache keeps its slabs on the store's device, one pool slot per
    block; slots of evicted blocks are reused."""
    _, pstore = _stores("uniform")
    nb = _block_nbytes(pstore)
    cache = BlockLRUCache(2 * nb)
    for ids in ([0, 1], [2], [3], [0]):
        out = cache.get_many(pstore, np.asarray(ids))
        assert all(isinstance(t, torch.Tensor) and t.device == pstore.device for t in out)
    assert cache._pool[0].shape[0] == 2  # never more slots than the budget holds
    assert cache.nbytes == 2 * nb
