"""The port's tiered block storage against the JAX package's, on the CPU.

After ``tests/test_tiering.py``, on its fixtures and sizes: each case runs
the same call sequence through both packages' ``TierStack`` (both built
from the reference's cost presets, carried by ``convert.
cost_model_from_reference``, so placement decisions are priced alike) and
compares slabs against ``store.fetch``, every counter of ``stats``,
``tier_counters()`` and ``snapshot()``, ``effective_io_time`` (rtol 1e-12)
and the residency-aware ``auto`` choice.  The peer-hop and ``ici`` pricing
cases are in ``test_torch_peer_tier.py``; the admission controller and
``ServeEngine`` cases in the serving tests.
"""
import datetime

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.cost_model import make_cost_model as jax_cost
from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro.core.plan_ledger import PlanLedger as JaxLedger
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro.data.synthetic import make_clustered_table
from repro.storage import CostAwarePolicy as JaxCostAware
from repro.storage import RecencyPolicy as JaxRecency
from repro.storage import SyntheticTimingBackend as JaxSynthetic
from repro.storage import Tier as JaxTier
from repro.storage import TierStack as JaxStack
from repro.storage import make_tier_stack as jax_make_tier_stack
from repro.storage.residency import wave_is_resident as jax_wave_is_resident
from repro_torch.convert import cost_model_from_reference as conv
from repro_torch.core.cost_model import ICI_BYTES_PER_S, make_cost_model
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery
from repro_torch.core.plan_ledger import PlanLedger
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.storage import (
    CostAwarePolicy, RecencyPolicy, SyntheticTimingBackend, Tier, TierStack, make_tier_stack,
)
from repro_torch.storage.residency import wave_is_resident

RPB = 64
NB = RPB * (4 * 4 + 2 * 4 + 1)  # slab bytes of the 4-dim/2-measure tables
STAT_FIELDS = ("hits", "misses", "evictions", "invalidations", "invalidation_rereads",
               "store_fetch_calls", "store_blocks_fetched", "bytes_cached", "blocks_cached")


def _make_table(kind: str, seed: int, n: int = 6_000):
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        t = make_clustered_table(num_records=n, num_dims=4, density=0.15, seed=seed,
                                 mean_cluster=48)
        return t.dims, t.measures, np.asarray(t.cards)
    if kind == "uniform":
        return (rng.integers(0, 3, (n, 4)).astype(np.int32),
                rng.normal(size=(n, 2)).astype(np.float32), np.asarray([3, 3, 3, 3]))
    dims = np.zeros((n, 4), np.int32)  # skewed
    dims[: n // 10, 0] = 1
    dims[:, 1] = rng.integers(0, 2, n)
    dims[:, 2] = (np.arange(n) // RPB) % 3
    dims[:, 3] = rng.integers(0, 3, n)
    return dims, rng.normal(size=(n, 2)).astype(np.float32), np.asarray([2, 2, 3, 3])


def _build(dims, meas, cards, rpb=RPB):
    return (jax_build_block_store(JaxTable(dims, meas, cards), rpb),
            build_block_store(Table(dims, meas, cards), rpb, device="cpu"))


_STORES: dict = {}


def _stores(kind: str, seed: int):
    """(reference store, port store) over the same table."""
    if (kind, seed) not in _STORES:
        _STORES[kind, seed] = _build(*_make_table(kind, seed))
    return _STORES[kind, seed]


QUERY_POOL = [
    ([(0, 1)], 40, "and"),
    ([(0, 1), (1, 1)], 120, "and"),
    ([(1, 1), (2, 1)], 60, "or"),
    ([(2, 0)], 25, "and"),
    ([(0, 1), (2, 1), (3, 1)], 200, "and"),
    ([(3, 1), (1, 0)], 90, "or"),
]


def _queries(spec):
    return ([JaxQuery(p, k, op) for p, k, op in spec], [BatchQuery(p, k, op) for p, k, op in spec])


def _policies(policy):
    if policy is None:
        return None, None
    name, *arg = policy
    if name == "recency":
        return JaxRecency(), RecencyPolicy()
    return JaxCostAware(*arg), CostAwarePolicy(*arg)


def _pair(hbm, dram, backing="hdd", block_bytes=256 * 1024, policy=None, device_fill=None):
    """(reference stack, port stack) with the reference's presets."""
    jp, pp = _policies(policy)
    j = jax_make_tier_stack(hbm, dram, backing=backing, block_bytes=block_bytes, policy=jp,
                            device_fill=device_fill)
    return j, port_stack(j, pp)


def port_stack(j, policy=None) -> TierStack:
    """The port's counterpart of the reference's two-tier stack ``j``: the
    same budgets, fill path and preset numbers."""
    return TierStack([Tier(t.name, t.capacity_bytes, conv(t.cost), device=t.device)
                      for t in j.tiers], backing=conv(j.backing), policy=policy,
                     device_fill=j.device_fill, device="cpu")


CONFIGS = {
    "roomy": dict(hbm=None, dram=None),
    "tiny_hbm": dict(hbm=3 * NB, dram=None),
    "tiny_both": dict(hbm=2 * NB, dram=3 * NB),
    "recency": dict(hbm=3 * NB, dram=5 * NB, policy=("recency",)),
    "device_fill": dict(hbm=4 * NB, dram=None, device_fill=True),
}


def _config(name):
    return _pair(**CONFIGS[name])


def _assert_stack_equal(mine, ref):
    assert {f: getattr(mine.stats, f) for f in STAT_FIELDS} == \
        {f: getattr(ref.stats, f) for f in STAT_FIELDS}
    assert mine.tier_counters() == ref.tier_counters()
    assert mine.snapshot() == ref.snapshot()
    for mt, rt in zip(mine.tiers, ref.tiers):
        assert list(mt.block_ids()) == [int(b) for b in rt.block_ids()]


def _assert_slabs(mine, want):
    for m, w in zip(mine, want):
        np.testing.assert_array_equal(m.numpy(), np.asarray(w))
        assert m.numpy().dtype == np.asarray(w).dtype


def _assert_result_equal(a, b):
    np.testing.assert_array_equal(a.record_block, b.record_block)
    np.testing.assert_array_equal(a.record_row, b.record_row)
    np.testing.assert_array_equal(a.measures, b.measures)
    np.testing.assert_array_equal(np.sort(a.blocks_fetched), np.sort(b.blocks_fetched))
    assert a.plan_rounds == b.plan_rounds
    assert a.algo == b.algo


def _assert_batch_equal(a, b):
    assert len(a.results) == len(b.results)
    for ra, rb in zip(a.results, b.results):
        _assert_result_equal(ra, rb)
    assert (a.store_blocks_fetched, a.cache_hits) == (b.store_blocks_fetched, b.cache_hits)
    assert a.tier_stats == b.tier_stats


# ---------------------------------------------------------------------------
# The presets and their ladder.
# ---------------------------------------------------------------------------
def test_cost_model_preset_consistency():
    """Every port preset is self-consistent and the ladder is strict:
    hbm < dram < ssd < hdd on far_cost AND on a scattered fetch; ``ici``,
    the peer hop on one node, costs more than ``dram`` at the default block
    size: it makes ``dram``'s copy to the card after its host copies."""
    ladder = ["hbm", "dram", "ssd", "hdd"]
    scattered = np.asarray([0, 97, 311, 1024, 4097])
    costs = []
    for kind in ladder:
        cm = make_cost_model(kind)
        assert cm.name == kind
        assert 0 < cm.seq_cost <= cm.far_cost
        assert cm.first_block_cost > 0 and cm.max_dist >= 1
        d = np.arange(1, cm.max_dist + 1)
        near = np.asarray(cm.curve(d), dtype=np.float64)
        assert np.all(np.diff(near) >= -1e-12)
        assert near[0] == pytest.approx(cm.seq_cost)
        assert np.all(near <= cm.far_cost + 1e-12)
        assert cm.rand_io(0, cm.max_dist + 10) == pytest.approx(cm.far_cost)
        assert cm.io_time([]) == 0.0
        assert cm.io_time([5]) == pytest.approx(cm.first_block_cost)
        costs.append((cm.far_cost, cm.io_time(scattered)))
    fars, ios = zip(*costs)
    assert list(fars) == sorted(fars) and len(set(fars)) == len(fars)
    assert list(ios) == sorted(ios) and len(set(ios)) == len(ios)
    ici = make_cost_model("ici", NB)  # the peer hop measured on the card
    assert (ici.name, ici.max_dist) == ("ici", 2)
    assert ici.seq_cost == NB / ICI_BYTES_PER_S
    assert 0 < ici.seq_cost <= ici.far_cost == ici.first_block_cost
    ici, dram = make_cost_model("ici"), make_cost_model("dram")
    assert ici.far_cost > dram.far_cost and ici.io_time(scattered) > dram.io_time(scattered)
    # the reference's presets carried across price exactly as the reference
    for kind in ("hbm", "dram", "ssd", "hdd"):
        j = jax_cost(kind, NB)
        assert conv(j).io_time(scattered) == j.io_time(scattered)


# ---------------------------------------------------------------------------
# Every config, both policies: results, slabs and counters equal the
# reference's, cold, warm and under pressure.
# ---------------------------------------------------------------------------
@settings(max_examples=8, deadline=None)
@given(
    st.sampled_from(("clustered", "uniform", "skewed")),
    st.integers(0, 2),
    st.sampled_from(("threshold", "two_prong", "auto")),
    st.sampled_from(tuple(CONFIGS)),
    st.lists(st.sampled_from(QUERY_POOL), min_size=1, max_size=4),
)
def test_tiered_equivalence_to_flat_oracle(kind, seed, algo, config, spec):
    jstore, pstore = _stores(kind, seed)
    jq, pq = _queries(spec)
    oracle = JaxEngine(jstore, cache_bytes=0).any_k_batch(jq, algo=algo)
    jstack, pstack = _config(config)
    ref = JaxEngine(jstore, tiers=jstack)
    eng = NeedleTailEngine(pstore, tiers=pstack, device="cpu")
    for device in (True, False, True):  # cold (device wave), warm (host mirror), third
        mine, theirs = eng.any_k_batch(pq, algo=algo, device=device), ref.any_k_batch(jq, algo=algo)
        _assert_batch_equal(mine, theirs)
        for m, o in zip(mine.results, oracle.results):
            _assert_result_equal(m, o)
        assert mine.tier_stats is not None
        _assert_stack_equal(pstack, jstack)
        for q, r in zip(pq, oracle.results):
            _assert_result_equal(eng.any_k(q.predicates, q.k, op=q.op, algo=algo), r)
        for q in jq:
            ref.any_k(q.predicates, q.k, op=q.op, algo=algo)
        _assert_stack_equal(pstack, jstack)
    if config in ("roomy", "tiny_hbm", "device_fill"):
        warm = eng.any_k_batch(pq, algo=algo)
        _assert_batch_equal(warm, ref.any_k_batch(jq, algo=algo))
        assert warm.store_blocks_fetched == 0 and pstack.stats.evictions == 0
    ids = np.arange(pstore.num_blocks)
    _assert_slabs(pstack.get_many(pstore, ids), jstore.fetch(ids))
    jstack.get_many(jstore, ids)
    _assert_stack_equal(pstack, jstack)


@pytest.mark.parametrize("config", tuple(CONFIGS))
@pytest.mark.parametrize("policy", [None, ("cost", 1), ("recency",)])
def test_get_many_sequences_equal_reference(config, policy):
    """Mixed ``get_many`` / ``ensure`` / ``invalidate`` / ``prefetch`` /
    ``get_device`` sequences: every slab equals ``store.fetch``, every
    counter the reference stack's."""
    jstore, pstore = _stores("uniform", 1)
    kw = dict(CONFIGS[config])
    if policy is not None and config != "recency":
        kw["policy"] = policy
    jstack, pstack = _pair(**kw)
    rng = np.random.default_rng(7)
    for step in range(24):
        op = ("get", "get", "get", "ensure", "inv", "prefetch", "device")[step % 7]
        ids = rng.integers(0, 24, rng.integers(1, 9))
        if op == "get":
            _assert_slabs(pstack.get_many(pstore, ids), jstore.fetch(ids))
            jstack.get_many(jstore, ids)
        elif op == "ensure":
            assert pstack.ensure(pstore, ids) == jstack.ensure(jstore, ids)
        elif op == "inv":
            assert pstack.invalidate(ids[:2]) == jstack.invalidate(ids[:2])
        elif op == "prefetch":
            assert pstack.prefetch(pstore, ids) == jstack.prefetch(jstore, ids)
        else:
            _assert_slabs(pstack.get_device(pstore, ids), jstore.fetch(ids))
            jstack.get_device(jstore, ids)
        _assert_stack_equal(pstack, jstack)
        assert [pstack.accesses(b) for b in range(24)] == [jstack.accesses(b) for b in range(24)]
    pstack.clear()
    jstack.clear()
    _assert_stack_equal(pstack, jstack)


def test_get_wave_books_what_per_query_get_many_books():
    """``get_wave`` (the port's one-gather wave read) books exactly what
    ``get_many`` of each query's blocks would: hits, accesses, LRU order,
    the promotion check and the ledger's hit observations; it returns
    ``None`` and books nothing unless the whole union is in tier 0."""
    _, pstore = _stores("clustered", 0)
    per_query = [np.asarray([1, 3, 5]), np.asarray([3, 8]), np.asarray([0, 1, 8, 9])]
    union = np.unique(np.concatenate(per_query))
    truth = SyntheticTimingBackend({"hbm": make_cost_model("ssd")})
    stacks = []
    for _ in range(2):
        s = make_tier_stack(None, None, device="cpu", policy=CostAwarePolicy(promote_after=1))
        s.ensure(pstore, union)
        s.ledger, s.timing_backend = PlanLedger(), truth
        stacks.append(s)
    wave, single = stacks
    slabs = wave.get_wave(union, per_query)
    _assert_slabs(slabs, [t.numpy() for t in pstore.fetch(union)])
    for b in per_query:
        single.get_many(pstore, b)
    assert wave.snapshot() == single.snapshot()
    assert wave.tier_counters() == single.tier_counters()
    assert wave.access_counts() == single.access_counts()
    assert list(wave.tiers[0].block_ids()) == list(single.tiers[0].block_ids())
    assert wave.ledger.sites.keys() == single.ledger.sites.keys()
    assert [vars(v) for v in wave.ledger.sites.values()] == \
        [vars(v) for v in single.ledger.sites.values()]
    small = make_tier_stack(2 * NB, None, device="cpu")
    small.ensure(pstore, union)
    before = small.snapshot()
    assert small.get_wave(union, per_query) is None
    assert small.snapshot() == before


# ---------------------------------------------------------------------------
# Append invalidation evicts the dirtied tail from EVERY tier.
# ---------------------------------------------------------------------------
@settings(max_examples=6, deadline=None)
@given(
    st.sampled_from(("clustered", "uniform")),
    st.integers(0, 2),
    st.integers(1, 400),
    st.lists(st.sampled_from(QUERY_POOL), min_size=1, max_size=3),
)
def test_append_invalidates_all_tiers(kind, seed, n_extra, spec):
    dims, meas, cards = _make_table(kind, seed)
    xd, xm, _ = _make_table(kind, seed + 100)
    jstore, pstore = _build(dims, meas, cards)
    jstack, pstack = _pair(4 * NB, None)
    ref, eng = JaxEngine(jstore, tiers=jstack), NeedleTailEngine(pstore, tiers=pstack, device="cpu")
    jq, pq = _queries(spec)
    ref.any_k_batch(jq, algo="auto")
    eng.any_k_batch(pq, algo="auto")
    jstack.ensure(jstore, np.arange(jstore.num_blocks))
    pstack.ensure(pstore, np.arange(pstore.num_blocks))
    first_touched = pstore.num_records // RPB
    jgrown = ref.append(JaxTable(xd[:n_extra], xm[:n_extra], cards))
    grown = eng.append(Table(xd[:n_extra], xm[:n_extra], cards))
    for b in range(first_touched, grown.num_blocks):
        for tier in pstack.tiers:
            assert b not in tier
    assert pstack.stats.invalidations > 0
    _assert_stack_equal(pstack, jstack)
    oracle = JaxEngine(jgrown, cache_bytes=0)
    for algo in ("threshold", "auto"):
        mine = eng.any_k_batch(pq, algo=algo)
        _assert_batch_equal(mine, ref.any_k_batch(jq, algo=algo))
        for m, o in zip(mine.results, oracle.any_k_batch(jq, algo=algo).results):
            _assert_result_equal(m, o)


@pytest.mark.parametrize("mode", ["flat", "tiered"])
def test_append_rereads_not_counted_as_misses(mode):
    dims, meas, cards = _make_table("clustered", 3)
    xd, xm, _ = _make_table("clustered", 103)
    jstore, pstore = _build(dims, meas, cards)
    if mode == "tiered":
        jstack, pstack = _pair(4 * NB, None)
        ref = JaxEngine(jstore, tiers=jstack)
        eng = NeedleTailEngine(pstore, tiers=pstack, device="cpu")
    else:
        ref, eng = JaxEngine(jstore), NeedleTailEngine(pstore, device="cpu")
    cache, jcache = eng.block_cache, ref.block_cache
    cache.ensure(pstore, np.arange(pstore.num_blocks))
    jcache.ensure(jstore, np.arange(jstore.num_blocks))
    first_touched = pstore.num_records // RPB
    grown = eng.append(Table(xd[: 2 * RPB], xm[: 2 * RPB], cards))
    jgrown = ref.append(JaxTable(xd[: 2 * RPB], xm[: 2 * RPB], cards))
    touched = np.arange(first_touched, grown.num_blocks)
    misses0, rereads0 = cache.stats.misses, cache.stats.invalidation_rereads
    cache.ensure(grown, touched)
    jcache.ensure(jgrown, touched)
    assert cache.stats.invalidation_rereads - rereads0 == touched.size
    assert cache.stats.misses == misses0
    cache.ensure(grown, touched)
    jcache.ensure(jgrown, touched)
    assert (cache.stats.misses, cache.stats.invalidation_rereads) == \
        (misses0, rereads0 + touched.size)
    assert {f: getattr(cache.stats, f) for f in STAT_FIELDS} == \
        {f: getattr(jcache.stats, f) for f in STAT_FIELDS}
    jq, pq = _queries(QUERY_POOL[:3])
    _assert_batch_equal(eng.any_k_batch(pq, algo="auto"), ref.any_k_batch(jq, algo="auto"))


# ---------------------------------------------------------------------------
# The device wave under a tiny tier-0 budget.
# ---------------------------------------------------------------------------
def test_device_pipeline_rounds_on_tiered_storage():
    jstore, pstore = _stores("clustered", 1)
    jq, pq = _queries(QUERY_POOL[:4])
    jstack, pstack = _pair(2 * NB, None, device_fill=True)
    ref, eng = JaxEngine(jstore, tiers=jstack), NeedleTailEngine(pstore, tiers=pstack, device="cpu")
    for _ in range(2):
        mine = eng.any_k_batch(pq, algo="auto", device=True)
        _assert_batch_equal(mine, ref.any_k_batch(jq, algo="auto", device=True))
        assert mine.device_transfers <= mine.rounds + 1
    assert mine.store_blocks_fetched == 0
    assert pstack.stats.evictions == 0
    tc = pstack.tier_counters()
    assert tc["hbm.demotions_out"] > 0 and tc["dram.demotions_in"] > 0
    _assert_stack_equal(pstack, jstack)


def test_get_device_serves_tier0_residency():
    jstore, pstore = _stores("clustered", 0)
    jstack, pstack = _pair(None, None, device_fill=True)
    ids = np.asarray([0, 3, 7, 2])
    _assert_slabs(pstack.get_device(pstore, ids), jstore.fetch(ids))
    jstack.get_device(jstore, ids)
    assert all(int(b) in pstack.tiers[0] for b in ids)
    h0 = pstack.tiers[0].stats.hits
    pstack.get_device(pstore, ids)
    jstack.get_device(jstore, ids)
    assert pstack.tiers[0].stats.hits == h0 + ids.size
    assert all(pstack.accesses(int(b)) == 2 for b in ids)
    _assert_stack_equal(pstack, jstack)


def test_host_gather_of_device_slab_memoizes_one_download():
    _, pstore = _stores("clustered", 0)
    stack = make_tier_stack(None, None, device_fill=True, device="cpu")
    ids = np.asarray([1, 4])
    ref = [t.numpy() for t in pstore.fetch(ids)]
    _assert_slabs(stack.get_many(pstore, ids), ref)
    m1 = stack.tiers[0].host_view(1)
    assert m1 is not None
    _assert_slabs(m1[:3], [r[0] for r in ref])
    _assert_slabs(stack.get_many(pstore, ids), ref)
    assert stack.tiers[0].host_view(1) is m1  # same mirror object: no re-download
    stack.invalidate([1])
    assert stack.tiers[0]._host_mirror.get(1) is None


# ---------------------------------------------------------------------------
# Placement mechanics.
# ---------------------------------------------------------------------------
def test_cost_aware_promotion_displaces_weakest_incumbent():
    jstore, pstore = _stores("uniform", 0)
    jstack, pstack = _pair(2 * NB, None, policy=("cost", 2))
    for ids in ([0, 1], [2], [2], [2], [2], [2]):
        _assert_slabs(pstack.get_many(pstore, np.asarray(ids)), jstore.fetch(np.asarray(ids)))
        jstack.get_many(jstore, np.asarray(ids))
        _assert_stack_equal(pstack, jstack)
    assert 2 in pstack.tiers[0]
    assert (0 in pstack.tiers[1]) or (1 in pstack.tiers[1])
    assert pstack.stats.evictions == 0
    tc = pstack.tier_counters()
    assert tc["hbm.promotions_in"] == 1 and tc["hbm.demotions_out"] == 1


def test_demotion_into_a_too_small_tier_is_counted_as_a_drop():
    jstore, pstore = _stores("uniform", 0)
    jstack, pstack = _pair(2 * NB, NB // 2, policy=("recency",))
    pstack.get_many(pstore, np.asarray([0, 1]))
    jstack.get_many(jstore, np.asarray([0, 1]))
    ref = jstore.fetch(np.asarray([0, 1, 2]))
    out = pstack.get_many(pstore, np.asarray([2]))
    jstack.get_many(jstore, np.asarray([2]))
    _assert_slabs(out, [r[2:] for r in ref])
    tc = pstack.tier_counters()
    assert pstack.stats.evictions == 1
    assert tc["hbm.evictions"] == 1 and tc["hbm.demotions_out"] == 0
    assert tc["dram.demotions_in"] == 0 and len(pstack.tiers[1]) == 0
    _assert_slabs(pstack.get_many(pstore, np.asarray([0, 1, 2])), ref)
    jstack.get_many(jstore, np.asarray([0, 1, 2]))
    _assert_stack_equal(pstack, jstack)


def test_promotion_into_a_too_small_tier_is_not_ledgered():
    jstore, pstore = _stores("uniform", 0)
    jstack, pstack = _pair(NB // 2, None, policy=("recency",))
    ref = jstore.fetch(np.asarray([0, 1]))
    for _ in range(3):
        _assert_slabs(pstack.get_many(pstore, np.asarray([0, 1])), ref)
        jstack.get_many(jstore, np.asarray([0, 1]))
    tc = pstack.tier_counters()
    assert len(pstack.tiers[0]) == 0
    assert tc["dram.promotions_in"] == 0 and tc["hbm.promotions_in"] == 0
    assert tc["dram.hits"] == 4
    _assert_stack_equal(pstack, jstack)


def test_inverted_cost_ladder_never_promotes():
    jstore, pstore = _stores("uniform", 1)
    hdd, dram = jax_cost("hdd", NB), jax_cost("dram", NB)
    jstack = JaxStack([JaxTier("slow", 4 * NB, hdd), JaxTier("fast", None, dram)],
                      backing=hdd, policy=JaxCostAware(promote_after=1))
    pstack = TierStack([Tier("slow", 4 * NB, conv(hdd)), Tier("fast", None, conv(dram))],
                       backing=conv(hdd), policy=CostAwarePolicy(promote_after=1), device="cpu")
    for _ in range(3):
        _assert_slabs(pstack.get_many(pstore, np.asarray([0, 1, 2])),
                      jstore.fetch(np.asarray([0, 1, 2])))
        jstack.get_many(jstore, np.asarray([0, 1, 2]))
    tc = pstack.tier_counters()
    assert tc["slow.promotions_in"] == 0 and tc["slow.admissions"] == 0
    assert len(pstack.tiers[0]) == 0 and len(pstack.tiers[1]) == 3
    _assert_stack_equal(pstack, jstack)


# ---------------------------------------------------------------------------
# Pricing by residency.
# ---------------------------------------------------------------------------
def test_effective_io_time_prices_by_residency():
    jstore, pstore = _stores("uniform", 2)
    jstack, pstack = _pair(2 * NB, None)
    ids = np.asarray([0, 1, 2, 3])
    cold = pstack.effective_io_time(ids)
    assert cold == pytest.approx(jstack.effective_io_time(ids), rel=1e-12)
    assert cold == pytest.approx(pstack.backing.io_time(ids), rel=1e-12)
    pstack.ensure(pstore, ids)
    jstack.ensure(jstore, ids)
    warm = pstack.effective_io_time(ids)
    assert warm == pytest.approx(jstack.effective_io_time(ids), rel=1e-12)
    assert warm < cold / 100
    for probe in ([10, 11], [0, 5, 1, 12]):
        assert pstack.effective_io_time(probe) == pytest.approx(
            jstack.effective_io_time(probe), rel=1e-12)


def test_effective_io_time_calibrated_mixed_residency():
    jstore, pstore = _stores("uniform", 3)
    jstack, pstack = _pair(0, None, backing="ssd", block_bytes=NB)
    truth = {"ssd": jax_cost("hdd", NB), "dram": jax_cost("dram", 5 * NB)}
    jfit = jstack.calibrate(JaxSynthetic(truth))
    fitted = pstack.calibrate(SyntheticTimingBackend({k: conv(v) for k, v in truth.items()}))
    assert pstack.backing is fitted["ssd"] and pstack.tiers[1].cost is fitted["dram"]
    pstack.ensure(pstore, np.asarray([0, 1]))
    jstack.ensure(jstore, np.asarray([0, 1]))
    assert list(pstack.residency_tier(np.asarray([0, 1, 7, 11]))) == [1, 1, 2, 2]
    for probe in ([0, 1, 7, 11], [0, 0, 1, 7, 7, 11], [1, 0, 11, 7, 1], [3, 40, 41]):
        assert pstack.effective_io_time(probe) == pytest.approx(
            jstack.effective_io_time(probe), rel=1e-12)
    mixed = pstack.effective_io_time([0, 1, 7, 11])
    assert mixed == pytest.approx(fitted["dram"].io_time([0, 1]) + fitted["ssd"].io_time([7, 11]))
    for k in ("ssd", "dram"):
        for ids in ([0, 1], [7, 11], [3, 90, 200]):
            assert fitted[k].io_time(ids) == pytest.approx(jfit[k].io_time(ids), rel=1e-12)
    slow = jax_cost("hdd", NB)
    assert pstack.effective_io_time([7, 11], backing=conv(slow)) == pytest.approx(
        jstack.effective_io_time([7, 11], backing=slow), rel=1e-12)


def test_effective_io_time_applies_ledger_corrections():
    _, pstore = _stores("uniform", 4)
    jstack, stack = _pair(0, None, backing="hdd", block_bytes=NB)
    stack.ledger, jstack.ledger = PlanLedger(), JaxLedger()
    ids = [3, 4, 9]
    base = stack.effective_io_time(ids)
    assert base == pytest.approx(jstack.effective_io_time(ids), rel=1e-12)
    stack.ledger.record("placement", "hdd", 1.0, 4.0)
    jstack.ledger.record("placement", "hdd", 1.0, 4.0)
    corr = stack.ledger.correction("hdd")
    assert corr == pytest.approx(4.0)
    assert stack.effective_io_time(ids) == pytest.approx(base * corr)
    assert stack.effective_io_time(ids) == pytest.approx(jstack.effective_io_time(ids), rel=1e-12)
    stack.ensure(pstore, np.asarray([3]))
    corr2 = stack.ledger.correction("hdd")  # the demand read recorded a wall-clock observation
    expect = stack.tiers[1].cost.io_time([3]) + stack.backing.io_time([4, 9]) * corr2
    assert stack.effective_io_time(ids) == pytest.approx(expect)
    ssd = make_cost_model("ssd", NB)
    assert stack.effective_io_time([4, 9], backing=ssd) == pytest.approx(ssd.io_time([4, 9]))


def test_residency_aware_auto_prefers_resident_plan():
    n_blocks = 60
    dims = np.zeros((n_blocks * RPB, 1), np.int32)
    for b in (0, 50):
        dims[b * RPB:(b + 1) * RPB] = 1
    for b in range(10, 31):
        dims[b * RPB: b * RPB + 10] = 1
    meas = np.arange(dims.shape[0], dtype=np.float32)[:, None]
    jstore, pstore = _build(dims, meas, np.asarray([2]))
    k = 128
    plan_flat, algo_flat = NeedleTailEngine(pstore, device="cpu").plan([(0, 1)], k, algo="auto")
    assert algo_flat == "threshold" and set(plan_flat) == {0, 50}
    jstack, pstack = _pair(None, None)
    ref = JaxEngine(jstore, tiers=jstack, residency_aware=True)
    aware = NeedleTailEngine(pstore, tiers=pstack, residency_aware=True, device="cpu")
    pstack.ensure(pstore, np.arange(10, 31))
    jstack.ensure(jstore, np.arange(10, 31))
    plan_aware, algo_aware = aware.plan([(0, 1)], k, algo="auto")
    jplan, jalgo = ref.plan([(0, 1)], k, algo="auto")
    assert algo_aware == jalgo == "two_prong"
    np.testing.assert_array_equal(plan_aware, jplan)
    assert aware.plan_cost(plan_aware) == pytest.approx(ref.plan_cost(jplan), rel=1e-12)
    r = aware.any_k([(0, 1)], k, algo="auto")
    _assert_result_equal(r, ref.any_k([(0, 1)], k, algo="auto"))
    assert r.num_records >= k
    batch = aware.any_k_batch([BatchQuery([(0, 1)], k)], algo="auto")
    _assert_batch_equal(batch, ref.any_k_batch([JaxQuery([(0, 1)], k)], algo="auto"))
    assert batch.results[0].algo == "two_prong"
    _assert_stack_equal(pstack, jstack)


# ---------------------------------------------------------------------------
# The residency probe.
# ---------------------------------------------------------------------------
def test_residency_probe_after_host_mirror_wave():
    """A host-mirror wave memoizes round 0's plans: the probe then says the
    wave is resident, as the reference's does, and the wave reads no store
    block; an unmemoized template answers False."""
    jstore, pstore = _stores("clustered", 0)
    jstack, pstack = _pair(None, None)
    ref, eng = JaxEngine(jstore, tiers=jstack), NeedleTailEngine(pstore, tiers=pstack, device="cpu")
    jq, pq = _queries(QUERY_POOL[:3])
    assert not wave_is_resident(eng, pq)
    eng.any_k_batch(pq, algo="auto", device=False)
    ref.any_k_batch(jq, algo="auto")
    assert wave_is_resident(eng, pq) and jax_wave_is_resident(ref, jq)
    assert wave_is_resident(eng, pq, max_tier=0) == jax_wave_is_resident(ref, jq, max_tier=0)
    assert eng.any_k_batch(pq, algo="auto").store_blocks_fetched == 0
    cold = [BatchQuery([(1, 1), (3, 1)], 33, "and")]
    assert not wave_is_resident(eng, cold)
    assert not jax_wave_is_resident(ref, [JaxQuery([(1, 1), (3, 1)], 33, "and")])


def test_residency_probe_serves_mesh_attached_engines(tmp_path):
    """A mesh-attached engine's waves feed the sharded-THRESHOLD memo, not
    the host sorted-order memo: the probe peeks that one instead (a world
    of one over gloo)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    _, pstore = _stores("clustered", 1)
    stack = make_tier_stack(None, None, device="cpu")
    eng = NeedleTailEngine(pstore, tiers=stack, device="cpu")
    _, hot = _queries(QUERY_POOL[:2])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        eng.attach_mesh(make_host_mesh(device_type="cpu"))
        assert not wave_is_resident(eng, hot)
        eng.any_k_batch(hot, algo="auto", device=False)
        assert eng.plan_cache.stats.threshold_misses == 0  # host memo untouched
        assert wave_is_resident(eng, hot)
        assert eng.any_k_batch(hot, algo="auto", device=False).store_blocks_fetched == 0
    finally:
        dist.destroy_process_group()


def test_sharded_fetch_plan_prices_by_residency(tmp_path):
    """With a ``remote_cost`` model and a tier stack, ``fetch_plan``
    prices only the blocks no tier holds at the remote price."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    _, pstore = _stores("clustered", 1)
    stack = make_tier_stack(None, None, device="cpu")
    eng = NeedleTailEngine(pstore, tiers=stack, device="cpu")
    remote = make_cost_model("ssd", NB)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        dist_ = eng.attach_mesh(make_host_mesh(device_type="cpu"), remote_cost=remote,
                                candidates=pstore.num_blocks)
        comb = eng.combined_density([(0, 1)])
        plan = dist_.threshold_plan(comb, 64.0)
        ids, bd, bm, bv = dist_.fetch_plan(pstore, plan)
        _assert_slabs((bd, bm, bv), [t.numpy() for t in pstore.fetch(ids)])
        cold = dist_.last_fetch_io_s
        assert cold == pytest.approx(remote.io_time(ids))
        dist_.fetch_plan(pstore, plan)
        assert dist_.last_fetch_io_s < cold
        assert all(int(b) in stack for b in ids)
    finally:
        dist.destroy_process_group()


def test_tier_stack_refuses_a_store_on_another_device():
    _, pstore = _stores("uniform", 0)
    stack = make_tier_stack(None, None, device="cpu")
    stack.get_many(pstore, [0])
    meta_like = type("S", (), {"device": torch.device("meta")})()
    for call in (stack.ensure, stack.get_many, stack.prefetch):
        with pytest.raises(ValueError, match="tier stack"):
            call(meta_like, [0])


def test_chip_smoke_tiered_storage_phases_pass_on_a_small_cpu_store():
    """chip_smoke.py's tiered, calibration, append_compact and prefetch
    phases at a small size on the plain versions (CUDA-event timing
    replaced by a call; budgets cut to blocks of the 300,000-record table so
    tier 0 overflows and the recency budgets drop blocks)."""
    import importlib.util
    import pathlib

    from repro_torch.data import synthetic

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.time_ms = lambda fn, flush=None: (fn(), 0.0)[1]
    table = synthetic.make_real_like_table("airline", num_records=300_000, seed=0)
    store = build_block_store(table, cs.RPB, device="cpu")
    nb = TierStack.block_nbytes(store)
    queries = cs.make_wave(table.cards, 16, seed=0)

    def run(name, fn):
        assert name in cs.PHASE_KERNELS
        return fn(), 0.0, {}

    flat = NeedleTailEngine(store, device="cpu").any_k_batch(queries)
    union = int(flat.unique_blocks_fetched.size)
    assert union > 12
    ti = cs.tiered_check(store, store, queries, flat, {"cold": 0.0, "warm": 0.0}, run,
                         device="cpu", hbm_bytes=8 * nb, recency=(4 * nb, 8 * nb))
    assert ti["tier_blocks"][0] == 8 and sum(ti["tier_blocks"]) == union
    assert ti["recency"]["evictions"] > 0 and ti["tier_stats"]["warm"]["hbm.hits"] > 0
    ca = cs.calibration_check(store, ti["stack"], queries, run, device="cpu", hbm_bytes=8 * nb)
    assert set(ca["levels"]) == {"hbm", "dram", "hdd"}
    assert any(k.startswith("placement/") for k in ca["qerrors"])
    ac = cs.append_compact_check(table, store, store, ti["engine"], ti["stack"], queries, run,
                                 seed=0, device="cpu", rows=20_000)
    assert ac["append"]["evicted"] == 1 and ac["append"]["kept"] > 0
    assert ac["compact"]["blocks"] == ac["append"]["blocks"] == -(-(300_000 + 20_000) // cs.RPB)
    pf = cs.prefetch_check(store, queries, run, device="cpu", hbm_bytes=8 * nb)
    assert pf["queries"] == sum(q.algo is None for q in queries)
    assert pf["sync"]["issued"] == pf["async"]["issued"] > 8
    assert pf["sync"]["round_reads"][0] == pf["async"]["round_reads"][0] == 0
    assert pf["sync"]["hbm_blocks"] == 8
    broken = NeedleTailEngine(store, device="cpu").any_k_batch(queries[1:] + queries[:1])
    with pytest.raises(AssertionError):
        cs.tiered_check(store, store, queries, broken, {"cold": 0.0, "warm": 0.0}, run,
                        device="cpu", hbm_bytes=8 * nb, recency=(4 * nb, 8 * nb))
