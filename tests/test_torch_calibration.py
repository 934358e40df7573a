"""The port's calibrated cost models, plan ledger, append, compaction and
prefetcher against the JAX package's, on the CPU.

After ``tests/test_calibration.py`` (all 17 cases, each run through both
packages on the same call sequence): fitted models equal the reference's
on the same ``SyntheticTimingBackend`` (f64, rtol 1e-12), the ledger's
q-errors, corrections and wave rows are equal, recalibration and
arbitration flip the same decisions, and ``compact_tail`` /
``TailCompactor`` give bit-equal stores.  Then append (after
``tests/test_extensions.py``, ``tests/test_block_cache.py`` and
``tests/test_online_agg.py``): the grown index is bit-equal to a full
rebuild and to the reference's append.  ``StoreTimingBackend`` is driven by
a counting clock (synchronising a card store inside its window), and the
prefetcher's sync kick / drain / observe counters, invalidation and
truncation equal the reference ``TierPrefetcher``'s, driven without the
serving engine (after ``tests/test_serving_loop.py``).
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.cost_model import CostModel as JaxCostModel
from repro.core.cost_model import _linear_curve as jax_linear_curve
from repro.core.cost_model import make_cost_model as jax_cost
from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro.core.plan_ledger import PlanLedger as JaxLedger
from repro.data.append import append_records as jax_append
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro.data.synthetic import make_clustered_table
from repro.storage import SyntheticTimingBackend as JaxSynthetic
from repro.storage import TailCompactor as JaxCompactor
from repro.storage import Tier as JaxTier
from repro.storage import TierStack as JaxStack
from repro.storage import calibrate_model as jax_calibrate_model
from repro.storage import compact_tail as jax_compact_tail
from repro.storage import make_tier_stack as jax_make_tier_stack
from repro.storage.prefetch import TierPrefetcher as JaxPrefetcher
from repro.storage.prefetch import predicted_wave_blocks as jax_predicted
from repro_torch.convert import cost_model_from_reference as conv
from repro_torch.core.cost_model import make_cost_model
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery
from repro_torch.core.plan_ledger import PlanLedger
from repro_torch.data.append import append_records
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.storage import (
    StoreTimingBackend, SyntheticTimingBackend, TailCompactor, Tier, TierPrefetcher, TierStack,
    calibrate_model, compact_tail, measurable, predicted_wave_blocks,
)

RPB = 64
STAT_FIELDS = ("hits", "misses", "evictions", "invalidations", "invalidation_rereads",
               "store_fetch_calls", "store_blocks_fetched", "bytes_cached", "blocks_cached")
PROBES = ([3], [0, 1, 2, 3], [0, 63, 200, 900], [5, 500], [0, 100, 5000], [7, 11, 12, 40])


def _table(seed: int, n: int = 6_000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, (n, 4)).astype(np.int32),
            rng.normal(size=(n, 2)).astype(np.float32), np.asarray([3, 3, 3, 3]))


def _build(dims, meas, cards, rpb=RPB):
    return (jax_build_block_store(JaxTable(dims, meas, cards), rpb),
            build_block_store(Table(dims, meas, cards), rpb, device="cpu"))


_STORES: dict = {}


def _stores(seed: int):
    if seed not in _STORES:
        _STORES[seed] = _build(*_table(seed))
    return _STORES[seed]


QUERY_POOL = [
    ([(0, 1)], 40, "and"),
    ([(0, 1), (1, 1)], 120, "and"),
    ([(1, 1), (2, 1)], 60, "or"),
    ([(2, 0)], 25, "and"),
    ([(0, 1), (2, 1), (3, 1)], 200, "and"),
]


def _queries(spec):
    return ([JaxQuery(p, k, op=op) for p, k, op in spec],
            [BatchQuery(p, k, op=op) for p, k, op in spec])


def _assert_models_equal(mine, ref):
    assert mine.name == ref.name and mine.max_dist == ref.max_dist
    for a, b in ((mine.seq_cost, ref.seq_cost), (mine.far_cost, ref.far_cost),
                 (mine.first_block_cost, ref.first_block_cost)):
        assert a == pytest.approx(b, rel=1e-12)
    for ids in PROBES:
        assert mine.io_time(ids) == pytest.approx(ref.io_time(ids), rel=1e-12)


def _assert_ledgers_equal(mine, ref):
    assert mine.sites.keys() == ref.sites.keys()
    for key in ref.sites:
        m, r = vars(mine.sites[key]), vars(ref.sites[key])
        assert m.keys() == r.keys()
        for f in r:
            assert m[f] == pytest.approx(r[f], rel=1e-12), (key, f)
    assert mine.corrections() == pytest.approx(ref.corrections(), rel=1e-12)
    assert len(mine.waves) == len(ref.waves)
    for a, b in zip(mine.waves, ref.waves):
        assert a["wave"] == b["wave"]
        assert a["qerror"] == pytest.approx(b["qerror"], rel=1e-12)
        assert a["running"] == pytest.approx(b["running"], rel=1e-12)
        assert a["per_tier"] == pytest.approx(b["per_tier"], rel=1e-12)


def _assert_stacks_equal(mine, ref):
    assert {f: getattr(mine.stats, f) for f in STAT_FIELDS} == \
        {f: getattr(ref.stats, f) for f in STAT_FIELDS}
    assert mine.tier_counters() == ref.tier_counters()
    assert mine.snapshot() == ref.snapshot()


def _slow_model(base, factor: float, name: str) -> JaxCostModel:
    return JaxCostModel(
        name, base.seq_cost * factor, base.max_dist, base.far_cost * factor,
        jax_linear_curve(base.seq_cost * factor, base.far_cost * factor, base.max_dist),
        base.first_block_cost * factor,
    )


def _truth(nb: int) -> dict:
    hdd = jax_cost("hdd")
    return {"ssd": hdd, "dram": jax_cost("dram", nb * 5), "hbm": _slow_model(hdd, 2.0, "hbm-truth")}


def _backends(truth: dict):
    return JaxSynthetic(truth), SyntheticTimingBackend({k: conv(v) for k, v in truth.items()})


def _mispreset_engines(jstore, pstore, feedback: bool = True):
    """(reference, port) engines whose presets the timing truth deviates
    from, as ``tests/test_calibration.py::_mispreset_engine``."""
    nb = JaxStack.block_nbytes(jstore)
    assert TierStack.block_nbytes(pstore) == nb
    hbm, dram, ssd = jax_cost("hbm", nb), jax_cost("dram", nb), jax_cost("ssd")
    jstack = JaxStack([JaxTier("hbm", 8 * nb, hbm), JaxTier("dram", None, dram)], backing=ssd)
    pstack = TierStack([Tier("hbm", 8 * nb, conv(hbm)), Tier("dram", None, conv(dram))],
                       backing=conv(ssd), device="cpu")
    jbe, pbe = _backends(_truth(nb))
    ref = JaxEngine(jstore, ssd, tiers=jstack, ledger=JaxLedger(feedback=feedback),
                    timing_backend=jbe)
    eng = NeedleTailEngine(pstore, conv(ssd), tiers=pstack, ledger=PlanLedger(feedback=feedback),
                           timing_backend=pbe, device="cpu")
    return ref, eng


def _assert_result_equal(a, b):
    np.testing.assert_array_equal(a.record_block, b.record_block)
    np.testing.assert_array_equal(a.record_row, b.record_row)
    np.testing.assert_array_equal(a.measures, b.measures)


def _both_waves(ref, eng, spec):
    """The same wave through both engines, each held against a cache-less
    oracle sharing its CURRENT store and planning model; the two engines'
    results, counters and ledgers equal."""
    jq, pq = _queries(spec)
    oracle = JaxEngine(ref.store, ref.cost, cache_bytes=0)
    seq = [oracle.any_k(q.predicates, q.k, op=q.op, algo="auto") for q in jq]
    mine, theirs = eng.any_k_batch(pq, algo="auto"), ref.any_k_batch(jq, algo="auto")
    for s, a, b in zip(seq, mine.results, theirs.results):
        _assert_result_equal(a, s)
        _assert_result_equal(b, s)
    assert (mine.store_blocks_fetched, mine.cache_hits, mine.tier_stats) == \
        (theirs.store_blocks_fetched, theirs.cache_hits, theirs.tier_stats)
    _assert_stacks_equal(eng.block_cache, ref.block_cache)
    _assert_ledgers_equal(eng.ledger, ref.ledger)
    return mine


# ---------------------------------------------------------------------------
# calibrate_model: §4.3.1 refit from a timing backend.
# ---------------------------------------------------------------------------
def test_calibrate_model_recovers_deviating_truth():
    truth = jax_cost("hdd")
    jbe, pbe = _backends({"ssd": truth})
    fitted = calibrate_model(pbe, "ssd", base=make_cost_model("ssd"))
    _assert_models_equal(fitted, jax_calibrate_model(jbe, "ssd", base=jax_cost("ssd")))
    assert fitted.name == "ssd"
    assert fitted.far_cost == pytest.approx(truth.far_cost, rel=0.05)
    assert fitted.first_block_cost == pytest.approx(truth.first_block_cost, rel=0.05)
    for ids in ([3], [0, 1, 2, 3], [0, 63, 200, 900], [5, 500]):
        q = fitted.io_time(ids) / truth.io_time(ids)
        assert max(q, 1.0 / q) < 1.5


def test_calibrate_model_near_flat_truth():
    truth = jax_cost("ssd")
    jbe, pbe = _backends({"hdd": truth})
    fitted = calibrate_model(pbe, "hdd", base=make_cost_model("hdd"))
    _assert_models_equal(fitted, jax_calibrate_model(jbe, "hdd", base=jax_cost("hdd")))
    for ids in ([0, 1, 2], [0, 100, 5000]):
        q = fitted.io_time(ids) / truth.io_time(ids)
        assert max(q, 1.0 / q) < 1.5


def test_tier_stack_calibrate_refits_in_place():
    _, pstore = _stores(0)
    nb = TierStack.block_nbytes(pstore)
    dram, ici, ssd = jax_cost("dram", nb), jax_cost("ici", nb), jax_cost("ssd")
    jstack = JaxStack([JaxTier("dram", None, dram), JaxTier("peer", None, ici)], backing=ssd)
    stack = TierStack([Tier("dram", None, conv(dram)), Tier("peer", None, conv(ici))],
                      backing=conv(ssd), device="cpu")
    jbe, be = _backends({"ssd": jax_cost("hdd"), "dram": jax_cost("dram", nb * 5)})
    jfit, fitted = jstack.calibrate(jbe), stack.calibrate(be)
    assert set(fitted) == set(jfit) == {"ssd", "dram"}
    for k in fitted:
        _assert_models_equal(fitted[k], jfit[k])
    assert stack.backing is fitted["ssd"] and stack.tiers[0].cost is fitted["dram"]
    assert stack.tiers[1].cost.name == "ici"
    assert stack.timing_backend is be
    assert not measurable(be, "peer") and measurable(be, "dram")
    assert set(stack.calibrate()) == {"ssd", "dram"}
    with pytest.raises(ValueError):
        TierStack([Tier("dram", None, conv(dram))], device="cpu").calibrate()


# ---------------------------------------------------------------------------
# PlanLedger: q-error accounting and correction hysteresis.
# ---------------------------------------------------------------------------
def _ledger_pair(**kw):
    return PlanLedger(**kw), JaxLedger(**kw)


def test_ledger_qerror_and_sites():
    lg, jl = _ledger_pair()
    assert lg.qerror() == 1.0
    for args in (("placement", "ssd", 1.0, 8.0), ("placement", "ssd", 8.0, 1.0),
                 ("arbitration", "ssd", 2.0, 2.0)):
        assert lg.record(*args) == pytest.approx(jl.record(*args), rel=1e-12)
    assert lg.qerror(site="placement", tier="ssd") == pytest.approx(8.0)
    assert lg.qerror(site="arbitration") == pytest.approx(1.0)
    assert lg.qerror() == pytest.approx(8.0) and lg.max_qerror() == pytest.approx(8.0)
    _assert_ledgers_equal(lg, jl)
    a, b = PlanLedger(), PlanLedger()
    a.record("placement", "t", 1.0, 4.0)
    b.record("placement", "t", 4.0, 1.0)
    assert a.qerror() == pytest.approx(b.qerror())


def test_ledger_correction_hysteresis_and_idempotence():
    lg, jl = _ledger_pair(hysteresis=0.15)
    for pred, obs in ((1.0, 4.0), (4.0, 4.0), (4.0, 4.2)):
        lg.record("placement", "ssd", pred, obs)
        jl.record("placement", "ssd", pred, obs)
        c = lg.correction("ssd")
        assert c == jl.correction("ssd") and lg.correction("ssd") == c
    assert c == pytest.approx(4.0)
    wild, jwild = _ledger_pair(correction_bounds=(0.5, 2.0))
    for led in (wild, jwild):
        led.record("placement", "x", 1.0, 1000.0)
        led.record("placement", "y", 1000.0, 1.0)
    assert (wild.correction("x"), wild.correction("y")) == (2.0, 0.5) == \
        (jwild.correction("x"), jwild.correction("y"))
    _assert_ledgers_equal(lg, jl)


def test_ledger_no_oscillation_under_alternating_noise():
    lg, jl = _ledger_pair(hysteresis=0.15)
    seen = set()
    for led in (lg, jl):
        led.record("placement", "ssd", 1.0, 2.0)
    committed = lg.correction("ssd")
    assert jl.correction("ssd") == committed
    for i in range(20):
        obs = 2.0 * (1.1 if i % 2 else 0.9)
        for led in (lg, jl):
            led.record("placement", "ssd", 2.0, obs)
        seen.add(lg.correction("ssd"))
        assert jl.correction("ssd") == lg.correction("ssd")
    assert seen == {committed}
    _assert_ledgers_equal(lg, jl)


def test_ledger_feedback_off_and_reset():
    audit = PlanLedger(feedback=False)
    audit.record("placement", "ssd", 1.0, 100.0)
    assert audit.correction("ssd") == 1.0
    assert audit.qerror() == pytest.approx(100.0)
    lg, jl = _ledger_pair()
    for led in (lg, jl):
        led.record("placement", "ssd", 1.0, 8.0)
        assert led.correction("ssd") == pytest.approx(8.0)
        led.reset_correction("ssd")
        assert led.correction("ssd") == 1.0
    assert lg.max_qerror() == pytest.approx(8.0)
    assert lg.sites[("placement", "ssd")].ewma_log_ratio == 0.0
    _assert_ledgers_equal(lg, jl)


def test_ledger_wave_rows():
    lg, jl = _ledger_pair()
    for led in (lg, jl):
        led.record("placement", "ssd", 1.0, 10.0)
        row = led.note_wave()
        assert row["qerror"] == pytest.approx(10.0)
        row2 = led.note_wave()
        assert row2["qerror"] == 1.0 and row2["per_tier"] == {}
        assert row2["running"] == pytest.approx(10.0)
    assert lg.wave_qerrors() == jl.wave_qerrors()
    _assert_ledgers_equal(lg, jl)


# ---------------------------------------------------------------------------
# Engine integration: q-error shrinks, decisions flip, bytes never change.
# ---------------------------------------------------------------------------
def test_recalibration_shrinks_wave_qerror_monotonically():
    jstore, pstore = _stores(1)
    ref, eng = _mispreset_engines(jstore, pstore)
    sref, static = _mispreset_engines(jstore, pstore, feedback=False)
    series, series_s = [], []
    for w in range(3):
        spec = QUERY_POOL[w % len(QUERY_POOL):] + QUERY_POOL[:w % len(QUERY_POOL)]
        _both_waves(ref, eng, spec)
        series.append(eng.ledger.note_wave()["qerror"])
        ref.ledger.note_wave()
        _both_waves(sref, static, spec)
        series_s.append(static.ledger.note_wave()["qerror"])
        sref.ledger.note_wave()
        if w == 0:
            fitted, jfit = eng.recalibrate(), ref.recalibrate()
            assert {"ssd", "dram", "hbm"} <= set(fitted) and set(fitted) == set(jfit)
            for k in fitted:
                _assert_models_equal(fitted[k], jfit[k])
            assert eng.cost is fitted["ssd"]
        _assert_ledgers_equal(eng.ledger, ref.ledger)
        _assert_ledgers_equal(static.ledger, sref.ledger)
    assert series[0] >= 4.0
    for a, b in zip(series, series[1:]):
        assert b <= a * 1.05 + 1e-9
    assert series[-1] < 1.5 and eng.ledger.max_qerror() >= 4.0
    assert series_s[-1] >= 4.0


def test_recalibration_resets_corrections_no_transient():
    jstore, pstore = _stores(2)
    ref, eng = _mispreset_engines(jstore, pstore)
    _both_waves(ref, eng, QUERY_POOL)
    assert eng.ledger.correction("ssd") > 1.0
    assert eng.ledger.note_wave()["qerror"] >= 4.0
    ref.ledger.note_wave()
    eng.recalibrate()
    ref.recalibrate()
    assert eng.ledger.corrections() == {} == ref.ledger.corrections()
    _both_waves(ref, eng, QUERY_POOL[::-1])
    assert eng.ledger.note_wave()["qerror"] < 1.5
    ref.ledger.note_wave()
    _assert_ledgers_equal(eng.ledger, ref.ledger)


def test_arbitration_flips_toward_truth_model():
    table = make_clustered_table(num_records=40_000, num_dims=8, density=0.1, seed=0,
                                 mean_cluster=128)
    jstore, pstore = _build(table.dims, table.measures, np.asarray(table.cards), 256)
    hdd, ssd = jax_cost("hdd"), jax_cost("ssd")
    pre = NeedleTailEngine(pstore, conv(ssd), cache_bytes=0, device="cpu")
    post = NeedleTailEngine(pstore, conv(ssd), cache_bytes=0, device="cpu",
                            timing_backend=SyntheticTimingBackend({"ssd": conv(hdd)}))
    jpost = JaxEngine(jstore, ssd, cache_bytes=0, timing_backend=JaxSynthetic({"ssd": hdd}))
    post.recalibrate()
    jpost.recalibrate()
    _assert_models_equal(post.cost, jpost.cost)
    tru = NeedleTailEngine(pstore, conv(hdd), cache_bytes=0, device="cpu")
    flips = agree = 0
    for preds in ([(0, 1)], [(2, 1), (3, 1)], [(4, 1), (5, 1)], [(6, 1), (7, 1)]):
        for k in (64, 128, 256, 512):
            _, u_pre = pre.plan(preds, k)
            b_post, u_post = post.plan(preds, k)
            jb, ju = jpost.plan(preds, k)
            assert u_post == ju
            np.testing.assert_array_equal(b_post, jb)
            _, u_tru = tru.plan(preds, k)
            if u_pre != u_post:
                flips += 1
                agree += int(u_post == u_tru)
    assert flips >= 1 and agree == flips


def test_placement_flips_off_measured_slow_tier():
    jstore, pstore = _stores(3)
    ref, eng = _mispreset_engines(jstore, pstore)
    _both_waves(ref, eng, QUERY_POOL)
    assert eng.block_cache.tier_counters()["hbm.admissions"] > 0
    eng.recalibrate()
    ref.recalibrate()
    c0 = eng.block_cache.tier_counters()
    union = sorted(int(b) for b in _both_waves(ref, eng, QUERY_POOL).unique_blocks_fetched)
    eng.block_cache.invalidate(union)
    ref.block_cache.invalidate(union)
    _both_waves(ref, eng, QUERY_POOL)
    c1 = eng.block_cache.tier_counters()
    assert c1["hbm.admissions"] - c0["hbm.admissions"] == 0
    assert c1["dram.admissions"] - c0["dram.admissions"] >= len(union)


def test_corrections_never_flip_flat_argmin():
    jstore, pstore = _stores(4)
    ref, eng = _mispreset_engines(jstore, pstore)
    _both_waves(ref, eng, QUERY_POOL)
    assert eng.ledger.correction("ssd") > 1.0
    bare = NeedleTailEngine(pstore, eng.cost, cache_bytes=0, device="cpu")
    for preds, k, _ in QUERY_POOL:
        b_eng, u_eng = eng.plan(preds, k)
        b_ref, u_ref = bare.plan(preds, k)
        jb, ju = ref.plan(preds, k)
        assert u_eng == u_ref == ju
        np.testing.assert_array_equal(b_eng, b_ref)
        np.testing.assert_array_equal(b_eng, jb)
    _assert_ledgers_equal(eng.ledger, ref.ledger)


# ---------------------------------------------------------------------------
# Tail compaction.
# ---------------------------------------------------------------------------
def _assert_stores_equal(mine, ref):
    assert (mine.num_records, mine.num_blocks) == (ref.num_records, ref.num_blocks)
    for m, r in ((mine.dims, ref.dims), (mine.measures, ref.measures),
                 (mine.valid_rows, ref.valid_rows),
                 (mine.index.densities, ref.index.densities),
                 (mine.index.sorted_block_ids, ref.index.sorted_block_ids),
                 (mine.index.sorted_densities, ref.index.sorted_densities)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))
        assert m.numpy().dtype == np.asarray(r).dtype


def _tail(rng, n):
    return rng.integers(0, 3, (n, 4)).astype(np.int32), rng.normal(size=(n, 2)).astype(np.float32)


def test_compact_tail_sorts_rows_and_notifies_listeners():
    jstore, pstore = _build(*_table(5, n=1_000))
    td, tm = _tail(np.random.default_rng(9), 3 * RPB)
    cards = np.asarray([3, 3, 3, 3])
    jgrown = jax_append(jstore, JaxTable(td, tm, cards))
    grown = append_records(pstore, Table(td, tm, cards))
    _assert_stores_equal(grown, jgrown)
    tail_start = pstore.num_blocks - 1
    heard: list = []
    listener = type("L", (), {})()
    listener.invalidate = lambda ids: heard.append(np.asarray(ids))
    grown.register_invalidation_listener(listener.invalidate)
    fresh = compact_tail(grown, tail_start)
    _assert_stores_equal(fresh, jax_compact_tail(jgrown, tail_start))
    assert len(heard) == 1
    np.testing.assert_array_equal(heard[0], np.arange(tail_start, grown.num_blocks))
    lo = tail_start * RPB
    old = grown.dims.reshape(-1, 4)[:grown.num_records].numpy()
    new = fresh.dims.reshape(-1, 4)[:fresh.num_records].numpy()
    np.testing.assert_array_equal(new[:lo], old[:lo])
    np.testing.assert_array_equal(new[lo:], old[lo:][np.lexsort(old[lo:].T[::-1])])
    with pytest.raises(ValueError):
        compact_tail(fresh, fresh.num_blocks)


def test_tail_compactor_drives_engine_and_warm_wave_reads_zero():
    jstore, pstore = _build(*_table(6, n=2_000))
    ref, eng = _mispreset_engines(jstore, pstore)
    eng.recalibrate()
    ref.recalibrate()
    tc, jtc = TailCompactor(eng), JaxCompactor(ref)
    assert tc.pending_blocks() == 0 and tc.compact() == 0
    td, tm = _tail(np.random.default_rng(11), 2 * RPB)
    eng.append(Table(td, tm, np.asarray([3, 3, 3, 3])))
    ref.append(JaxTable(td, tm, np.asarray([3, 3, 3, 3])))
    pend = tc.pending_blocks()
    assert pend >= 2 and pend == jtc.pending_blocks()
    assert tc.compact() == pend == jtc.compact() and tc.compactions == 1
    assert tc.pending_blocks() == 0
    _assert_stores_equal(eng.store, ref.store)
    _both_waves(ref, eng, QUERY_POOL)
    assert _both_waves(ref, eng, QUERY_POOL).store_blocks_fetched == 0


def test_compactor_survives_store_swaps():
    jstore, pstore = _build(*_table(7, n=1_000))
    eng = NeedleTailEngine(pstore, make_cost_model("ssd"), device="cpu")
    ref = JaxEngine(jstore, jax_cost("ssd"))
    tc, jtc = TailCompactor(eng), JaxCompactor(ref)
    rng = np.random.default_rng(13)
    cards = np.asarray([3, 3, 3, 3])
    for _ in range(2):
        td, tm = _tail(rng, RPB)
        eng.append(Table(td, tm, cards))
        ref.append(JaxTable(td, tm, cards))
        assert tc.pending_blocks() >= 1 and tc.pending_blocks() == jtc.pending_blocks()
        assert tc.compact() == jtc.compact() >= 1
    assert tc.compactions == 2
    _assert_stores_equal(eng.store, ref.store)


# ---------------------------------------------------------------------------
# Property: both packages equal the per-version oracle under ANY schedule of
# waves, recalibrations, appends, and compactions.
# ---------------------------------------------------------------------------
@settings(max_examples=8, deadline=None)
@given(
    st.integers(0, 2),
    st.lists(st.sampled_from(("wave", "recalibrate", "append", "compact")),
             min_size=2, max_size=7),
)
def test_oracle_identity_under_calibration_compaction_schedules(seed, schedule):
    jstore, pstore = _build(*_table(20 + seed, n=2_000))
    ref, eng = _mispreset_engines(jstore, pstore)
    tc, jtc = TailCompactor(eng), JaxCompactor(ref)
    rng = np.random.default_rng(seed)
    cards = np.asarray([3, 3, 3, 3])
    for i, op in enumerate(schedule):
        if op == "wave":
            off = int(rng.integers(0, len(QUERY_POOL)))
            _both_waves(ref, eng, QUERY_POOL[off:] + QUERY_POOL[:off])
            eng.ledger.note_wave()
            ref.ledger.note_wave()
        elif op == "recalibrate":
            fitted, jfit = eng.recalibrate(), ref.recalibrate()
            for k in fitted:
                _assert_models_equal(fitted[k], jfit[k])
        elif op == "append":
            td, tm = _tail(rng, RPB + i)
            eng.append(Table(td, tm, cards))
            ref.append(JaxTable(td, tm, cards))
        elif op == "compact" and tc.pending_blocks():
            assert tc.compact() == jtc.compact() > 0
        _assert_stores_equal(eng.store, ref.store)
    _both_waves(ref, eng, QUERY_POOL)
    assert 1.0 <= eng.ledger.qerror() < math.inf
    _assert_ledgers_equal(eng.ledger, ref.ledger)


# ---------------------------------------------------------------------------
# Append on the store's device.
# ---------------------------------------------------------------------------
def test_append_records_matches_full_rebuild():
    """After ``tests/test_extensions.py::test_append_records_matches_full_rebuild``:
    the grown store equals a full rebuild of the concatenated table bit for
    bit (index included), and the reference's append."""
    def table(n, seed):
        r = np.random.default_rng(seed)
        return (r.integers(0, 3, (n, 2)).astype(np.int32),
                r.normal(size=(n, 1)).astype(np.float32), np.asarray([3, 3]))

    (bd, bm, cards), (xd, xm, _) = table(1000, 1), table(777, 2)
    jstore, pstore = _build(bd, bm, cards)
    grown = append_records(pstore, Table(xd, xm, cards))
    full = build_block_store(Table(np.concatenate([bd, xd]), np.concatenate([bm, xm]), cards),
                             64, device="cpu")
    for a, b in ((grown.dims, full.dims), (grown.measures, full.measures),
                 (grown.valid_rows, full.valid_rows), (grown.index.densities,
                                                       full.index.densities),
                 (grown.index.sorted_block_ids, full.index.sorted_block_ids),
                 (grown.index.sorted_densities, full.index.sorted_densities)):
        assert torch.equal(a, b)
    assert grown.num_records == 1777
    _assert_stores_equal(grown, jax_append(jstore, JaxTable(xd, xm, cards)))
    r = NeedleTailEngine(grown, device="cpu").any_k([(0, 1)], k=100, algo="threshold")
    assert np.all(grown.dims.numpy()[r.record_block, r.record_row, 0] == 1)


@settings(max_examples=8, deadline=None)
@given(
    st.sampled_from(("clustered", "uniform", "skewed")),
    st.integers(0, 2),
    st.integers(1, 400),
    st.lists(st.sampled_from(QUERY_POOL), min_size=1, max_size=4),
)
def test_append_invalidation_equivalence(kind, seed, n_extra, spec):
    """After ``tests/test_block_cache.py::test_append_invalidation_equivalence``
    (the flat cache): append evicts only the dirtied tail, and the grown
    engine equals a fresh one and the reference's."""
    def table(s):
        if kind == "clustered":
            t = make_clustered_table(num_records=6_000, num_dims=4, density=0.15, seed=s,
                                     mean_cluster=48)
            return t.dims, t.measures, np.asarray(t.cards)
        if kind == "uniform":
            return _table(s)
        rng = np.random.default_rng(s)
        dims = np.zeros((6_000, 4), np.int32)
        dims[:600, 0] = 1
        dims[:, 1] = rng.integers(0, 2, 6_000)
        dims[:, 2] = (np.arange(6_000) // RPB) % 3
        dims[:, 3] = rng.integers(0, 3, 6_000)
        return dims, rng.normal(size=(6_000, 2)).astype(np.float32), np.asarray([2, 2, 3, 3])

    dims, meas, cards = table(seed)
    xd, xm, _ = table(seed + 100)
    jstore, pstore = _build(dims, meas, cards)
    ref, eng = JaxEngine(jstore), NeedleTailEngine(pstore, device="cpu")
    jq, pq = _queries(spec)
    eng.any_k_batch(pq, algo="auto")
    ref.any_k_batch(jq, algo="auto")
    first_touched = pstore.num_records // RPB
    clean = {b for b in range(pstore.num_blocks) if b in eng.block_cache and b < first_touched}
    grown = eng.append(Table(xd[:n_extra], xm[:n_extra], cards))
    jgrown = ref.append(JaxTable(xd[:n_extra], xm[:n_extra], cards))
    _assert_stores_equal(grown, jgrown)
    for b in range(first_touched, grown.num_blocks):
        assert b not in eng.block_cache
    assert all(b in eng.block_cache for b in clean)
    fresh = NeedleTailEngine(grown, cache_bytes=0, device="cpu")
    for algo in ("threshold", "auto"):
        mine = eng.any_k_batch(pq, algo=algo)
        theirs = ref.any_k_batch(jq, algo=algo)
        for a, b, c in zip(mine.results, theirs.results, fresh.any_k_batch(pq, algo=algo).results):
            _assert_result_equal(a, b)
            _assert_result_equal(a, c)
        assert (mine.store_blocks_fetched, mine.cache_hits) == \
            (theirs.store_blocks_fetched, theirs.cache_hits)


def test_fold_identity_survives_append_mid_stream():
    """After ``tests/test_online_agg.py::test_fold_identity_survives_append_mid_stream``:
    an append between rounds dirties the trailing block; the aggregator
    reads and folds it again, so the final fold equals the offline
    estimator on the current bytes, and the reference's stream."""
    from repro.core.online_agg import AggregateQuery as JaxAggQuery
    from repro.core.online_agg import OnlineAggregator as JaxAggregator
    from repro_torch.core import estimators as est
    from repro_torch.core.engine import block_partials
    from repro_torch.core.online_agg import AggregateQuery, OnlineAggregator

    t = make_clustered_table(12_000, num_dims=4, density=0.15, seed=5, correlated_measure=True)
    jstore, pstore = _build(t.dims, t.measures, np.asarray(t.cards))
    ref, eng = JaxEngine(jstore), NeedleTailEngine(pstore, device="cpu")
    kw = dict(predicates=((0, 1),), measure=0, k=300, alpha=0.4, estimator="ratio", seed=3)
    agg = OnlineAggregator(eng, AggregateQuery(**kw), chunk_blocks=8)
    jagg = JaxAggregator(ref, JaxAggQuery(**kw), chunk_blocks=8)
    for a in (agg, jagg):
        for _ in range(2):
            a.next_blocks()
            a.fold()
    rng = np.random.default_rng(99)
    nd = np.column_stack([rng.integers(0, c, size=50).astype(np.int32) for c in t.cards])
    nm = rng.normal(200.0, 5.0, size=(50, t.measures.shape[1])).astype(np.float32)
    eng.append(Table(nd, nm, np.asarray(t.cards)))
    ref.append(JaxTable(nd, nm, t.cards))
    assert agg._dirty and agg._dirty == jagg._dirty
    for a in (agg, jagg):
        while not a.exhausted:
            a.next_blocks()
            a.fold()
    assert not (agg._dirty & set(agg._tau))
    assert all(b >= agg.num_valid_blocks for b in agg._dirty)
    plan = agg.design_snapshot()
    blocks = np.sort(plan.blocks)
    bd, bm, bv = eng.block_cache.get_many(eng.store, blocks)
    tau, n = block_partials(eng._mask(bd, kw["predicates"], "and") & bv, bm[..., 0])
    in_sc = np.isin(blocks, plan.sc)
    offline = est.ratio_estimator(tau[in_sc], tau[~in_sc], n[in_sc], n[~in_sc], plan,
                                  agg.population_size)
    final, jfinal = agg.estimates[-1], jagg.estimates[-1]
    assert (final.total, final.mean, final.var_total, final.var_mean) == \
        (offline.total, offline.mean, offline.var_total, offline.var_mean)
    assert (final.total, final.mean, final.var_total, final.var_mean) == \
        (jfinal.total, jfinal.mean, jfinal.var_total, jfinal.var_mean)
    assert plan.pi_r == 1.0
    agg.close()
    jagg.close()


# ---------------------------------------------------------------------------
# StoreTimingBackend: a counting clock, and the card synchronised in the window.
# ---------------------------------------------------------------------------
class _CountingClock:
    def __init__(self, events: list):
        self.events, self.t = events, 0.0

    def __call__(self) -> float:
        self.events.append("clock")
        self.t += 1.0
        return self.t


def test_store_timing_backend_counts_reads_with_an_injected_clock():
    _, pstore = _stores(0)
    events: list = []
    be = StoreTimingBackend(pstore, levels={"ssd"}, clock=_CountingClock(events), repeats=3)
    assert be.max_block_id == pstore.num_blocks - 1
    assert be.io_seconds("ssd", [0, 5, 10**9]) == 1.0  # ids clipped into range
    assert events == ["clock"] * 6 and be.calls == 1
    with pytest.raises(KeyError):
        be.io_seconds("dram", [0])
    assert measurable(be, "ssd") and not measurable(be, "dram")
    eng = NeedleTailEngine(pstore, make_cost_model("ssd"), calibrated_cost=True, device="cpu")
    assert isinstance(eng.timing_backend, StoreTimingBackend) and eng.cost.name == "ssd"


def test_store_timing_backend_synchronises_a_card_store(monkeypatch):
    """Each clock read is preceded by a synchronise of the store's card, so
    the window holds the read, not its launch (a fake card store here; the
    ``cuda`` case below runs a real one)."""
    events: list = []
    store = type("CardStore", (), {})()
    store.device, store.num_blocks = torch.device("cuda", 0), 8
    store.fetch = lambda ids: events.append("fetch")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: events.append("sync"))
    be = StoreTimingBackend(store, clock=_CountingClock(events), repeats=2)
    be.io_seconds("hdd", [1, 2])
    assert events == ["sync", "clock", "fetch", "sync", "clock"] * 2


@pytest.mark.cuda
def test_store_timing_backend_times_a_card_store(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dims, meas, cards = _table(0)
    store = build_block_store(Table(dims, meas, cards), RPB, device="cuda")
    calls: list = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: (calls.append(dev), sync(dev)))
    be = StoreTimingBackend(store, repeats=3)
    assert be.io_seconds("hdd", np.arange(40)) > 0.0
    assert len(calls) == 6 and all(torch.device(d) == store.device for d in calls)


# ---------------------------------------------------------------------------
# The prefetcher, driven without the serving engine.
# ---------------------------------------------------------------------------
def _prefetch_fixture(hbm_bytes=None, dram_bytes=None, n_blocks=8, tail_short=0, seed=5):
    """(reference, port) engines over a two-attribute table whose round-0
    plan spans every block, memoized by one host-mirror wave; tiers cleared
    so the prefetcher has the whole union to warm."""
    rng = np.random.default_rng(seed)
    n = n_blocks * RPB - tail_short
    dims = np.stack([np.ones(n, np.int32), rng.integers(0, 2, n).astype(np.int32)], axis=1)
    meas = rng.normal(size=(n, 1)).astype(np.float32)
    jstore, pstore = _build(dims, meas, np.asarray([2, 2]))
    jstack = jax_make_tier_stack(hbm_bytes, dram_bytes)
    pstack = TierStack([Tier(t.name, t.capacity_bytes, conv(t.cost), device=t.device)
                        for t in jstack.tiers], backing=conv(jstack.backing), device="cpu")
    ref = JaxEngine(jstore, tiers=jstack)
    eng = NeedleTailEngine(pstore, tiers=pstack, device="cpu")
    jq, pq = _queries([([(0, 1)], n, "and")])
    ref.any_k_batch(jq, algo="auto")
    eng.any_k_batch(pq, algo="auto", device=False)  # the host mirror fills the memo
    jstack.clear()
    pstack.clear()
    return ref, eng, jq, pq


def test_prefetch_kick_drain_observe_counters_equal_reference():
    ref, eng, jq, pq = _prefetch_fixture()
    jpf, pf = JaxPrefetcher(ref), TierPrefetcher(eng)
    assert pf.kick(pq) == jpf.kick(jq) > 0
    assert pf.prefetched == jpf.prefetched
    assert pf.drain() == jpf.drain() == 0  # the sync mode has nothing in flight
    _assert_stacks_equal(eng.block_cache, ref.block_cache)
    batch = eng.any_k_batch(pq, algo="auto")
    jbatch = ref.any_k_batch(jq, algo="auto")
    assert batch.store_blocks_fetched == jbatch.store_blocks_fetched == 0
    assert pf.observe_wave(batch.unique_blocks_fetched) == \
        jpf.observe_wave(jbatch.unique_blocks_fetched)
    assert pf.kick(pq) == jpf.kick(jq) == 0  # all warm
    assert pf.stats.snapshot() == jpf.stats.snapshot()
    _assert_stacks_equal(eng.block_cache, ref.block_cache)


def test_prefetched_blocks_invalidated_by_append_like_residents():
    """After ``tests/test_serving_loop.py:188``."""
    ref, eng, jq, pq = _prefetch_fixture(n_blocks=6, tail_short=10, seed=3)
    jpf, pf = JaxPrefetcher(ref), TierPrefetcher(eng)
    pf.kick(pq)
    jpf.kick(jq)
    stack = eng.block_cache
    tail = eng.store.num_blocks - 1
    assert tail in pf.prefetched and 0 in pf.prefetched
    assert int(stack.residency_tier(np.asarray([tail]))[0]) < len(stack.tiers)
    rng = np.random.default_rng(3)
    xd, xm = np.ones((RPB, 2), np.int32), rng.normal(size=(RPB, 1)).astype(np.float32)
    eng.append(Table(xd, xm, np.asarray([2, 2])))
    ref.append(JaxTable(xd, xm, np.asarray([2, 2])))
    assert tail not in pf.prefetched and pf.stats.invalidated >= 1
    assert 0 in pf.prefetched
    assert int(stack.residency_tier(np.asarray([tail]))[0]) == len(stack.tiers)
    assert int(stack.residency_tier(np.asarray([0]))[0]) < len(stack.tiers)
    assert pf.prefetched == jpf.prefetched
    assert pf.stats.snapshot() == jpf.stats.snapshot()
    _assert_stacks_equal(stack, ref.block_cache)


def test_prefetch_kick_truncates_after_sorting():
    """After ``tests/test_serving_loop.py:251``."""
    ref, eng, jq, pq = _prefetch_fixture()
    union, _ = predicted_wave_blocks(eng, pq, {})
    np.testing.assert_array_equal(union, jax_predicted(ref, jq, {})[0])
    assert union.size > 3
    jpf, pf = JaxPrefetcher(ref, max_blocks=3), TierPrefetcher(eng, max_blocks=3)
    assert pf.kick(pq) == jpf.kick(jq) == 3
    assert pf.stats.truncated == int(union.size) - 3
    assert pf.prefetched == set(sorted(int(b) for b in union)[:3]) == jpf.prefetched
    assert pf.stats.snapshot() == jpf.stats.snapshot()


@pytest.mark.parametrize("budget", [8, None])
def test_async_drain_credits_only_admitted_blocks(budget):
    """After ``tests/test_serving_loop.py``'s async case: ``fetched`` counts
    what the cache reports admitted; budgets under one slab admit nothing.
    On the CPU the asynchronous read runs at once; its admissions equal the
    synchronous mode's."""
    ref, eng, jq, pq = _prefetch_fixture(hbm_bytes=budget, dram_bytes=budget)
    jpf, pf = JaxPrefetcher(ref, async_fetch=True), TierPrefetcher(eng, async_fetch=True)
    issued = pf.kick(pq)
    assert issued == jpf.kick(jq) > 0
    moved = pf.drain(wait=True)
    assert moved == jpf.drain(wait=True)
    assert moved == (0 if budget else issued) == pf.stats.fetched
    _assert_stacks_equal(eng.block_cache, ref.block_cache)
    _, sync_eng, _, _ = _prefetch_fixture(hbm_bytes=budget, dram_bytes=budget)
    sync = TierPrefetcher(sync_eng)
    sync.kick(pq)
    assert sync_eng.block_cache.tier_counters() == eng.block_cache.tier_counters()
    assert [list(t.block_ids()) for t in sync_eng.block_cache.tiers] == \
        [list(t.block_ids()) for t in eng.block_cache.tiers]


def test_async_drops_ids_invalidated_in_flight():
    ref, eng, jq, pq = _prefetch_fixture(n_blocks=6, tail_short=10, seed=3)
    pf = TierPrefetcher(eng, async_fetch=True)
    pf.kick(pq)
    tail = eng.store.num_blocks - 1
    eng.store.notify_invalidated([tail])
    assert pf.drain(wait=True) == eng.store.num_blocks - 1
    assert tail not in eng.block_cache and 0 in eng.block_cache
