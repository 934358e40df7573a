"""The port's §5 aggregate path against the JAX package's, on the CPU.

Hybrid sampling (arms and π exact), the HT and ratio estimators (every case
of ``tests/test_estimators.py``, guards included, equal to the reference's
on the same inputs), ``engine.aggregate`` (blocks and records exact), the
online fold (its last estimate ``==`` the port's own offline estimator on
the same fetched set), the CI coverage over 220 seeded designs, group-by
(blocks, counts and records exact) and the answer-now arbitration priced by
the flat-LRU ``effective_block_cost``.  The per-block sums ``τ_i`` add in
numpy's order (``engine._np_sum``), so every estimate equals the
reference's exactly, which is stricter than the port's contract
(``rtol=1e-5``): the estimators' variance terms are f32 sums whose
cancellation turns one ulp of a ``τ_i`` into ~1e-5 of a variance.
The fold, CI, group-by and arbitration cases mirror those of
``tests/test_online_agg.py``; its append, tier and ``ServeEngine`` cases
wait for the port's tiered-storage and serving slices.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import estimators as jest
from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.groupby import groupby_any_k as jax_groupby
from repro.core.groupby import join_any_k as jax_join
from repro.core.hybrid import HybridPlan as JaxPlan
from repro.core.hybrid import plan_hybrid as jax_plan_hybrid
from repro.core.online_agg import AggregateQuery as JaxAggQuery
from repro.core.online_agg import run_online_aggregate as jax_run_online
from repro.data import synthetic as jsyn
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro.serving.admission import arbitrate_aggregate as jax_arbitrate
from repro.storage.prefetch import effective_block_cost as jax_block_cost
from repro_torch.core import estimators as est
from repro_torch.core import predicates as tp
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.groupby import groupby_any_k, join_any_k
from repro_torch.core.hybrid import HybridPlan, plan_hybrid
from repro_torch.core.online_agg import AggregateQuery, OnlineAggregator, run_online_aggregate
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.serving.admission import arbitrate_aggregate
from repro_torch.storage.prefetch import effective_block_cost

RPB = 64
LAYOUTS = ("clustered", "uniform", "skewed")
PREDSETS = ((((0, 1),), "and"), (((0, 1), (1, 1)), "and"), (((0, 1), (2, 1)), "or"))
_CACHE: dict = {}


def _layout_table(layout: str):
    """The tables of ``tests/test_online_agg.py`` (12,000 records, λ = 188)."""
    if layout == "clustered":
        return jsyn.make_clustered_table(12_000, num_dims=4, density=0.15, seed=5,
                                         correlated_measure=True)
    if layout == "skewed":
        return jsyn.make_clustered_table(12_000, num_dims=4, density=0.3, seed=7,
                                         mean_cluster=16, correlated_measure=True)
    t = _layout_table("clustered")
    perm = np.random.default_rng(11).permutation(t.dims.shape[0])
    return JaxTable(dims=t.dims[perm], measures=t.measures[perm], cards=t.cards)


def _stores(layout: str, rpb: int = RPB):
    """(table, reference store, port store) of one layout."""
    key = (layout, rpb)
    if key not in _CACHE:
        if layout == "workload":  # tests/test_estimators.py's, λ = 300
            t = jsyn.make_clustered_table(num_records=60_000, num_dims=4, density=0.15,
                                          seed=5, correlated_measure=True)
        else:
            t = _layout_table(layout)
        _CACHE[key] = (t, jax_build_block_store(JaxTable(t.dims, t.measures, t.cards), rpb),
                       build_block_store(Table(t.dims, t.measures, np.asarray(t.cards)), rpb,
                                         device="cpu"))
    return _CACHE[key]


def _engines(layout: str, rpb: int = RPB):
    t, jstore, pstore = _stores(layout, rpb)
    return t, JaxEngine(jstore), NeedleTailEngine(pstore, device="cpu")


def _assert_identical(a, b):
    assert (a.total, a.mean, a.var_total, a.var_mean, a.num_samples) == \
        (b.total, b.mean, b.var_total, b.var_mean, b.num_samples)


def _assert_plans_equal(mine, ref):
    np.testing.assert_array_equal(mine.sc, ref.sc)
    np.testing.assert_array_equal(mine.sr, ref.sr)
    assert (mine.num_valid_blocks, mine.pi_r) == (ref.num_valid_blocks, ref.pi_r)


# ------------------------------------------------------------------ hybrid


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.9])
@pytest.mark.parametrize("preds", [[(0, 1)], [(0, 1), (1, 1)]])
def test_hybrid_plan_equals_reference(preds, alpha):
    _, jeng, peng = _engines("workload", 200)
    combined = peng.combined_density(preds)
    anyk, _ = peng.plan(preds, 500, algo="threshold")
    ref_anyk, _ = jeng.plan(preds, 500, algo="threshold")
    np.testing.assert_array_equal(anyk, ref_anyk)
    for seed in range(3):
        mine = plan_hybrid(anyk, combined, 500, alpha, 200, np.random.default_rng(seed))
        ref = jax_plan_hybrid(ref_anyk, jeng.combined_density(preds), 500, alpha, 200,
                              np.random.default_rng(seed))
        _assert_plans_equal(mine, ref)
        blocks = mine.blocks
        np.testing.assert_array_equal(blocks, ref.blocks)
        np.testing.assert_array_equal(mine.pi(blocks), ref.pi(blocks))
        i_sc, j_sc = np.isin(blocks, mine.sc), np.isin(blocks[::-1], mine.sc)
        np.testing.assert_array_equal(mine.pi_joint(i_sc, j_sc), ref.pi_joint(i_sc, j_sc))


@pytest.mark.parametrize("shape", [(5, 3), (4, 8), (7, 64), (6, 200), (9, 128), (2, 129),
                                   (5, 8192), (2, 3, 8192), (3, 8193), (2, 20_000), (3, 0)])
def test_block_partials_sum_in_numpys_order(shape):
    """τ_i is numpy's ``np.sum(np.where(mask, vals, 0.0), axis=1)`` bit for
    bit: pairwise below 128, halves at multiples of 8, chunks of 8192."""
    from repro_torch.core.engine import block_partials

    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    vals = (rng.normal(size=shape) * 50).astype(np.float32)
    mask = rng.random(shape) < 0.4
    tau, n = block_partials(torch.from_numpy(mask), torch.from_numpy(vals))
    np.testing.assert_array_equal(tau, np.sum(np.where(mask, vals, 0.0), axis=-1))
    np.testing.assert_array_equal(n, np.sum(mask, axis=-1).astype(np.float64))
    assert tau.dtype == np.float32 and n.dtype == np.float64


def test_estimated_valid_records_close_to_reference():
    """L from the combined map: the card's sum in its own order (rtol)."""
    from repro.core.density_map import estimated_valid_records as jax_evr
    from repro_torch.core.density_map import estimated_valid_records

    _, jeng, peng = _engines("workload", 200)
    for preds, op in PREDSETS:
        mine = estimated_valid_records(peng.store.index, peng.combined_density(preds, op))
        ref = jax_evr(jeng.store.index, jeng.combined_density(preds, op))
        assert float(mine) == pytest.approx(float(ref), rel=1e-5)


def test_inclusion_probabilities():
    _, _, eng = _engines("workload", 200)
    preds = [(0, 1)]
    anyk, _ = eng.plan(preds, 500, algo="threshold")
    plan = plan_hybrid(anyk, eng.combined_density(preds), 500, alpha=0.3,
                       records_per_block=200, rng=np.random.default_rng(0))
    assert np.all(plan.pi(plan.sc) == 1.0)
    assert len(plan.sr) and np.all(plan.pi(plan.sr) == plan.pi_r) and 0 < plan.pi_r <= 1.0
    assert not set(plan.sc) & set(plan.sr)  # S_c ∩ S_r = ∅


# -------------------------------------------------------------- estimators


def _plans(sc, sr, num_valid, pi_r):
    kw = dict(sc=np.asarray(sc, np.int64), sr=np.asarray(sr, np.int64),
              num_valid_blocks=num_valid, pi_r=pi_r)
    return HybridPlan(**kw), JaxPlan(**kw)


E = np.asarray([], np.float64)
ESTIMATOR_CASES = {  # tests/test_estimators.py's hand example and guards
    "hand": ((np.asarray([10.0, 20.0, 30.0]), E, np.asarray([1.0, 2.0, 3.0]), E),
             ([0, 1, 2], [], 3, 0.0), 6.0),
    "zero_valid_rows": ((E, np.asarray([0.0, 0.0]), E, np.asarray([0.0, 0.0])),
                        ([], [3, 7], 10, 0.2), 100.0),
    "single_sampled_block": ((E, np.asarray([12.0]), E, np.asarray([4.0])),
                             ([], [2], 8, 1.0 / 8.0), 64.0),
    "pi_r_zero": ((E, np.asarray([10.0, 14.0]), E, np.asarray([2.0, 2.0])),
                  ([], [1, 5], 10, 0.0), 100.0),
    "nonpositive_population": ((E, np.asarray([5.0]), E, np.asarray([1.0])),
                               ([], [0], 4, 0.25), 0.0),
    "f32_partials": ((np.asarray([3.5, 1.25], np.float32), np.asarray([2.0, 7.5, 0.5], np.float32),
                      np.asarray([2.0, 1.0]), np.asarray([1.0, 3.0, 1.0])),
                     ([4, 9], [1, 2, 6], 12, 0.3), 40.0),
}


@pytest.mark.parametrize("fn", ["horvitz_thompson", "ratio_estimator"])
@pytest.mark.parametrize("case", sorted(ESTIMATOR_CASES))
def test_estimators_equal_reference(case, fn):
    stats, plan_args, pop = ESTIMATOR_CASES[case]
    mine_plan, ref_plan = _plans(*plan_args)
    mine = getattr(est, fn)(*stats, mine_plan, pop)
    ref = getattr(jest, fn)(*stats, ref_plan, pop)
    _assert_identical(mine, ref)
    assert mine.se_mean == ref.se_mean and mine.ci_halfwidth() == ref.ci_halfwidth()
    assert est.Z95 == jest.Z95


def test_estimator_math_hand_example():
    """HT with π = 1 for all blocks is exact."""
    (tau, _, n, _), plan_args, pop = ESTIMATOR_CASES["hand"]
    plan, _ = _plans(*plan_args)
    e = est.horvitz_thompson(tau, E, n, E, plan, pop)
    assert (e.total, e.mean, e.var_total) == pytest.approx((60.0, 10.0, 0.0))
    r = est.ratio_estimator(tau, E, n, E, plan, pop)
    assert (r.mean, r.total) == pytest.approx((10.0, 60.0))


def test_guards():
    """The guards of tests/test_estimators.py: defined results, no blow-up."""
    stats, plan_args, pop = ESTIMATOR_CASES["zero_valid_rows"]
    plan, _ = _plans(*plan_args)
    r = est.ratio_estimator(*stats, plan, pop)
    assert r.mean == 0.0 and r.total == 0.0 and r.var_mean == 0.0 and r.num_samples == 0
    h = est.horvitz_thompson(*stats, plan, pop)
    assert h.total == 0.0 and h.mean == 0.0 and np.isfinite(h.var_total)
    stats, plan_args, pop = ESTIMATOR_CASES["single_sampled_block"]
    plan, _ = _plans(*plan_args)
    assert est.horvitz_thompson(*stats, plan, pop).total == pytest.approx(96.0)
    assert est.ratio_estimator(*stats, plan, pop).mean == pytest.approx(3.0)
    stats, plan_args, pop = ESTIMATOR_CASES["pi_r_zero"]
    plan, _ = _plans(*plan_args)
    assert est.horvitz_thompson(*stats, plan, pop).total == pytest.approx(24.0 * 5.0)
    stats, plan_args, pop = ESTIMATOR_CASES["nonpositive_population"]
    plan, _ = _plans(*plan_args)
    h = est.horvitz_thompson(*stats, plan, pop)
    assert h.mean == 0.0 and h.var_mean == 0.0 and h.total == pytest.approx(20.0)
    r = est.ratio_estimator(*stats, plan, pop)
    assert r.total == 0.0 and r.var_mean == 0.0 and r.mean == pytest.approx(5.0)


# --------------------------------------------------------------- aggregate


@pytest.mark.parametrize("estimator", ["ht", "ratio"])
@pytest.mark.parametrize("algo", ["threshold", "two_prong", "auto"])
@pytest.mark.parametrize("preds,op", [([(0, 1)], "and"), ([(0, 1), (1, 1)], "and"),
                                      ([(0, 1), (2, 1)], "or")])
def test_aggregate_equals_reference(preds, op, algo, estimator):
    _, jeng, peng = _engines("workload", 200)
    for seed in (0, 3):
        e, qr, plan = peng.aggregate(preds, 0, k=800, alpha=0.3, op=op,
                                     estimator=estimator, algo=algo, seed=seed)
        re, rqr, rplan = jeng.aggregate(preds, 0, k=800, alpha=0.3, op=op,
                                        estimator=estimator, algo=algo, seed=seed)
        _assert_plans_equal(plan, rplan)
        _assert_identical(e, re)
        for f in ("record_block", "record_row", "measures", "blocks_fetched"):
            np.testing.assert_array_equal(getattr(qr, f), np.asarray(getattr(rqr, f)))
        assert (qr.algo, qr.plan_rounds, qr.modeled_io_s) == \
            (rqr.algo, rqr.plan_rounds, rqr.modeled_io_s)


def test_aggregate_of_a_tree_equals_reference():
    from repro.core import predicates as jp

    _, jeng, peng = _engines("workload", 200)
    mine = tp.And((tp.Eq(0, 1), tp.Not(tp.Eq(1, 0))))
    ref = jp.And((jp.Eq(0, 1), jp.Not(jp.Eq(1, 0))))
    e, qr, _ = peng.aggregate(mine, 1, k=500, alpha=0.2, seed=4)
    re, rqr, _ = jeng.aggregate(ref, 1, k=500, alpha=0.2, seed=4)
    _assert_identical(e, re)
    np.testing.assert_array_equal(qr.blocks_fetched, rqr.blocks_fetched)


def test_ht_estimator_unbiased_over_plans():
    """E[tau_hat] ≈ tau over repeated random S_r draws (HT unbiasedness)."""
    t, _, eng = _engines("workload", 200)
    preds = [(0, 1)]
    true_sum = float(t.measures[t.valid_mask(preds), 0].sum())
    ests = [eng.aggregate(preds, 0, k=800, alpha=0.3, estimator="ht", seed=s)[0].total
            for s in range(40)]
    assert abs(np.mean(ests) - true_sum) / abs(true_sum) < 0.05


def test_ratio_estimator_beats_threshold_only_on_correlated_layout():
    """§5: when density and the measure both drift with layout position,
    densest-first any-k is biased and hybrid ratio estimation removes most
    of the bias."""
    rng = np.random.default_rng(0)
    n = 60_000
    pos = np.arange(n)
    a0 = (rng.random(n) < 0.9 - 0.85 * pos / n).astype(np.int32)
    meas = (100.0 + 60.0 * pos / n - 30.0 + rng.normal(0, 2, n)).astype(np.float32)
    t = Table(dims=a0[:, None], measures=meas[:, None], cards=np.asarray([2]))
    eng = NeedleTailEngine(build_block_store(t, 200, device="cpu"), device="cpu")
    true_mean = float(t.measures[t.valid_mask([(0, 1)]), 0].mean())
    biased, debiased = [], []
    for seed in range(10):
        e0 = eng.aggregate([(0, 1)], 0, k=1500, alpha=0.0, seed=seed)[0]
        e1 = eng.aggregate([(0, 1)], 0, k=1500, alpha=0.3, seed=seed)[0]
        biased.append(abs(e0.mean - true_mean))
        debiased.append(abs(e1.mean - true_mean))
    assert np.mean(debiased) < np.mean(biased) * 0.7


def test_variances_nonnegative_and_shrink_with_alpha():
    _, _, eng = _engines("workload", 200)
    e1 = eng.aggregate([(0, 1)], 0, k=400, alpha=0.1, estimator="ht", seed=1)[0]
    e3 = eng.aggregate([(0, 1)], 0, k=400, alpha=0.5, estimator="ht", seed=1)[0]
    assert e1.var_mean >= 0 and e3.var_mean >= 0 and e1.se_mean >= 0


# ------------------------------------------------------------- online fold


def _offline_estimate(engine, query, plan, population_size):
    """NeedleTailEngine.aggregate's extraction and estimator call, one-shot
    on an explicit design: the oracle the fold must equal bit for bit."""
    from repro_torch.core.engine import block_partials

    blocks = np.sort(plan.blocks)
    bd, bm, bv = engine.block_cache.get_many(engine.store, blocks)
    mask = engine._mask(bd, query.predicates, query.op) & bv
    tau_i, n_i = block_partials(mask, bm[..., query.measure])
    in_sc = np.isin(blocks, plan.sc)
    fn = est.horvitz_thompson if query.estimator == "ht" else est.ratio_estimator
    return fn(tau_i[in_sc], tau_i[~in_sc], n_i[in_sc], n_i[~in_sc], plan, population_size)


@pytest.mark.parametrize("rounds", [1, 3, 6])
@pytest.mark.parametrize("estimator", ["ht", "ratio"])
@pytest.mark.parametrize("predset", range(len(PREDSETS)))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fold_identical_to_offline_and_close_to_reference(layout, predset, estimator, rounds):
    """Stop the stream after any number of rounds: its last Estimate ``==``
    the port's offline estimator on the fetched set, and the stream is the
    reference's within rtol (same design, reason, rounds and blocks)."""
    _, jeng, peng = _engines(layout)
    preds, op = PREDSETS[predset]
    seed = 7 * rounds + predset
    kw = dict(predicates=preds, measure=0, k=300, alpha=0.4, op=op, estimator=estimator,
              seed=seed)
    res = run_online_aggregate(peng, AggregateQuery(**kw), chunk_blocks=8, max_rounds=rounds)
    assert len(res.stream) == res.rounds >= 1
    _assert_identical(res.estimate, _offline_estimate(peng, AggregateQuery(**kw), res.plan,
                                                      res.population_size))
    ref = jax_run_online(jeng, JaxAggQuery(**kw), chunk_blocks=8, max_rounds=rounds)
    _assert_plans_equal(res.plan, ref.plan)
    assert (res.reason, res.rounds, res.blocks_fetched, res.population_size) == \
        (ref.reason, ref.rounds, ref.blocks_fetched, ref.population_size)
    for mine, theirs in zip(res.stream, ref.stream):
        _assert_identical(mine, theirs)
    assert res.plan.pi_r == pytest.approx(
        len(res.plan.sr) / max(res.plan.num_valid_blocks - len(res.plan.sc), 1))


def test_fold_identity_survives_invalidation_mid_stream():
    """Blocks the store reports rewritten between rounds are read and folded
    again; the final fold still equals the offline estimator."""
    _, _, peng = _engines("clustered")
    query = AggregateQuery(predicates=((0, 1),), measure=0, k=300, alpha=0.4, seed=3)
    agg = OnlineAggregator(peng, query, chunk_blocks=8)
    agg.fold()
    agg.fold()
    folded = sorted(agg._tau)[:3]
    peng.store.notify_invalidated(folded + [10_000])  # 10_000: outside the design
    assert set(folded) <= agg._dirty
    assert set(folded) <= set(agg.next_blocks())
    while not agg.exhausted:
        agg.next_blocks()
        agg.fold()
    assert agg._dirty == {10_000}
    plan = agg.design_snapshot()
    _assert_identical(agg.estimates[-1], _offline_estimate(peng, query, plan,
                                                           agg.population_size))
    agg.close()
    assert plan.pi_r == 1.0


def test_ci_coverage_nominal_and_halfwidth_shrinks():
    """220 seeded designs: the 95% CI covers the true mean at close to the
    nominal rate, and the mean half-width shrinks round by round."""
    t, _, eng = _engines("clustered")
    true_mean = float(t.measures[t.dims[:, 0] == 1, 0].mean())
    trials, rounds = 220, 4
    covered = 0
    halfwidths = np.zeros((trials, rounds))
    for s in range(trials):
        query = AggregateQuery(predicates=((0, 1),), measure=0, k=300, alpha=0.5, seed=s)
        res = run_online_aggregate(eng, query, chunk_blocks=8, max_rounds=rounds)
        assert res.rounds == rounds
        covered += abs(res.estimate.mean - true_mean) <= res.estimate.ci_halfwidth()
        halfwidths[s] = [e.ci_halfwidth() for e in res.stream]
    assert 0.90 <= covered / trials <= 0.99
    mean_hw = halfwidths.mean(axis=0)
    assert np.all(np.diff(mean_hw) <= 1e-9) and mean_hw[-1] < 0.6 * mean_hw[0]


def test_error_slo_stops_at_the_ci():
    _, jeng, peng = _engines("clustered")
    kw = dict(predicates=((0, 1),), measure=0, k=300, alpha=0.4, seed=2)
    offline = peng.aggregate([(0, 1)], 0, k=300, alpha=0.4, seed=2)[0]
    slo = 0.05 * abs(offline.mean)
    res = run_online_aggregate(peng, AggregateQuery(**kw), error_slo=slo, chunk_blocks=8)
    ref = jax_run_online(jeng, JaxAggQuery(**kw), error_slo=slo, chunk_blocks=8)
    assert res.reason == ref.reason == "ci" and res.rounds == ref.rounds
    assert res.estimate.ci_halfwidth() <= slo


# ----------------------------------------------------------------- group-by


@pytest.mark.parametrize("measure", [None, 0])
@pytest.mark.parametrize("preds,op,group_attr,k,psi", [
    (((0, 1),), "and", 1, 150, 8), ((), "and", 2, 400, 4), (((0, 1), (3, 1)), "or", 1, 90, 16),
])
def test_groupby_equals_reference(preds, op, group_attr, k, psi, measure):
    _, jeng, peng = _engines("clustered")
    mine = groupby_any_k(peng, preds, group_attr, k, op=op, psi=psi, measure=measure)
    ref = jax_groupby(jeng, preds, group_attr, k, op=op, psi=psi, measure=measure)
    for f in ("per_group_counts", "blocks_fetched", "record_block", "record_row",
              "record_group"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f), err_msg=f)
    assert (mine.rounds, mine.modeled_io_s) == (ref.rounds, ref.modeled_io_s)
    if measure is None:
        assert mine.group_estimates is None and mine.estimate_stream is None
        return
    assert len(mine.estimate_stream) == len(ref.estimate_stream) == mine.rounds
    for snap, rsnap in zip(mine.estimate_stream, ref.estimate_stream):
        assert snap.keys() == rsnap.keys()
        for g in snap:
            _assert_identical(snap[g], rsnap[g])


def test_groupby_on_the_taxi_layout_equals_reference():
    """The reference's own group-by shape (browse_and_estimate's), where
    the Eq. 10 priorities tie often."""
    t = jsyn.make_real_like_table("taxi", num_records=30_000, seed=0)
    jeng = JaxEngine(jax_build_block_store(JaxTable(t.dims, t.measures, t.cards), 128))
    peng = NeedleTailEngine(build_block_store(Table(t.dims, t.measures, np.asarray(t.cards)),
                                              128, device="cpu"), device="cpu")
    for preds, attr in ((((1, 5),), 0), ((), 3)):
        mine = groupby_any_k(peng, preds, attr, 25, psi=8)
        ref = jax_groupby(jeng, preds, attr, 25, psi=8)
        np.testing.assert_array_equal(mine.blocks_fetched, ref.blocks_fetched)
        np.testing.assert_array_equal(mine.per_group_counts, ref.per_group_counts)
        np.testing.assert_array_equal(mine.record_group, ref.record_group)
    mine = join_any_k(peng, 0, [0, 2], 25, predicates=((1, 5),))
    ref = jax_join(jeng, 0, [0, 2], 25, predicates=((1, 5),))
    np.testing.assert_array_equal(mine.record_block, ref.record_block)
    np.testing.assert_array_equal(mine.record_group, ref.record_group)


def test_groupby_streaming_cis_are_fold_snapshots():
    """Each group's final CI is finite and its mean is the plain mean of the
    group's matching records in the folded blocks (self-weighting)."""
    _, _, eng = _engines("clustered")
    res = groupby_any_k(eng, ((0, 1),), group_attr=1, k=150, measure=0)
    assert res.group_estimates and len(res.estimate_stream) == res.rounds
    bd, bm, bv = eng.store.fetch(np.unique(res.blocks_fetched))
    bd, bm, bv = bd.numpy(), bm.numpy(), bv.numpy()
    for g, e in res.group_estimates.items():
        assert math.isfinite(e.ci_halfwidth()) and e.var_mean >= 0.0
        mask = (bd[..., 0] == 1) & bv & (bd[..., 1] == g)
        if mask.any():
            assert e.mean == pytest.approx(float(bm[..., 0][mask].mean()))


# ------------------------------------------------------------- arbitration


def test_arbitrate_aggregate_arm_order():
    """CI closure wins over the deadline, the deadline fires on a would-be
    overrun, diminishing returns needs its knob, no SLO keeps fetching; and
    every case answers as the reference does."""
    cases = [
        (dict(halfwidth=0.5, error_slo=1.0), "ci"),
        (dict(halfwidth=0.5, error_slo=1.0, deadline_s=1.0, spent_s=2.0, next_cost_s=1.0), "ci"),
        (dict(halfwidth=2.0, error_slo=1.0, deadline_s=1.0, spent_s=0.8, next_cost_s=0.3),
         "deadline"),
        (dict(halfwidth=2.0, deadline_s=1.0, spent_s=0.5, next_cost_s=0.3), None),
        (dict(halfwidth=2.0, next_cost_s=5.0, predicted_halfwidth=1.99, max_s_per_width=1.0),
         "diminishing"),
        (dict(halfwidth=math.inf, error_slo=1.0), None),
    ]
    for kw, want in cases:
        assert arbitrate_aggregate(**kw) == jax_arbitrate(**kw) == want


def test_deadline_priced_by_effective_block_cost():
    """Each round is charged the flat-LRU ``effective_block_cost`` of its
    chunk (the blocks the cache misses, priced by the engine's model, equal
    to the reference's), and a deadline request stops before the next chunk
    would overrun its budget."""
    _, jstore, pstore = _stores("clustered")
    query = AggregateQuery(predicates=((0, 1),), measure=0, k=300, alpha=0.4, seed=1)
    ref_engine = NeedleTailEngine(pstore, device="cpu")
    ref = OnlineAggregator(ref_engine, query, chunk_blocks=8)
    first_chunk = ref.next_blocks()
    ref.close()
    want = effective_block_cost(ref_engine, first_chunk)
    assert want > 0.0 and want == jax_block_cost(JaxEngine(jstore), first_chunk)
    res1 = run_online_aggregate(NeedleTailEngine(pstore, device="cpu"), query, chunk_blocks=8,
                                max_rounds=1)
    assert res1.spent_io_s == want
    res = run_online_aggregate(NeedleTailEngine(pstore, device="cpu"), query,
                               deadline_s=1.5 * want, chunk_blocks=8, max_rounds=32)
    assert res.reason == "deadline" and res.spent_io_s <= 1.5 * want
    warm = NeedleTailEngine(pstore, device="cpu")
    warm.block_cache.get_many(pstore, first_chunk)
    assert effective_block_cost(warm, first_chunk) == 0.0
    assert effective_block_cost(warm, []) == 0.0


def test_example_runs_on_the_cpu(capsys):
    """``examples/torch_browse_and_estimate.py`` with ``device="cpu"``."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / \
        "torch_browse_and_estimate.py"
    spec = importlib.util.spec_from_file_location("torch_browse_and_estimate", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(device="cpu", num_records=60_000)
    out = capsys.readouterr().out
    assert "per-type quota" in out and "online AVG(fare)" in out
