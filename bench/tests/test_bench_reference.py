"""The plain reference on hand-made cases."""
import numpy as np
import pytest
import torch

from bench.reference import anyk


def brute_window(mass, need):
    """Algorithm 2's answer by trying every window: shortest, then first."""
    lam = len(mass)
    best = None
    for length in range(1, lam + 1):
        for s in range(lam - length + 1):
            if mass[s:s + length].sum() >= need:
                return (s, s + length)
    return best or (0, lam)


def test_threshold_cut_and_fallback():
    mass = np.array([5.0, 0.0, 10.0, 3.0])
    exact, _ = anyk.threshold_plans(mass, 12.0)
    assert exact.tolist() == [0, 2]  # 10 then 5 reach 12
    exact, _ = anyk.threshold_plans(mass, 100.0)
    assert exact.tolist() == [0, 2, 3]  # none reaches: every nonzero block
    exact, _ = anyk.threshold_plans(np.array([4.0, 4.0, 4.0]), 5.0)
    assert exact.tolist() == [0, 1]  # equal densities: lower ids first


def test_threshold_slack_admits_only_float32_ties():
    mass = np.array([1e6, 1e6 - 2.0, 5.0])
    need = 2e6 - 1.0  # 1e6 + (1e6 - 2) misses it by 1 record: within float32 rounding
    exact, others = anyk.threshold_plans(mass, need)
    assert exact.tolist() == [0, 1, 2]
    assert [o.tolist() for o in others] == [[0, 1]]
    exact, others = anyk.threshold_plans(mass, 1.5e6)
    assert exact.tolist() == [0, 1] and others == []


@pytest.mark.parametrize("seed", range(6))
def test_window_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    mass = np.where(rng.random(40) < 0.4, 0.0, rng.integers(1, 50, 40)).astype(np.float64)
    for need in (1.0, 30.0, 120.0, 10_000.0):
        exact, others, capped = anyk.window_plans(mass, need)
        assert exact == brute_window(mass, need)
        assert not capped


def test_hdd_cost_by_hand():
    c = anyk.HddCost()
    assert c.io_time([]) == 0.0
    assert c.io_time([7]) == pytest.approx(7e-3)
    # first block, a neighbour (distance 1: seq), a far jump (99 > t: far)
    assert c.io_time([100, 0, 1]) == pytest.approx(7e-3 + 0.8e-3 + 7e-3)
    assert c.io_time([0, 33]) == pytest.approx(7e-3 + 0.8e-3 + (7e-3 - 0.8e-3) * 32 / 63)


def _case(seed=3, lam=60, rpb=64):
    rng = np.random.default_rng(seed)
    matches = np.where(rng.random(lam) < 0.3, rng.integers(0, rpb, lam), 0)
    comb = (matches / rpb).astype(np.float32) * np.float32(0.9)  # estimates above the truth
    return comb, matches, rpb


def test_follow_accepts_the_reference_and_rejects_changes():
    comb, matches, rpb = _case()
    cost = anyk.HddCost()
    for k in (10, 200, 900, 5000):
        blocks, rounds = anyk.run_exact(comb, k, matches, rpb, 8, cost)
        assert anyk.follow(comb, k, matches, blocks, rounds, rpb, 8, cost)[0] == "exact"
        if blocks.size:
            assert anyk.follow(comb, k, matches, blocks[:-1], rounds, rpb, 8, cost)[0] == "off"
            assert anyk.follow(comb, k, matches, blocks, rounds + 1, rpb, 8, cost)[0] == "off"
            twice = np.concatenate([blocks, blocks])
            assert anyk.follow(comb, k, matches, twice, 2 * rounds, rpb, 8, cost)[0] == "off"


def test_refill_stops_at_max_rounds():
    # every block promises a full block (64 records) and holds one match
    comb, matches = np.ones(60, np.float32), np.ones(60, np.int64)
    blocks, rounds = anyk.run_exact(comb, 100, matches, 64, 3, anyk.HddCost())
    assert rounds == 3 and blocks.size == 6  # two blocks a round, then the cap
    assert anyk.follow(comb, 100, matches, blocks, 3, 64, 3, anyk.HddCost())[0] == "exact"


def test_density_index_and_records_by_hand():
    dims = torch.tensor([[0, 1], [1, 1], [0, 0], [1, 0], [1, 1]], dtype=torch.int32)
    dens = anyk.density_index(dims, [2, 2], 2)
    # rows: attr0=0, attr0=1, attr1=0, attr1=1; blocks {0,1}, {2,3}, {4, pad}
    np.testing.assert_array_equal(dens, np.array([[0.5, 0.5, 0.0], [0.5, 0.5, 0.5],
                                                  [0.0, 1.0, 0.0], [1.0, 0.0, 0.5]], np.float32))
    meas = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    blk, row, m = anyk.records(dims, meas, ((0, 1), (1, 1)), "and", np.array([2, 0]), 2)
    assert blk.tolist() == [2, 0] and row.tolist() == [0, 1]
    assert m.tolist() == [[8.0, 9.0], [2.0, 3.0]]
    assert anyk.block_matches(dims, ((0, 0), (1, 0)), "or", 2).tolist() == [1, 2, 0]


def test_combine_folds_in_float32_and_clips_or():
    dens = np.array([[0.5, 0.7], [0.75, 0.6]], np.float32)
    np.testing.assert_array_equal(anyk.combine(dens, [0, 1], "and"),
                                  dens[0] * dens[1])
    np.testing.assert_array_equal(anyk.combine(dens, [0, 1], "or"), np.float32([1.0, 1.0]))
