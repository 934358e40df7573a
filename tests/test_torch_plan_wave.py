"""The port's planners and round protocol against the JAX package's.

Planner contract.  THRESHOLD cuts and TWO-PRONG windows rest on f32 prefix
sums, so two implementations may disagree where a plan's margin
``|cum·rpb − need|`` is below ε = λ·2⁻²⁴·(cum[-1]·rpb), the error bound of
recursive f32 summation.  The port computes its prefix sums and binary
searches in the reference's own order (``repro_torch.core.scan``), so it
agrees with the reference everywhere, boundary included: the tests count
the boundary cases among the disagreements and require that count to be 0
against the reference, and hold the f64 Algorithm 2 (``two_prong_faithful``)
to the same ε.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import threshold as jth
from repro.core import two_prong as jtp
from repro.kernels import plan_wave as jpw
from repro_torch.core import scan, threshold, two_prong
from repro_torch.kernels import plan_wave as pw

RPB = 100


def _rows(seed: int, q: int, lam: int, ties: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.random((q, lam)) ** 4
    if ties:  # few distinct values: long runs of equal densities
        x = np.round(x * 8) / 8
    x[rng.random((q, lam)) < 0.3] = 0.0
    return x.astype(np.float32)


def _needs(rows: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    total = rows.sum(axis=1) * RPB
    return np.maximum(1.0, np.floor(total * rng.uniform(0.01, 1.2, rows.shape[0]))).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 255, 256, 257, 1000, 1024, 4097, 12208])
def test_cumsum_bit_identical_to_jnp_cumsum(n):
    x = _rows(n, 4, n)
    mine = scan.cumsum(torch.from_numpy(x)).numpy()
    ref = np.asarray(jth.threshold_sort_batch(jnp.asarray(x))[2])  # cumsum of the sorted rows
    sd = np.array(jth.threshold_sort_batch(jnp.asarray(x))[1])  # writable copy
    np.testing.assert_array_equal(scan.cumsum(torch.from_numpy(sd)).numpy(), ref)
    np.testing.assert_array_equal(mine, np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))


def test_searchsorted_matches_jnp_on_non_monotone_rows():
    rng = np.random.default_rng(0)
    a = np.cumsum(rng.random((6, 300)), axis=1).astype(np.float32)
    a[:, 100:110] -= 3.0  # dips: the array is not sorted
    v = (rng.random((6, 50)) * a[:, -1:]).astype(np.float32)
    mine = scan.searchsorted_left(torch.from_numpy(a), torch.from_numpy(v)).numpy()
    for i in range(a.shape[0]):
        np.testing.assert_array_equal(
            mine[i], np.asarray(jnp.searchsorted(jnp.asarray(a[i]), jnp.asarray(v[i]), side="left")))


@pytest.mark.parametrize("seed,q,lam,ties", [(0, 8, 64, True), (1, 8, 1000, False),
                                             (2, 4, 1024, True), (3, 1, 3, False)])
def test_threshold_sort_batch_identical_ties_included(seed, q, lam, ties):
    x = _rows(seed, q, lam, ties)
    si, sd, cum = threshold.threshold_sort_batch(torch.from_numpy(x))
    rsi, rsd, rcum = (np.asarray(a) for a in jth.threshold_sort_batch(jnp.asarray(x)))
    np.testing.assert_array_equal(si.numpy(), rsi)
    np.testing.assert_array_equal(sd.numpy(), rsd)
    np.testing.assert_array_equal(cum.numpy(), rcum)
    assert si.dtype == torch.int32


def _threshold_boundary(sd_ref: np.ndarray, n_ref: int, need: float, lam: int) -> bool:
    """Is the reference's cut within ε of the need (exact f64 prefix)?"""
    cum64 = np.cumsum(sd_ref.astype(np.float64)) * RPB
    eps = lam * 2.0**-24 * cum64[-1]
    near = [abs(cum64[j] - need) for j in (n_ref - 2, n_ref - 1) if 0 <= j < lam]
    return bool(near) and min(near) < eps


@pytest.mark.parametrize("seed,lam,ties", [(0, 300, False), (1, 1024, True), (2, 1000, False)])
def test_planner_contract_threshold_cut_and_window_vs_reference(seed, lam, ties):
    x = _rows(seed, 8, lam, ties)
    sd = np.asarray(jth.threshold_sort_batch(jnp.asarray(x))[1])
    cum_ref = np.asarray(jth.threshold_sort_batch(jnp.asarray(x))[2])
    needs = _needs(x, seed)
    # adversarial needs: exactly on a prefix value (margin 0 in the reference)
    needs[:4] = (cum_ref[:4, lam // 3] * np.float32(RPB)).astype(np.float32)
    _, psd, pcum = threshold.threshold_sort_batch(torch.from_numpy(x))
    mismatches = boundary = 0
    for i in range(x.shape[0]):
        n_ref = jth.threshold_cut(sd[i], cum_ref[i], float(needs[i]), RPB)
        n_port = threshold.threshold_cut(psd[i].numpy(), pcum[i].numpy(), float(needs[i]), RPB)
        if n_ref != n_port:
            mismatches += 1
            boundary += _threshold_boundary(sd[i], n_ref, float(needs[i]), lam)
    tp = two_prong.two_prong_select_batch(torch.from_numpy(x), torch.from_numpy(needs), RPB)
    rtp = jtp.two_prong_select_batch(jnp.asarray(x), jnp.asarray(needs), RPB)
    win_mismatch = int((tp.start.numpy() != np.asarray(rtp.start)).sum()
                       + (tp.end.numpy() != np.asarray(rtp.end)).sum())
    assert (mismatches, boundary, win_mismatch) == (0, 0, 0)
    np.testing.assert_array_equal(tp.expected_records.numpy(), np.asarray(rtp.expected_records))


@pytest.mark.parametrize("seed,lam", [(0, 64), (1, 500), (2, 1024)])
def test_two_prong_windows_against_float64_algorithm2_within_epsilon(seed, lam):
    """The port's windows equal Algorithm 2 run in float64 except boundary
    cases (a window's f64 mass within ε of the need), which stay rare."""
    x = _rows(seed, 8, lam)
    needs = _needs(x, seed + 10)
    tp = two_prong.two_prong_select_batch(torch.from_numpy(x), torch.from_numpy(needs), RPB)
    boundary = 0
    for i in range(x.shape[0]):
        s, e = int(tp.start[i]), int(tp.end[i])
        fs, fe = two_prong.two_prong_faithful(x[i], float(needs[i]), RPB)
        if (s, e) != (fs, fe):
            m = x[i].astype(np.float64) * RPB
            eps = lam * 2.0**-24 * m.sum()
            margin = min(abs(m[s:e].sum() - needs[i]), abs(m[fs:fe].sum() - needs[i]))
            assert margin < eps, (i, (s, e), (fs, fe), margin, eps)
            boundary += 1
    assert boundary <= 1


def test_two_prong_faithful_copy_matches_reference():
    x = _rows(5, 6, 200)
    for i, k in enumerate(_needs(x, 5)):
        assert two_prong.two_prong_faithful(x[i], float(k), RPB) == jtp.two_prong_faithful(x[i], float(k), RPB)


def test_threshold_faithful_copy_matches_reference():
    rng = np.random.default_rng(4)
    dens = (rng.random((6, 40)) ** 2).astype(np.float32)
    for rows, k, op in (([0, 3], 150, "and"), ([1, 2, 5], 900, "or"), ([4], 40, "and")):
        assert threshold.threshold_faithful(dens, np.asarray(rows), k, RPB, op) == \
            jth.threshold_faithful(dens, np.asarray(rows), k, RPB, op)


def _assert_plan_equal(mine, ref):
    for f in ("combined", "th_mask", "n_sel", "theta", "theta_count", "tp_start", "tp_end"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    # expected_records scales a θ-sum: f32 terms in another order
    np.testing.assert_allclose(mine.expected_records.numpy(), np.asarray(ref.expected_records),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("seed,lam", [(0, 200), (1, 1024), (2, 33)])
def test_plan_wave_from_combined_matches_reference(seed, lam):
    x = _rows(seed, 8, lam, ties=seed == 1)
    rng = np.random.default_rng(seed)
    excl = rng.random(x.shape) < 0.2
    needs = _needs(x, seed)
    mine = pw.plan_wave_from_combined(torch.from_numpy(x), torch.from_numpy(excl),
                                      torch.from_numpy(needs), RPB)
    ref = jpw.plan_wave_from_combined(jnp.asarray(x), jnp.asarray(excl), jnp.asarray(needs), RPB)
    _assert_plan_equal(mine, ref)
    sel = mine.th_mask.numpy()
    assert not (sel & excl).any()  # a prefix never takes an excluded block
    assert (mine.theta_count >= mine.n_sel.float()).all()  # θ invariant (ties)


@pytest.mark.parametrize("op", ["and", "or"])
def test_plan_wave_single_shot_matches_reference(op):
    rng = np.random.default_rng(9)
    dens = (rng.random((10, 300)) ** 2).astype(np.float32)
    rm = np.asarray([[0, 3, -1], [2, -1, -1], [1, 4, 7], [5, 5, -1]], np.int32)
    excl = np.zeros((4, 300), bool)
    needs = np.asarray([500, 40, 20, 900], np.float32)
    mine = pw.plan_wave(torch.from_numpy(dens), rm, torch.from_numpy(excl),
                        torch.from_numpy(needs), RPB, op)
    ref = jpw.plan_wave(jnp.asarray(dens), jnp.asarray(rm), jnp.asarray(excl),
                        jnp.asarray(needs), RPB, op)
    _assert_plan_equal(mine, ref)


def test_lambda_zero_round_returns_empty_plans():
    x = np.zeros((4, 0), np.float32)
    needs = np.ones(4, np.float32)
    mine = pw.plan_wave_from_combined(torch.from_numpy(x), torch.zeros((4, 0), dtype=torch.bool),
                                      torch.from_numpy(needs), RPB)
    ref = jpw.plan_wave_from_combined(jnp.asarray(x), jnp.zeros((4, 0), bool), jnp.asarray(needs), RPB)
    _assert_plan_equal(mine, ref)
    assert mine.th_mask.shape == (4, 0)
    packed = pw.pack_plan(mine.th_mask, mine.n_sel, mine.tp_start, mine.tp_end).numpy()
    assert packed.shape == (4, 3)
    tp = two_prong.two_prong_select_batch(torch.from_numpy(x), torch.from_numpy(needs), RPB)
    assert tp.start.tolist() == tp.end.tolist() == [0, 0, 0, 0]


def test_pack_unpack_round_trip_matches_reference():
    rng = np.random.default_rng(1)
    th = rng.random((4, 50)) < 0.3
    n, s, e = (rng.integers(0, 50, 4).astype(np.int32) for _ in range(3))
    mine = pw.pack_plan(torch.from_numpy(th), torch.from_numpy(n), torch.from_numpy(s),
                        torch.from_numpy(e)).numpy()
    ref = np.asarray(jpw.pack_plan(jnp.asarray(th), jnp.asarray(n), jnp.asarray(s), jnp.asarray(e)))
    np.testing.assert_array_equal(mine, ref)
    assert mine.dtype == np.int32
    for a, b in zip(pw.unpack_plan(mine, 50), jpw.unpack_plan(ref, 50)):
        np.testing.assert_array_equal(a, b)


def test_apply_chosen_matches_reference():
    rng = np.random.default_rng(2)
    excl = rng.random((6, 40)) < 0.2
    th = rng.random((6, 40)) < 0.3
    tp = np.sort(rng.integers(0, 41, (6, 2)), axis=1).astype(np.int32)
    chosen = np.asarray([0, 1, -1, 1, 0, -1], np.int8)
    mine = pw.apply_chosen(torch.from_numpy(excl), torch.from_numpy(th), torch.from_numpy(tp),
                           torch.from_numpy(chosen)).numpy()
    ref = np.asarray(jpw.apply_chosen(jnp.asarray(excl), jnp.asarray(th), jnp.asarray(tp),
                                      jnp.asarray(chosen)))
    np.testing.assert_array_equal(mine, ref)


def test_join_wave_slots_matches_reference():
    rng = np.random.default_rng(3)
    c0 = rng.random((8, 30)).astype(np.float32)
    excl, th = rng.random((8, 30)) < 0.2, rng.random((8, 30)) < 0.3
    tp = rng.integers(0, 30, (8, 2)).astype(np.int32)
    idx = np.asarray([1, 6], np.int32)
    rows, ex_rows = rng.random((2, 30)).astype(np.float32), rng.random((2, 30)) < 0.5
    t = torch.from_numpy
    mine = pw.join_wave_slots(t(c0), t(excl), t(th), t(tp), t(idx).long(), t(rows), t(ex_rows))
    ref = jpw.join_wave_slots(jnp.asarray(c0), jnp.asarray(excl), jnp.asarray(th), jnp.asarray(tp),
                              jnp.asarray(idx), jnp.asarray(rows), jnp.asarray(ex_rows))
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(c0, t(c0).numpy())  # the inputs are not written


def test_single_row_two_prong_matches_reference():
    x = _rows(6, 3, 400)
    for i, k in enumerate(_needs(x, 6)):
        mine = two_prong.two_prong_select(torch.from_numpy(x[i]), float(k), RPB)
        ref = jtp.two_prong_select(jnp.asarray(x[i]), float(k), RPB)
        assert (int(mine.start), int(mine.end)) == (int(ref.start), int(ref.end))
        assert float(mine.expected_records) == float(ref.expected_records)


@pytest.mark.parametrize("seed,lam", [(3, 300), (4, 1024), (5, 1)])
def test_fused_theta_round_matches_reference(seed, lam):
    """The wave round's θ-statistics in one call (θ from the cut, then
    ``theta_count`` and ``expected_records``), through
    ``plan_wave_from_combined``, on rows with ties, a row with nothing, a
    row with everything excluded (no cut: all three 0) and an unreachable
    need (the cut takes every nonzero block): θ and ``theta_count`` equal to
    the reference's, ``expected_records`` within rtol=1e-5 (a θ-sum: the same
    f32 terms in another order).  ``theta_wave`` on the round's own sorted
    rows gives the same values."""
    from repro_torch.kernels.theta_stats import theta_wave

    x = _rows(seed, 6, lam, ties=True)
    x[0] = 0.0
    rng = np.random.default_rng(seed)
    excl = rng.random(x.shape) < 0.2
    excl[1] = True
    needs = _needs(x, seed)
    needs[2] = 1e9
    mine = pw.plan_wave_from_combined(torch.from_numpy(x), torch.from_numpy(excl),
                                      torch.from_numpy(needs), RPB)
    ref = jpw.plan_wave_from_combined(jnp.asarray(x), jnp.asarray(excl), jnp.asarray(needs), RPB)
    np.testing.assert_array_equal(mine.theta.numpy(), np.asarray(ref.theta))
    np.testing.assert_array_equal(mine.theta_count.numpy(), np.asarray(ref.theta_count))
    np.testing.assert_allclose(mine.expected_records.numpy(), np.asarray(ref.expected_records),
                               rtol=1e-5, atol=0)
    assert float(mine.theta_count[0]) == float(mine.expected_records[1]) == 0.0
    sd = threshold.threshold_sort_batch(mine.combined)[1]
    for a, b in zip(theta_wave(mine.combined, sd, mine.n_sel, RPB),
                    (mine.theta, mine.theta_count, mine.expected_records)):
        assert torch.equal(a, b)
