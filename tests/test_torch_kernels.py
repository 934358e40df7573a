"""The port's kernels against the JAX package's.

Inputs come from numpy with a seed and go through both packages.  On the CPU
each wrapper runs its plain PyTorch version, held here against the Pallas
kernel in interpret mode (``repro.kernels.ops``) and the reference's jnp
forms: the ⊕-combines and the gather bit for bit, the prefix scan bit for
bit against ``jnp.cumsum`` (and to the reference test's tolerance against
the Pallas scan, whose triangular matmul adds in another order), the
θ-counts exactly and the θ-sums to ``rtol=1e-5`` (the same f32 terms added
in another order; at λ ≤ 1024 the observed gap is far smaller).  The CUDA
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.density_map import combine_densities_batch_np, combine_densities_np
from repro.core.threshold import threshold_select
from repro.kernels import ops
from repro.kernels.density_combine import _combine_local
from repro.kernels.ref import theta_stats_batch_ref
from repro_torch.kernels import _lib
from repro_torch.kernels import ops as tops
from repro_torch.kernels.density_combine import (
    density_combine, density_combine_batch, density_combine_batch_sharded, density_combine_wave,
    density_combine_wave_plain, density_combine_wave_sharded, exclusion_csr,
)
from repro_torch.kernels.plan_wave import block_gather
from repro_torch.kernels.theta_stats import (
    bisect_carry, bisect_round_batch, theta_stats, theta_stats_batch, theta_wave,
)
from repro_torch.kernels.window_scan import prefix_sum


def _combine_inputs(seed: int, q: int, gamma: int, lam: int, rows: int = 12):
    rng = np.random.default_rng(seed)
    dens = (rng.random((rows, lam)) ** 2).astype(np.float32)
    dens[rng.random((rows, lam)) < 0.2] = 0.0  # empty blocks
    rm = rng.integers(0, rows, (q, gamma)).astype(np.int32)
    for i in range(q):  # ragged: pad a random tail with -1
        rm[i, rng.integers(1, gamma + 1):] = -1
    return dens, rm


COMBINE_CASES = [(0, 8, 3, 1000), (1, 5, 2, 512), (2, 1, 1, 37), (3, 8, 3, 1024)]


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("seed,q,gamma,lam", COMBINE_CASES)
def test_combine_plain_bit_identical_to_pallas_and_reference_folds(op, seed, q, gamma, lam):
    dens, rm = _combine_inputs(seed, q, gamma, lam)
    mine = density_combine_batch(torch.from_numpy(dens), torch.from_numpy(rm), op).numpy()
    np.testing.assert_array_equal(mine, np.asarray(ops.density_combine_batch(
        jnp.asarray(dens), jnp.asarray(rm), op)))
    np.testing.assert_array_equal(mine, np.asarray(_combine_local(
        jnp.asarray(dens), jnp.asarray(rm), op)))
    np.testing.assert_array_equal(mine, combine_densities_batch_np(dens, rm, op))


def _wave_exclude(seed: int, q: int, lam: int, kind: str):
    """Per-row exclusions: None, all rows empty, or on every other row an
    unsorted list with a repeat and a negative id (counted from the end)."""
    if kind == "none":
        return None
    if kind == "empty":
        return [np.zeros(0, np.int64)] * q
    rng = np.random.default_rng(seed + 50)
    return [np.concatenate([rng.integers(0, lam, lam // 5 + 1), [0, 0, -1]]) if i % 2 == 0
            else np.zeros(0, np.int64) for i in range(q)]


@pytest.mark.parametrize("excl", ["none", "empty", "lists"])
@pytest.mark.parametrize("seed,q,gamma,lam", [(0, 8, 3, 1000), (1, 5, 5, 512), (2, 1, 1, 37),
                                              (3, 7, 2, 1024)])
def test_wave_combine_plain_bit_identical_to_pallas_per_op_group(seed, q, gamma, lam, excl):
    """The multi-op combine on a mixed AND/OR wave with -1 padding and a CSR
    exclusion: bit for bit the reference's Pallas ``density_combine_batch``
    (interpret mode) run once per op group, then ``jnp.where`` for the
    exclusion; excluded elements are +0.0.  Its plain version on the CSR
    list the kernel takes gives the same bits."""
    dens, rm = _combine_inputs(seed, q, gamma, lam)
    rng = np.random.default_rng(seed + 10)
    wave_ops = ["or" if b else "and" for b in rng.random(q) < 0.5]
    wave_ops[-1] = "or"
    exclude = _wave_exclude(seed, q, lam, excl)
    ref = np.zeros((q, lam), np.float32)
    for op in ("and", "or"):
        js = [i for i, o in enumerate(wave_ops) if o == op]
        if js:
            ref[js] = np.asarray(ops.density_combine_batch(jnp.asarray(dens), jnp.asarray(rm[js]),
                                                           op))
    if exclude is not None:
        mask = np.zeros((q, lam), bool)
        for i, e in enumerate(exclude):
            mask[i, e] = True
        ref = np.asarray(jnp.where(jnp.asarray(mask), jnp.float32(0.0), jnp.asarray(ref)))
    mine = density_combine_wave(torch.from_numpy(dens), torch.from_numpy(rm), wave_ops,
                                exclude).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert not np.signbit(mine).any()
    csr = None if exclude is None else torch.from_numpy(exclusion_csr(exclude, lam))
    plain = density_combine_wave_plain(torch.from_numpy(dens), torch.from_numpy(rm),
                                       torch.tensor([o == "or" for o in wave_ops]), csr)
    np.testing.assert_array_equal(plain.numpy(), ref)
    sharded = density_combine_wave_sharded(torch.from_numpy(dens), torch.from_numpy(rm), wave_ops)
    if exclude is None:
        np.testing.assert_array_equal(sharded.numpy(), ref)


def test_exclusion_csr_offsets_then_sorted_unique_ids():
    csr = exclusion_csr([[5, 1, 5, -1], [], [3]], 10)
    assert csr.dtype == np.int32
    assert csr.tolist() == [0, 3, 3, 4, 1, 5, 9, 3]
    assert exclusion_csr([], 10).tolist() == [0]
    with pytest.raises(IndexError):
        exclusion_csr([[10]], 10)


def _theta_inputs(seed: int, q: int, lam: int, t: int = 8):
    rng = np.random.default_rng(seed)
    x = (rng.random((q, lam)) ** 3).astype(np.float32)
    x[rng.random((q, lam)) < 0.3] = 0.0
    base = np.sort(x, axis=1)[:, ::-1][:, min(lam - 1, 5)]  # a θ near the top
    thetas = (base[:, None] * (1.0 + np.arange(t, dtype=np.float32))[None, :]).astype(np.float32)
    thetas[0] = 0.0  # θ = 0: every block clears it, zeros included
    return x, thetas


@pytest.mark.parametrize("seed,q,lam", [(0, 8, 1000), (1, 3, 2048), (2, 1, 7), (3, 5, 1024)])
def test_theta_stats_plain_against_pallas_and_oracle(seed, q, lam):
    x, th = _theta_inputs(seed, q, lam)
    counts, recsum = theta_stats_batch(torch.from_numpy(x), torch.from_numpy(th))
    for rc, rs in (ops.theta_stats_batch(jnp.asarray(x), jnp.asarray(th)),
                   theta_stats_batch_ref(jnp.asarray(x), jnp.asarray(th))):
        np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
        np.testing.assert_allclose(recsum.numpy(), np.asarray(rs), rtol=1e-5, atol=0)


def _slab(kind: str, lam: int, r: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "i32_3d":
        return rng.integers(-1, 40, (lam, r, 5)).astype(np.int32)
    if kind == "f32_3d":
        return rng.normal(size=(lam, r, 3)).astype(np.float32)
    if kind == "i8_2d":
        return (rng.random((lam, r)) < 0.9).astype(np.int8)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["i32_3d", "f32_3d", "i8_2d"])
@pytest.mark.parametrize("ids", [[3, 0, 7], [2, 2, 5, 2], [], list(range(9, -1, -1))],
                         ids=["ascending_union", "repeated", "empty", "all_reversed"])
def test_gather_plain_bit_identical_to_pallas(kind, ids):
    slab = _slab(kind, lam=10, r=50, seed=len(ids))
    ids_np = np.asarray(ids, dtype=np.int32)
    mine = block_gather(torch.from_numpy(slab), torch.from_numpy(ids_np)).numpy()
    ref = np.asarray(ops.block_gather(jnp.asarray(slab), jnp.asarray(ids_np)))
    assert mine.shape == ref.shape == (len(ids), *slab.shape[1:])
    assert mine.dtype == slab.dtype
    np.testing.assert_array_equal(mine, ref)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: no kernel launch
    is counted."""
    before = dict(_lib.LAUNCHES)
    dens, rm = _combine_inputs(0, 4, 2, 64)
    density_combine_batch(torch.from_numpy(dens), torch.from_numpy(rm))
    x, th = _theta_inputs(0, 4, 64)
    theta_stats_batch(torch.from_numpy(x), torch.from_numpy(th))
    block_gather(torch.from_numpy(_slab("i8_2d", 10, 8, 0)), torch.tensor([1, 2], dtype=torch.int32))
    density_combine(torch.from_numpy(dens), torch.tensor([1, 0], dtype=torch.int32))
    theta_stats(torch.from_numpy(x[0]), torch.from_numpy(th[0]))
    prefix_sum(torch.from_numpy(x))
    tops.threshold_bisect(torch.from_numpy(x[0]), 5.0, 10)
    density_combine_batch_sharded(torch.from_numpy(dens[:, :16].copy()), torch.from_numpy(rm))
    density_combine_wave(torch.from_numpy(dens), torch.from_numpy(rm), ["or", "and", "and", "or"],
                         [[1], [], [2, 3], []])
    xt = torch.from_numpy(x)
    theta_wave(xt, xt, torch.ones(4, dtype=torch.int32), 10)
    bisect_round_batch(xt, torch.ones(4), 10, bisect_carry(4, 16, "cpu"), first=True)
    assert _lib.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda: density_combine_batch(torch.zeros((4, 8), dtype=torch.float64),
                                  torch.zeros((2, 2), dtype=torch.int32)),
    lambda: density_combine_batch(torch.zeros((4, 8)), torch.zeros((2, 2), dtype=torch.int64)),
    lambda: density_combine_batch(torch.zeros((4, 8)), torch.zeros((2, 2), dtype=torch.int32), "xor"),
    lambda: theta_stats_batch(torch.zeros((2, 8)), torch.zeros((3, 8))),
    lambda: theta_stats_batch(torch.zeros((2, 8), dtype=torch.float16), torch.zeros((2, 8))),
    lambda: block_gather(torch.zeros((4, 3, 2), dtype=torch.int64), torch.zeros((1,), dtype=torch.int32)),
    lambda: block_gather(torch.zeros((4, 3, 2), dtype=torch.int32), torch.zeros((1,), dtype=torch.int64)),
    lambda: block_gather(torch.zeros((4,), dtype=torch.int32), torch.zeros((1,), dtype=torch.int32)),
    lambda: density_combine(torch.zeros((4, 8)), torch.zeros((1, 2), dtype=torch.int32)),
    lambda: density_combine(torch.zeros((4, 8)), torch.zeros((2,), dtype=torch.int64)),
    lambda: theta_stats(torch.zeros((2, 8)), torch.zeros((8,))),
    lambda: theta_stats(torch.zeros((8,)), torch.zeros((0,))),
    lambda: prefix_sum(torch.zeros((8,), dtype=torch.float64)),
    lambda: prefix_sum(torch.zeros((2, 3, 8))),
    lambda: density_combine_batch_sharded(torch.zeros((4, 8), dtype=torch.float64),
                                          torch.zeros((2, 2), dtype=torch.int32)),
    lambda: density_combine_batch_sharded(torch.zeros((4, 8)), torch.zeros((2,), dtype=torch.int32)),
    lambda: density_combine_batch_sharded(torch.zeros((4, 8)),
                                          torch.zeros((2, 2), dtype=torch.int32), op="xor"),
    lambda: density_combine_wave(torch.zeros((4, 8)), torch.zeros((2, 2), dtype=torch.int32),
                                 ["and"]),
    lambda: density_combine_wave(torch.zeros((4, 8)), torch.zeros((2, 2), dtype=torch.int32),
                                 ["and", "xor"]),
    lambda: density_combine_wave(torch.zeros((4, 8)), torch.zeros((2, 2), dtype=torch.int32),
                                 ["and", "or"], [[1]]),
    lambda: theta_wave(torch.zeros((2, 8)), torch.zeros((2, 8)), torch.zeros((2,)), 10),
    lambda: theta_wave(torch.zeros((2, 8)), torch.zeros((2, 7)),
                       torch.zeros((2,), dtype=torch.int32), 10),
    lambda: bisect_round_batch(torch.zeros((2, 8)), torch.ones(2), 10,
                               bisect_carry(3, 4, "cpu"), first=True),
], ids=["combine_f64", "combine_i64_rows", "combine_op", "theta_q_mismatch",
        "theta_f16", "gather_i64_slab", "gather_i64_ids", "gather_1d_slab",
        "single_combine_2d_rows", "single_combine_i64_rows", "single_theta_2d",
        "single_theta_no_thresholds", "scan_f64", "scan_3d", "sharded_combine_f64",
        "sharded_combine_1d_rows", "sharded_combine_op", "wave_ops_per_row", "wave_op",
        "wave_exclude_per_row", "theta_wave_n_sel_dtype", "theta_wave_shapes",
        "bisect_round_carry_rows"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("n", [1, 100, 1024, 5000])
def test_prefix_sum_plain_against_pallas_and_jnp_cumsum(n):
    rng = np.random.default_rng(n)
    x = rng.random(n).astype(np.float32)
    mine = prefix_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(mine, np.asarray(ops.prefix_sum(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(mine, np.asarray(jnp.cumsum(jnp.asarray(x))))
    rows = rng.random((3, n)).astype(np.float32)
    np.testing.assert_array_equal(prefix_sum(torch.from_numpy(rows)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(rows), axis=1)))


def test_prefix_sum_shared_memory_edge_against_jnp_cumsum():
    """The kernel's shared-memory branch takes rows up to 16^4 = 65,536
    (its levels from the third on fit one warp).  At that length and one
    past it (the other branch) the plain version, which the card holds the
    kernel to bit for bit, equals ``jnp.cumsum``."""
    from repro_torch.kernels.window_scan import SMEM_MAX_N

    assert SMEM_MAX_N == 65536
    rng = np.random.default_rng(SMEM_MAX_N)
    for n in (SMEM_MAX_N, SMEM_MAX_N + 1):
        x = (rng.random(n) ** 4).astype(np.float32)
        np.testing.assert_array_equal(prefix_sum(torch.from_numpy(x)).numpy(),
                                      np.asarray(jnp.cumsum(jnp.asarray(x))))


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("gamma", [1, 2, 5])
def test_single_combine_plain_bit_identical_to_pallas(op, gamma):
    dens, _ = _combine_inputs(gamma, 1, 1, 1000)
    rows = np.random.default_rng(gamma).integers(0, dens.shape[0], gamma).astype(np.int32)
    mine = density_combine(torch.from_numpy(dens), torch.from_numpy(rows), op).numpy()
    np.testing.assert_array_equal(mine, np.asarray(ops.density_combine(
        jnp.asarray(dens), jnp.asarray(rows), op)))
    np.testing.assert_array_equal(mine, combine_densities_np(dens, rows, op))


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("excl", ["empty", "unsorted_dups", "all"])
@pytest.mark.parametrize("gamma", [1, 3, 64, 65])
def test_single_combine_with_exclusion_bit_identical_to_reference(gamma, excl, op):
    """The single-query combine with the planner's exclusion (γ up to the 64
    ids a launch carries by value, and one more): bit for bit the
    reference's ``combine_densities_np`` followed by ``combined[exclude] =
    0.0``, for exclusion lists empty, unsorted with duplicates and a
    negative id, and all of λ."""
    dens, _ = _combine_inputs(gamma, 1, 1, 1000)
    rng = np.random.default_rng(gamma)
    rows = rng.integers(0, dens.shape[0], gamma).astype(np.int32)
    exclude = {"empty": np.zeros(0, np.int64),
               "unsorted_dups": np.concatenate([rng.integers(0, 1000, 50), [7, 7, -1]]),
               "all": rng.permutation(1000)}[excl]
    want = combine_densities_np(dens, rows, op)
    want[exclude] = 0.0
    mine = density_combine(torch.from_numpy(dens), torch.from_numpy(rows), op, exclude).numpy()
    np.testing.assert_array_equal(mine, want)
    assert not np.signbit(mine).any()


def test_exclusion_ids_sorted_unique_and_range_checked():
    from repro_torch.kernels.density_combine import exclusion_ids

    ids = exclusion_ids(np.asarray([5, 1, 5, -1, 0]), 10)
    assert ids.dtype == np.int32 and ids.tolist() == [0, 1, 5, 9]
    assert exclusion_ids([], 10).size == 0
    for bad in ([10], [-11]):
        with pytest.raises(IndexError):
            exclusion_ids(bad, 10)
    with pytest.raises(IndexError):  # host row ids are range-checked too
        density_combine(torch.zeros((4, 8)), torch.tensor([4], dtype=torch.int32))


@pytest.mark.parametrize("lam,T", [(100, 8), (1000, 16), (1024, 8)])
def test_single_theta_stats_plain_against_pallas(lam, T):
    rng = np.random.default_rng(lam)
    comb = (rng.random(lam) * (rng.random(lam) < 0.4)).astype(np.float32)
    ths = np.linspace(0.01, 0.95, T).astype(np.float32)
    counts, recsum = theta_stats(torch.from_numpy(comb), torch.from_numpy(ths))
    rc, rs = ops.theta_stats(jnp.asarray(comb), jnp.asarray(ths))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_allclose(recsum.numpy(), np.asarray(rs), rtol=1e-5, atol=0)


@pytest.mark.parametrize("seed,lam", [(0, 5000), (1, 64), (2, 1024)])
def test_threshold_bisect_equals_pallas_and_matches_sort_selection(seed, lam):
    """θ* equals the reference's on every row (boundary cases counted: 0
    here), and where the row's records can reach k the selection
    ``combined >= θ*`` is the sort-based one to the reference test's bound
    (``tests/test_kernels.py``, whose λ = 5000 row reaches every k it asks)."""
    rng = np.random.default_rng(seed)
    comb = (rng.random(lam) * (rng.random(lam) < 0.3)).astype(np.float32)
    boundary = 0
    for k in (10.0, 200.0, 3000.0, 1e9):
        theta = float(tops.threshold_bisect(torch.from_numpy(comb), k, 10))
        boundary += theta != float(ops.threshold_bisect(jnp.asarray(comb), k, 10))
        n_bisect = int(np.sum(comb >= theta))
        n_sort = int(threshold_select(jnp.asarray(comb), k, 10).num_selected)
        if float(comb.astype(np.float64).sum()) * 10 >= k:
            assert abs(n_bisect - n_sort) <= max(2, 0.01 * n_sort)
        else:  # unreachable k: θ* = 0 takes every block
            assert theta == 0.0
    assert boundary == 0


def test_ops_exposes_the_reference_names_and_defers_the_lm_kernels():
    """Every name of the reference's ``ops``; the LM kernels landed with the
    LM serving slice and are the wrappers of their kernel modules."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_scan

    for name in ("density_combine", "density_combine_batch", "prefix_sum", "theta_stats",
                 "theta_stats_batch", "threshold_bisect", "plan_wave", "block_gather",
                 "flash_attention", "ssd_scan"):
        assert callable(getattr(tops, name))
    assert tops.flash_attention is flash_attention and tops.ssd_scan is ssd_scan
