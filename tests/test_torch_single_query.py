"""The port's single-query path against the JAX package's, on the CPU.

``combined_density`` (the single-row ⊕-combine), the single-row THRESHOLD
and TWO-PRONG planners, ``engine.plan`` and the sequential ``engine.any_k``
loop take the same seeded inputs through both packages: ids, cuts, windows,
records, blocks, rounds and algorithm must be byte-identical (the prefix
sums add in the reference's order, so there are no boundary cases to
excuse), across every planner, AND and OR, and k that forces refills.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _assert_query_equal, _fixture

from repro.core import threshold as jth
from repro.core import two_prong as jtp
from repro.core.density_map import combine_densities_np
from repro.core.engine import NeedleTailEngine as JaxEngine
from repro_torch.core import threshold, two_prong
from repro_torch.core.density_map import combine_densities
from repro_torch.core.engine import NeedleTailEngine

ALGOS = ("threshold", "two_prong", "auto")
RPB = 100


def _row(seed: int, lam: int, ties: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.random(lam) ** 4
    if ties:
        x = np.round(x * 8) / 8
    x[rng.random(lam) < 0.3] = 0.0
    return x.astype(np.float32)


ROWS = [(0, 64, True), (1, 1000, False), (2, 1024, True), (3, 3, False), (4, 17, False)]


@pytest.mark.parametrize("seed,lam,ties", ROWS)
def test_threshold_select_bit_identical(seed, lam, ties):
    x = _row(seed, lam, ties)
    total = float(x.astype(np.float64).sum()) * RPB
    for k in (1.0, 0.3 * total, total, 2 * total + 5):
        mine = threshold.threshold_select(torch.from_numpy(x), k, RPB)
        ref = jth.threshold_select_jit(jnp.asarray(x), float(k), RPB)
        np.testing.assert_array_equal(mine.block_ids.numpy(), np.asarray(ref.block_ids))
        assert int(mine.num_selected) == int(ref.num_selected)
        assert mine.expected_records.item() == float(ref.expected_records)
        assert mine.block_ids.dtype == torch.int32


@pytest.mark.parametrize("seed,lam,ties", ROWS)
def test_threshold_refill_bit_identical(seed, lam, ties):
    x = _row(seed, lam, ties)
    excl = np.random.default_rng(seed).random(lam) < 0.25
    k = 0.4 * float(x.sum()) * RPB
    mine = threshold.threshold_refill(torch.from_numpy(x), torch.from_numpy(excl), k, RPB)
    ref = jth.threshold_refill(jnp.asarray(x), jnp.asarray(excl), k, RPB)
    np.testing.assert_array_equal(mine.block_ids.numpy(), np.asarray(ref.block_ids))
    assert int(mine.num_selected) == int(ref.num_selected)


@pytest.mark.parametrize("seed,lam,ties", ROWS)
def test_two_prong_select_bit_identical(seed, lam, ties):
    x = _row(seed, lam, ties)
    total = float(x.astype(np.float64).sum()) * RPB
    for k in (1.0, 0.05 * total, 0.5 * total, total, 2 * total + 5):
        mine = two_prong.two_prong_select(torch.from_numpy(x), k, RPB)
        ref = jtp.two_prong_select_jit(jnp.asarray(x), float(k), RPB)
        assert (int(mine.start), int(mine.end)) == (int(ref.start), int(ref.end))
        assert mine.expected_records.item() == float(ref.expected_records)


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("name", ["clustered", "uniform", "skewed"])
def test_combined_density_bit_identical(name, op):
    (jstore, pstore), qs = _fixture(name)
    eng = NeedleTailEngine(pstore, device="cpu")
    dens = np.asarray(jstore.index.densities)
    for preds, _, _ in qs:
        rows = jstore.index.vocab.rows(preds)
        mine = eng.combined_density(preds, op).numpy()
        np.testing.assert_array_equal(mine, combine_densities_np(dens, rows, op))
        np.testing.assert_array_equal(mine, combine_densities(pstore.index.densities, rows, op))
    with pytest.raises(IndexError):
        combine_densities(pstore.index.densities, [dens.shape[0]])


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", ["clustered", "uniform", "skewed", "underdelivery"])
def test_plan_equals_reference_plan(name, algo):
    (jstore, pstore), qs = _fixture(name)
    eng, jeng = NeedleTailEngine(pstore, device="cpu"), JaxEngine(jstore, cache_bytes=0)
    rng = np.random.default_rng(len(name))
    for preds, k, op in qs:
        for exclude in (None, np.sort(rng.choice(pstore.num_blocks, 7, replace=False))):
            blocks, used = eng.plan(preds, k, op, algo, exclude)
            rblocks, rused = jeng.plan(preds, k, op, algo, exclude)
            np.testing.assert_array_equal(blocks, rblocks)  # the order too
            assert blocks.dtype == np.int64 and used == rused


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", ["clustered", "uniform", "skewed", "underdelivery"])
def test_plan_with_unsorted_duplicated_exclusion_equals_reference_plan(name, algo):
    """Exclusion lists as a caller may pass them: unsorted, with duplicates
    and a negative id (counted from the end, as numpy indexes), empty, and
    all of λ.  The port folds them into the combine (sorted and de-duplicated
    on the host); the reference assigns ``combined[exclude] = 0.0``."""
    (jstore, pstore), qs = _fixture(name)
    eng, jeng = NeedleTailEngine(pstore, device="cpu"), JaxEngine(jstore, cache_bytes=0)
    lam = pstore.num_blocks
    rng = np.random.default_rng(len(name) + 1)
    lists = (np.concatenate([rng.integers(0, lam, 12), [3, 3, -1, 0]]),
             np.zeros(0, np.int64), rng.permutation(lam))
    for preds, k, op in qs:
        for exclude in lists:
            blocks, used = eng.plan(preds, k, op, algo, exclude)
            rblocks, rused = jeng.plan(preds, k, op, algo, exclude)
            np.testing.assert_array_equal(blocks, rblocks)
            assert blocks.dtype == np.int64 and used == rused


def test_plan_rejects_excluded_ids_out_of_range():
    (_, pstore), qs = _fixture("clustered")
    eng = NeedleTailEngine(pstore, device="cpu")
    preds, k, op = qs[0]
    for bad in ([pstore.num_blocks], [-pstore.num_blocks - 1]):
        with pytest.raises(IndexError):
            eng.plan(preds, k, op, "auto", np.asarray(bad))


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", ["clustered", "uniform", "skewed", "underdelivery"])
def test_any_k_equals_reference_any_k(name, algo):
    (jstore, pstore), qs = _fixture(name)
    eng, jeng = NeedleTailEngine(pstore, device="cpu"), JaxEngine(jstore)
    for preds, k, op in qs:
        for kk in (k, 10 * k):  # 10·k forces refills
            mine = eng.any_k(preds, kk, op=op, algo=algo)
            ref = jeng.any_k(preds, kk, op=op, algo=algo)
            _assert_query_equal(mine, ref)
            np.testing.assert_array_equal(mine.blocks_fetched, ref.blocks_fetched)
            assert mine.modeled_io_s == ref.modeled_io_s
            assert mine.record_row.dtype == np.asarray(ref.record_row).dtype
    assert eng.block_cache.stats.snapshot() == jeng.block_cache.stats.snapshot()


def test_any_k_refills_over_several_rounds():
    (jstore, pstore), qs = _fixture("underdelivery")
    preds, k, op = qs[0]
    mine = NeedleTailEngine(pstore, device="cpu").any_k(preds, k, op=op, algo="threshold")
    assert mine.plan_rounds > 1
    _assert_query_equal(mine, JaxEngine(jstore).any_k(preds, k, op=op, algo="threshold"))


def test_any_k_stops_at_max_refills_and_on_empty_plans():
    (jstore, pstore), _ = _fixture("clustered")
    preds = [(0, 1), (1, 1), (2, 1), (3, 1)]
    for refills in (1, 8):
        mine = NeedleTailEngine(pstore, max_refills=refills, device="cpu").any_k(preds, 10_000_000)
        ref = JaxEngine(jstore, max_refills=refills).any_k(preds, 10_000_000)
        _assert_query_equal(mine, ref)
        assert mine.plan_rounds <= refills


@pytest.mark.parametrize("bad,exc", [
    (dict(predicates=[]), TypeError),
    (dict(predicates=object()), TypeError),
    (dict(algo="nope"), ValueError),
    (dict(op="xor"), ValueError),
])
def test_single_query_raises_what_this_slice_does_not_carry(bad, exc):
    (_, pstore), _ = _fixture("skewed")
    q = dict(predicates=[(0, 1)], k=5, op="and", algo="auto") | bad
    with pytest.raises(exc):
        NeedleTailEngine(pstore, device="cpu").any_k(**q)


@pytest.mark.parametrize("arg,slice_name", [
    ("tiers", "tiered-storage"), ("ledger", "tiered-storage"),
    ("calibrated_cost", "tiered-storage"), ("obs", "observability"),
])
def test_engine_arguments_of_later_slices_raise(arg, slice_name):
    """The arguments of the tiered-storage and observability slices have
    landed and are carried; an unknown argument still raises."""
    from repro_torch.core.plan_ledger import PlanLedger
    from repro_torch.obs import TraceRecorder
    from repro_torch.storage import StoreTimingBackend, make_tier_stack

    (_, pstore), _ = _fixture("skewed")
    NeedleTailEngine(pstore, device="cpu", **{arg: None if arg != "calibrated_cost" else False})
    value = {"tiers": make_tier_stack(None, None, device="cpu"), "ledger": PlanLedger(),
             "calibrated_cost": True, "obs": TraceRecorder()}[arg]
    eng = NeedleTailEngine(pstore, device="cpu", **{arg: value})
    carried = {"tiers": eng.block_cache, "ledger": eng.ledger, "calibrated_cost": True,
               "obs": eng.obs}[arg]
    assert carried is value
    if arg == "calibrated_cost":
        assert isinstance(eng.timing_backend, StoreTimingBackend)
    if slice_name == "observability":
        eng.any_k([(0, 1)], 5)
        assert [e["name"] for e in value.to_events()][-1] == "anyk.round"
    with pytest.raises(TypeError):
        NeedleTailEngine(pstore, device="cpu", no_such_argument=1)
