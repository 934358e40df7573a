"""The port's device wave against the JAX package, end to end on the CPU.

The same numpy tables go through both packages: the index and the slabs
must be array-equal, and ``any_k_batch(device=True)`` must return, per
query, the records, measures, blocks, refill rounds and algorithm of the
reference's device wave and of its host-mirror oracle (the fields of
``tests/test_device_pipeline.py::_assert_query_equal``), on that file's
clustered, uniform and skewed stores under every planner.
"""
import numpy as np
import pytest
import torch

from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro.data import synthetic as jsyn
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro_torch.convert import store_from_reference
from repro_torch.core.cost_model import make_cost_model
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery, DeviceWave, new_query_state
from repro_torch.data import synthetic
from repro_torch.data.block_store import Table, build_block_store

ALGOS = ("threshold", "two_prong", "auto")


def _assert_query_equal(mine, ref):
    np.testing.assert_array_equal(mine.record_block, ref.record_block)
    np.testing.assert_array_equal(mine.record_row, ref.record_row)
    np.testing.assert_array_equal(mine.measures, ref.measures)
    assert mine.measures.shape == ref.measures.shape
    np.testing.assert_array_equal(np.sort(mine.blocks_fetched), np.sort(ref.blocks_fetched))
    assert mine.plan_rounds == ref.plan_rounds
    assert mine.algo == ref.algo


def _arrays(jstore) -> dict:
    return {
        "dims": np.asarray(jstore.dims), "measures": np.asarray(jstore.measures),
        "valid_rows": np.asarray(jstore.valid_rows),
        "densities": np.asarray(jstore.index.densities),
        "sorted_block_ids": np.asarray(jstore.index.sorted_block_ids),
        "sorted_densities": np.asarray(jstore.index.sorted_densities),
        "attr_offsets": jstore.index.vocab.attr_offsets,
        "attr_cards": jstore.index.vocab.attr_cards,
    }


def _pair(dims, measures, cards, rpb):
    """(JAX store, port store built from the same numpy table)."""
    jstore = jax_build_block_store(JaxTable(dims, measures, np.asarray(cards)), rpb)
    pstore = build_block_store(Table(dims, measures, np.asarray(cards)), rpb, device="cpu")
    return jstore, pstore


def _clustered():
    t = jsyn.make_clustered_table(num_records=16_000, num_dims=4, density=0.15, seed=2)
    return _pair(t.dims, t.measures, t.cards, 100), [
        ([(0, 1), (2, 1)], 300, "and"), ([(0, 1)], 50, "and"),
        ([(1, 1), (3, 1)], 200, "or"), ([(2, 0)], 10, "and"),
    ]


def _uniform():
    rng = np.random.default_rng(7)
    dims = rng.integers(0, 3, (15_000, 3)).astype(np.int32)
    meas = rng.normal(size=(15_000, 2)).astype(np.float32)
    return _pair(dims, meas, [3, 3, 3], 64), [
        ([(0, 0)], 40, "and"), ([(1, 0), (2, 2)], 80, "and"), ([(0, 0), (1, 1)], 500, "or"),
    ]


def _skewed():
    rng = np.random.default_rng(3)
    n = 8_000
    a0 = np.zeros(n, np.int32)
    a0[:500] = 1
    a1 = rng.integers(0, 2, n).astype(np.int32)
    meas = rng.normal(size=(n, 1)).astype(np.float32)
    return _pair(np.stack([a0, a1], axis=1), meas, [2, 2], 50), [
        ([(0, 1)], 400, "and"), ([(0, 1), (1, 1)], 200, "and"), ([(0, 1), (1, 0)], 100, "or"),
    ]


def _underdelivery():
    """Estimates 25x overconfident on 30 decoy blocks; the true matches hide
    in 10 low-estimate blocks, which forces multi-round refills."""
    rng = np.random.default_rng(0)
    rpb, n = 100, 4000
    a0, a1 = np.zeros(n, np.int32), np.zeros(n, np.int32)
    for b in range(30):
        a0[b * rpb: (b + 1) * rpb: 2] = 1
        a1[b * rpb + 1: (b + 1) * rpb: 2] = 1
    for b in range(30, 40):
        a0[b * rpb: b * rpb + 30] = 1
        a1[b * rpb: b * rpb + 30] = 1
    meas = rng.normal(size=(n, 1)).astype(np.float32)
    return _pair(np.stack([a0, a1], axis=1), meas, [2, 2], rpb), [
        ([(0, 1), (1, 1)], 250, "and"), ([(0, 1)], 100, "and"), ([(1, 1)], 100, "and"),
    ]


FIXTURES = {"clustered": _clustered, "uniform": _uniform, "skewed": _skewed}
_CACHE: dict = {}


def _fixture(name):
    if name not in _CACHE:
        _CACHE[name] = (FIXTURES | {"underdelivery": _underdelivery})[name]()
    return _CACHE[name]


@pytest.mark.parametrize("name", sorted(FIXTURES) + ["underdelivery"])
def test_index_and_slabs_array_equal_to_reference(name):
    (jstore, pstore), _ = _fixture(name)
    np.testing.assert_array_equal(pstore.dims.numpy(), np.asarray(jstore.dims))
    np.testing.assert_array_equal(pstore.measures.numpy(), np.asarray(jstore.measures))
    np.testing.assert_array_equal(pstore.valid_rows.numpy(), np.asarray(jstore.valid_rows))
    ji, pi = jstore.index, pstore.index
    np.testing.assert_array_equal(pi.densities.numpy(), np.asarray(ji.densities))
    np.testing.assert_array_equal(pi.sorted_block_ids.numpy(), np.asarray(ji.sorted_block_ids))
    np.testing.assert_array_equal(pi.sorted_densities.numpy(), np.asarray(ji.sorted_densities))
    np.testing.assert_array_equal(pi.vocab.attr_offsets, ji.vocab.attr_offsets)
    assert (pstore.records_per_block, pstore.num_records) == (jstore.records_per_block, jstore.num_records)


@pytest.mark.parametrize("make,kw", [
    ("make_clustered_table", dict(num_records=5000, num_dims=3, seed=4, correlated_measure=True)),
    ("make_real_like_table", dict(kind="airline", num_records=20_000, seed=1)),
    ("make_real_like_table", dict(kind="taxi", num_records=20_000, seed=1)),
], ids=["clustered", "airline", "taxi"])
def test_synthetic_generators_give_the_reference_bytes(make, kw):
    mine, ref = getattr(synthetic, make)(**kw), getattr(jsyn, make)(**kw)
    for f in ("dims", "measures", "cards"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
        assert getattr(mine, f).dtype == getattr(ref, f).dtype


@pytest.mark.parametrize("name", ["clustered", "skewed"])
def test_store_from_reference_round_trips(name):
    (jstore, pstore), _ = _fixture(name)
    conv = store_from_reference(_arrays(jstore), jstore.records_per_block, jstore.num_records,
                                device="cpu")
    for f in ("dims", "measures", "valid_rows"):
        assert torch.equal(getattr(conv, f), getattr(pstore, f))
        assert getattr(conv, f).dtype == getattr(pstore, f).dtype
    for f in ("densities", "sorted_block_ids", "sorted_densities"):
        assert torch.equal(getattr(conv.index, f), getattr(pstore.index, f))
    np.testing.assert_array_equal(conv.index.vocab.attr_cards, pstore.index.vocab.attr_cards)
    with pytest.raises(KeyError, match="missing"):
        store_from_reference({"dims": _arrays(jstore)["dims"]}, 1, 1, device="cpu")


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_any_k_batch_equals_reference_device_wave_and_host_oracle(name, algo):
    (jstore, pstore), qs = _fixture(name)
    mine = NeedleTailEngine(pstore, device="cpu").any_k_batch(
        [BatchQuery(p, k, op) for p, k, op in qs], algo=algo, device=True)
    jq = [JaxQuery(p, k, op) for p, k, op in qs]
    ref_dev = JaxEngine(jstore).any_k_batch(jq, algo=algo, device=True)
    ref_host = JaxEngine(jstore).any_k_batch(jq, algo=algo)
    for m, d, h in zip(mine.results, ref_dev.results, ref_host.results):
        _assert_query_equal(m, d)
        _assert_query_equal(m, h)
        assert m.modeled_io_s == d.modeled_io_s
    assert (mine.rounds, mine.device_transfers) == (ref_dev.rounds, ref_dev.device_transfers)
    assert max(mine.rounds, 1) <= mine.device_transfers <= mine.rounds + 1
    np.testing.assert_array_equal(mine.unique_blocks_fetched, ref_dev.unique_blocks_fetched)
    assert mine.blocks_requested_total == ref_dev.blocks_requested_total
    assert len(mine.round_seconds) >= mine.rounds


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_any_k_equals_reference_any_k(name):
    (jstore, pstore), qs = _fixture(name)
    eng, jeng = NeedleTailEngine(pstore, device="cpu"), JaxEngine(jstore, cache_bytes=0)
    for p, k, op in qs[:2]:
        for algo in ("threshold", "auto"):
            _assert_query_equal(eng.any_k(p, k, op=op, algo=algo), jeng.any_k(p, k, op=op, algo=algo))


def test_multi_round_refills_one_transfer_per_round():
    (jstore, pstore), qs = _fixture("underdelivery")
    mine = NeedleTailEngine(pstore, device="cpu").any_k_batch(
        [BatchQuery(p, k, op) for p, k, op in qs], algo="threshold")
    assert mine.rounds > 1 and mine.results[0].plan_rounds > 1
    assert max(mine.rounds, 1) <= mine.device_transfers <= mine.rounds + 1
    assert mine.active_per_round[0] == 3
    ref = JaxEngine(jstore).any_k_batch([JaxQuery(p, k, op) for p, k, op in qs],
                                        algo="threshold", device=True)
    for m, r in zip(mine.results, ref.results):
        _assert_query_equal(m, r)
    assert mine.device_transfers == ref.device_transfers


def test_degenerate_q1_wave():
    (jstore, pstore), _ = _fixture("clustered")
    mine = NeedleTailEngine(pstore, device="cpu").any_k_batch([BatchQuery([(0, 1)], 60)])
    ref = JaxEngine(jstore).any_k_batch([JaxQuery([(0, 1)], 60)], device=True)
    _assert_query_equal(mine.results[0], ref.results[0])
    assert mine.device_transfers == ref.device_transfers


def test_degenerate_lambda_zero_store():
    t = Table(dims=np.zeros((0, 2), np.int32), measures=np.zeros((0, 1), np.float32),
              cards=np.asarray([2, 2]))
    store = build_block_store(t, 16, device="cpu")
    assert store.num_blocks == 0
    batch = NeedleTailEngine(store, device="cpu").any_k_batch(
        [BatchQuery([(0, 1)], 5), BatchQuery([(1, 0)], 3)])
    assert batch.rounds == 0 and batch.unique_blocks_fetched.size == 0
    assert batch.device_transfers == 0
    assert all(r.num_records == 0 and r.measures.shape == (0, 0) for r in batch.results)


def test_degenerate_all_blocks_excluded():
    """k beyond the total valid count: plans run dry once every nonzero
    block is excluded, and the loop ends as the reference's does."""
    (jstore, pstore), _ = _fixture("clustered")
    preds = [(0, 1), (1, 1), (2, 1), (3, 1)]
    mine = NeedleTailEngine(pstore, device="cpu").any_k_batch(
        [BatchQuery(preds, 10_000_000)], algo="threshold")
    ref = JaxEngine(jstore).any_k_batch([JaxQuery(preds, 10_000_000)], algo="threshold", device=True)
    _assert_query_equal(mine.results[0], ref.results[0])
    assert mine.results[0].num_records < 10_000_000
    assert mine.device_transfers == ref.device_transfers


def test_satisfied_queries_and_k_zero_plan_nothing():
    (_, pstore), _ = _fixture("skewed")
    batch = NeedleTailEngine(pstore, device="cpu").any_k_batch([BatchQuery([(0, 1)], 0)])
    assert batch.rounds == 0 and batch.device_transfers == 0
    assert batch.results[0].algo == "auto" and batch.results[0].num_records == 0


def test_slot_joining_mid_wave_matches_a_solo_run():
    """A query that joins a running DeviceWave gets the plans it would get
    alone: rows are planned independently."""
    (_, pstore), qs = _fixture("underdelivery")
    eng = NeedleTailEngine(pstore, device="cpu")
    solo = eng.any_k_batch([BatchQuery(*qs[1])], algo="threshold").results[0]
    wave = DeviceWave(eng, 2, default_algo="threshold")
    first, late = new_query_state(BatchQuery(*qs[0])), new_query_state(BatchQuery(*qs[1]))
    wave.join(0, first)
    wave.plan_round()
    wave.join(1, late)
    active, blocks = wave.plan_round()
    assert active == [first, late]
    assert wave.transfers == 2
    np.testing.assert_array_equal(blocks[1], np.sort(solo.blocks_fetched[: blocks[1].size]))


@pytest.mark.parametrize("bad,exc", [
    (dict(predicates=[]), TypeError),
    (dict(predicates=object()), TypeError),
    (dict(algo="nope"), ValueError),
    (dict(op="xor"), ValueError),
])
def test_what_this_slice_does_not_carry_raises(bad, exc):
    (_, pstore), _ = _fixture("skewed")
    q = dict(predicates=[(0, 1)], k=5) | bad
    with pytest.raises(exc):
        NeedleTailEngine(pstore, device="cpu").any_k_batch([BatchQuery(**q)])


def test_host_mirror_loop_is_a_later_slice():
    """The host-mirror loop, left by the first slice to a later one, has
    landed: ``device=False`` runs it and returns the reference's wave."""
    (jstore, pstore), qs = _fixture("skewed")
    mine = NeedleTailEngine(pstore, device="cpu").any_k_batch(
        [BatchQuery(p, k, op) for p, k, op in qs], device=False)
    ref = JaxEngine(jstore).any_k_batch([JaxQuery(p, k, op) for p, k, op in qs])
    for m, r in zip(mine.results, ref.results):
        _assert_query_equal(m, r)
    assert (mine.rounds, mine.device_transfers) == (ref.rounds, 0)
    assert (mine.store_blocks_fetched, mine.cache_hits) == (ref.store_blocks_fetched, ref.cache_hits)


@pytest.mark.parametrize("kind", ["hdd", "ssd"])
def test_cost_presets_price_plans_as_the_reference(kind):
    from repro.core.cost_model import make_cost_model as jax_cost

    rng = np.random.default_rng(0)
    mine, ref = make_cost_model(kind), jax_cost(kind)
    for _ in range(5):
        ids = rng.integers(0, 500, rng.integers(0, 40))
        assert mine.io_time(ids) == ref.io_time(ids)
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        make_cost_model("ici")


@pytest.mark.parametrize("preds,op", [([(0, 1)], "and"), ([(0, 1), (2, 0)], "and"),
                                      ([(1, 1), (3, 0), (2, 1)], "or")])
def test_predicate_mask_matches_reference(preds, op):
    (jstore, pstore), _ = _fixture("clustered")
    ids = np.asarray([0, 5, 17, 159])
    bd = pstore.fetch(ids)[0]
    mine = pstore.predicate_mask(bd, preds, op).numpy()
    ref = np.asarray(jstore.predicate_mask(np.asarray(jstore.dims)[ids], preds, op))
    np.testing.assert_array_equal(mine, ref)
    with pytest.raises(IndexError):
        pstore.fetch([0, pstore.num_blocks])


def test_chip_smoke_path_checks_pass_on_a_small_cpu_store():
    """chip_smoke.py's path checks (record re-check, CPU-vs-device equality,
    the float64 window contract) run here on the plain versions at a small
    size, so a later slice cannot break them unseen."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    table = synthetic.make_real_like_table("airline", num_records=300_000, seed=0)
    store = build_block_store(table, cs.RPB, device="cpu")
    queries = cs.make_wave(table.cards, 16, seed=0)
    eng = NeedleTailEngine(store, device="cpu")
    batch = eng.any_k_batch(queries)
    reasons = cs.check_records(table, store, queries, batch, eng.max_refills)
    assert set(reasons) == {"full_scan_short", "max_refills"}
    cs.compare_waves(batch, eng.any_k_batch(queries))
    contract = cs.window_contract(store, queries)
    assert contract["equal"] + contract["boundary"] == len(queries)
    assert batch.device_transfers <= batch.rounds + 1
    r0 = batch.results[0]
    r0.measures = r0.measures + 1.0  # a record that no longer carries its row's measures
    with pytest.raises(AssertionError):
        cs.check_records(table, store, queries, batch, eng.max_refills)


def test_chip_smoke_host_single_and_bisect_phases_pass_on_a_small_cpu_store():
    """chip_smoke.py's host-mirror, single-query and bisect checks and its
    kernel phase run here on the plain versions at a small size (CUDA-event
    timing replaced by a call)."""
    import importlib.util
    import pathlib
    from types import SimpleNamespace

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    table = synthetic.make_real_like_table("airline", num_records=300_000, seed=0)
    store = build_block_store(table, cs.RPB, device="cpu")
    queries = cs.make_wave(table.cards, 32, seed=0)  # queries 28 and 29 refill
    batch = NeedleTailEngine(store, device="cpu").any_k_batch(queries)
    host = NeedleTailEngine(store, device="cpu").any_k_batch(queries, device=False)
    cs.compare_waves(batch, host)
    assert (host.store_blocks_fetched, host.cache_hits) == (batch.store_blocks_fetched,
                                                            batch.cache_hits)
    pick = cs.pick_single(queries, batch)
    assert len(pick) >= 8 and any(batch.results[i].plan_rounds > 1 for i in pick)
    assert {(queries[i].algo or "auto", queries[i].op) for i in pick} >= {
        ("threshold", "or"), ("two_prong", "and"), ("auto", "and"), ("auto", "or")}
    eng = NeedleTailEngine(store, device="cpu")
    singles = [eng.any_k(queries[i].predicates, queries[i].k, queries[i].op,
                         queries[i].algo or "auto") for i in pick]
    for i, r in zip(pick, singles):
        cs.compare_results(r, batch.results[i], f"query {i}")
    cs.check_records(table, store, [queries[i] for i in pick],
                     SimpleNamespace(results=singles), eng.max_refills)
    rows = cs.combined_rows(store, queries)
    bis = cs.bisect_check(rows, queries, cs.RPB)
    assert bis["equal"] == bis["bracket"] == len(queries)
    assert bis["criterion_met"] + bis["criterion_missed"] == len(queries)
    with pytest.raises(AssertionError, match="refilled"):
        cs.pick_single(queries, SimpleNamespace(results=[
            SimpleNamespace(plan_rounds=1)] * len(queries)))
    cs.time_ms = lambda fn, flush=None: (fn(), 0.0)[1]
    timing = cs.bisect_timing(rows[:4], queries[:4], cs.RPB)
    assert set(timing) == {"one_launch", "steps"}
    launches = {ph: {k: 1 for k in cs.KERNELS} for ph in cs.PHASE_KERNELS}
    rows_out = cs.kernel_phase(store, queries, batch, launches, rows)
    assert [r["name"] for r in rows_out] == [k for k in cs.KERNELS if k not in cs.LM_KERNELS]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(r) for r in rows_out)
