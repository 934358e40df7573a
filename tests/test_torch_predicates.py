"""The port's predicate algebra against the JAX package's, on the CPU.

Every predicate case of ``tests/test_extensions.py`` runs on its taxi
fixture (30,000 records in blocks of 128, λ = 235) through both packages:
the f32 densities and the row masks must be equal, and ``any_k`` must
return the reference's records, blocks, rounds and algorithm.  Trees also
ride ``any_k_batch`` waves (the device wave and the host mirror, beside
pair lists) and the sharded waves of a world of one.
"""
import dataclasses
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_engine import _assert_query_equal

from repro.core import predicates as jp
from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro.data import synthetic as jsyn
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro_torch.core import predicates as tp
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery
from repro_torch.data.block_store import Table, build_block_store

RPB = 128
ALGOS = ("threshold", "two_prong", "auto")

# each case builds the same tree from either module: the cases of
# tests/test_extensions.py, then deeper trees and a Not at the top
CASES = {
    "eq": lambda m: m.Eq(1, 5),
    "in": lambda m: m.In(1, (0, 1, 2)),
    "range": lambda m: m.Range(2, 2, 5),
    "and_range": lambda m: m.And((m.Eq(0, 1), m.Range(1, 3, 8))),
    "or": lambda m: m.Or((m.Eq(0, 2), m.Eq(4, 3))),
    "and_not_in": lambda m: m.And((m.Not(m.Eq(0, 0)), m.In(2, (0, 7)))),
    "nested": lambda m: m.Or((m.And((m.In(3, (0, 1, 2, 3)), m.Not(m.Eq(5, 1)))),
                              m.And((m.Range(1, 0, 2), m.Eq(4, 0))))),
    "not_or": lambda m: m.Not(m.Or((m.Eq(0, 0), m.In(4, (0, 1))))),
}
_CACHE: dict = {}


def _taxi():
    if "taxi" not in _CACHE:
        t = jsyn.make_real_like_table("taxi", num_records=30_000, seed=4)
        jstore = jax_build_block_store(JaxTable(t.dims, t.measures, t.cards), RPB)
        pstore = build_block_store(Table(t.dims, t.measures, np.asarray(t.cards)), RPB,
                                   device="cpu")
        _CACHE["taxi"] = (t, jstore, pstore)
    return _CACHE["taxi"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_density_and_mask_equal_reference(case):
    t, jstore, pstore = _taxi()
    ref, mine = CASES[case](jp), CASES[case](tp)
    d_ref = np.asarray(ref.density(jstore.index), dtype=np.float32)
    d = mine.density(pstore.index)
    assert d.dtype == torch.float32 and d.shape == (pstore.num_blocks,)
    np.testing.assert_array_equal(d.numpy(), d_ref)
    np.testing.assert_array_equal(mine.mask(pstore.dims).numpy(),
                                  ref.mask(np.asarray(jstore.dims)))
    eng = NeedleTailEngine(pstore, device="cpu")
    np.testing.assert_array_equal(eng.combined_density(mine).numpy(),
                                  JaxEngine(jstore).combined_density(ref))


def test_density_of_a_leaf_is_a_copy():
    _, _, pstore = _taxi()
    before = pstore.index.densities.clone()
    tp.Eq(1, 5).density(pstore.index)[:] = 7.0
    NeedleTailEngine(pstore, device="cpu").plan(tp.Eq(1, 5), 50, exclude=np.arange(10))
    assert torch.equal(pstore.index.densities, before)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_any_k_equals_reference_and_returns_only_matches(case, algo):
    t, jstore, pstore = _taxi()
    ref, mine = CASES[case](jp), CASES[case](tp)
    n_valid = int(ref.mask(t.dims).sum())
    k = max(min(200, n_valid), 1)
    r = NeedleTailEngine(pstore, device="cpu").any_k(mine, k=k, algo=algo)
    _assert_query_equal(r, JaxEngine(jstore).any_k(ref, k=k, algo=algo))
    assert r.num_records >= min(k, n_valid)
    dims = pstore.dims.numpy()
    assert np.all(ref.mask(dims[r.record_block, r.record_row]))


def test_predicate_density_bounds():
    """In over disjoint values is exact; Not is its complement."""
    _, _, store = _taxi()
    p = tp.In(1, (3, 4))
    d = p.density(store.index).numpy()
    blk = store.dims.numpy()
    exact = np.isin(blk[..., 1], [3, 4]).sum(axis=1) / store.records_per_block
    np.testing.assert_allclose(d, exact, atol=1e-6)
    np.testing.assert_allclose(tp.Not(p).density(store.index).numpy(), 1.0 - exact, atol=1e-6)


@pytest.mark.parametrize("op", ["and", "or"])
def test_from_pairs_matches_the_pair_path(op):
    _, _, pstore = _taxi()
    eng = NeedleTailEngine(pstore, device="cpu")
    pairs = [(1, 5), (2, 3)]
    np.testing.assert_array_equal(eng.combined_density(pairs, op).numpy(),
                                  eng.combined_density(tp.from_pairs(pairs, op)).numpy())
    _assert_query_equal(eng.any_k(tp.from_pairs(pairs, op), k=50, algo="threshold"),
                        eng.any_k(pairs, k=50, op=op, algo="threshold"))
    assert tp.from_pairs([(1, 5)]) == tp.Eq(1, 5)


def _wave(m, query):
    """A mixed wave: trees of every case and pair lists, k forcing refills."""
    out = [query(CASES[c](m), k, "and", algo) for c, k, algo in
           [("nested", 300, None), ("and_not_in", 150, "threshold"),
            ("not_or", 400, "two_prong"), ("range", 80, None), ("or", 250, None)]]
    out += [query([(1, 5), (2, 3)], 60, "and", None), query([(0, 2), (4, 3)], 500, "or", None),
            query([(3, 0)], 120, "and", "threshold")]
    return out


@pytest.mark.parametrize("algo", ALGOS)
def test_trees_in_waves_equal_reference(algo):
    """Trees beside pair lists in one wave: the device wave and the host
    mirror give the reference's host-mirror results query for query, with
    its rounds and cache counters."""
    _, jstore, pstore = _taxi()
    ref = JaxEngine(jstore).any_k_batch(_wave(jp, JaxQuery), algo=algo)
    for device in (True, False):
        mine = NeedleTailEngine(pstore, device="cpu").any_k_batch(
            _wave(tp, BatchQuery), algo=algo, device=device)
        for m, r in zip(mine.results, ref.results):
            _assert_query_equal(m, r)
        assert (mine.rounds, mine.store_blocks_fetched, mine.cache_hits) == \
            (ref.rounds, ref.store_blocks_fetched, ref.cache_hits)
        np.testing.assert_array_equal(mine.unique_blocks_fetched, ref.unique_blocks_fetched)


def test_trees_in_sharded_waves_of_a_world_of_one(tmp_path):
    from repro_torch.launch.mesh import make_host_mesh

    _, jstore, pstore = _taxi()
    ref = JaxEngine(jstore).any_k_batch(_wave(jp, JaxQuery), algo="auto")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        eng = NeedleTailEngine(pstore, device="cpu")
        eng.attach_mesh(make_host_mesh(device_type="cpu"))
        for device in (True, False):
            mine = eng.any_k_batch(_wave(tp, BatchQuery), algo="auto", device=device)
            for m, r in zip(mine.results, ref.results):
                _assert_query_equal(m, r)
    finally:
        dist.destroy_process_group()


def test_chip_smoke_query_surface_phases_pass_on_a_small_cpu_store(monkeypatch):
    """chip_smoke.py's predicates, forward_optimal, aggregate, groupby and
    baselines phases at a small size on the plain versions (the CPU store
    standing in for the card's; the FORWARD-OPTIMAL bench table cut to
    8,000 records)."""
    import importlib.util
    import pathlib
    from types import SimpleNamespace

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.data import synthetic

    table = synthetic.make_real_like_table("airline", num_records=300_000, seed=0)
    store = build_block_store(table, cs.RPB, device="cpu")

    def run(name, fn):
        assert name in cs.PHASE_KERNELS
        return fn(), 0.0, {}

    queries = cs.make_tree_wave(table.cards, cs.Q, 0)
    kinds = [type(q.predicates).__name__ for q in queries]
    assert kinds.count("list") == cs.Q // 4
    assert {"Eq", "In", "And", "Or", "Not"} <= set(kinds)
    pr = cs.predicates_check(table, store, store, queries, run, device="cpu")
    assert len(pr["picked"]) >= 8 and pr["records"] > 0
    monkeypatch.setattr(cs, "FO_BENCH", dict(cs.FO_BENCH, num_records=8000))
    fo = cs.forward_optimal_check(cs.combined_rows(store, cs.make_wave(table.cards, 4, 0))[1],
                                  run, device="cpu")
    assert fo["dp_cost"] == pytest.approx(fo["scan_opt_k"], rel=1e-4)
    agg = cs.aggregate_check(store, store, [
        ("pairs", [(0, 6), (2, 3)]), ("tree", tp.And((tp.In(0, (5, 6, 7)), tp.Not(tp.Eq(3, 0)))))],
        run, 0, device="cpu")
    assert agg["tree ratio"]["bit_equal_cpu"] and agg["pairs online"]["blocks"] > 0
    gb = cs.groupby_check(table, store, store, run, device="cpu")
    assert gb["counts"] == [cs.GROUPBY["k"]] * 12
    bl, _ = cs.baselines_check(table, store, store,
                               [q for q in queries if isinstance(q.predicates, list)], run,
                               device="cpu")
    assert bl["nbytes"]["bitmap"] == 91 * -(-table.num_records // 64) * 8
    bad = SimpleNamespace(results=[dataclasses.replace(pr_r, record_row=pr_r.record_row + 1)
                                   for pr_r in NeedleTailEngine(store, device="cpu").any_k_batch(
                                       queries[:3]).results])
    with pytest.raises(AssertionError):
        cs.check_records(table, store, queries[:3], bad, 8)
