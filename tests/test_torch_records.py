"""The device wave's record extraction against the reference, on the CPU.

A round's records cross to the host in one packed copy into a reused
staging buffer, then into one array a column that the round owns, whose
slices are the queries' records (``multi_query._wave_records``).  These cases hold the records of served
and ``any_k_batch`` waves to the reference's bit for bit at several record
chunks, with AND, OR, a Predicate tree and a query that finds no records
in one wave; check that a later round's reuse of the staging buffer leaves
earlier results as they were; check the results' dtypes and
``finalize_query_result``'s parts; and read the copies a round from a
traced wave as the benchmark's reader does.
"""
import types

import numpy as np
import pytest

from repro.core import predicates as jp
from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro.data.synthetic import make_clustered_table
from repro.serving.admission import AdmissionPolicy as JaxPolicy
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.core import multi_query
from repro_torch.core import predicates as tp
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery, finalize_query_result, new_query_state
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.obs import TraceRecorder
from repro_torch.serving import AdmissionPolicy, ServeEngine
from test_torch_engine import _assert_query_equal

from bench import harness

RPB = 64
CHUNKS = [multi_query._PAIR_CHUNK, 2, 3]
_STORES: dict = {}


def _stores():
    """(reference store, port store) of one 5,000-record clustered table."""
    if not _STORES:
        t = make_clustered_table(num_records=5_000, num_dims=4, density=0.2, seed=5)
        _STORES["ref"] = jax_build_block_store(JaxTable(t.dims, t.measures, t.cards), RPB)
        _STORES["port"] = build_block_store(Table(t.dims, t.measures, t.cards), RPB,
                                            device="cpu")
    return _STORES["ref"], _STORES["port"]


def _queries(m):
    """AND (its k takes two rounds), OR, a Predicate tree, and an AND no row
    meets (A0 = 1 and A0 = 0: its blocks have density, its rounds no
    records), in one wave."""
    return [([(0, 1), (1, 1)], 200, "and"), ([(2, 1), (3, 1)], 150, "or"),
            (m.Or((m.Eq(1, 1), m.And((m.Eq(2, 1), m.Not(m.Eq(3, 1)))))), 90, "and"),
            ([(0, 1), (0, 0)], 40, "and")]


def _served(pkg: str):
    jstore, pstore = _stores()
    if pkg == "port":
        eng = NeedleTailEngine(pstore, device="cpu")
        serve = ServeEngine(None, None, max_slots=4, exemplar_policy=AdmissionPolicy(max_wave=4),
                            exemplar_device=True, device="cpu")
        queries = _queries(tp)
    else:
        eng = JaxEngine(jstore)
        serve = JaxServeEngine(None, None, max_slots=4, exemplar_policy=JaxPolicy(max_wave=4),
                               exemplar_device=True)
        queries = _queries(jp)
    reqs = [serve.submit_exemplar_request(p, k, op) for p, k, op in queries]
    for _ in range(64):
        if all(r.done for r in reqs):
            break
        serve.step(eng, drain=True)
    assert all(r.done for r in reqs)
    return [r.result for r in reqs]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("path", ["served", "device_wave", "host_mirror"])
def test_wave_records_equal_reference(path, chunk, monkeypatch):
    monkeypatch.setattr(multi_query, "_PAIR_CHUNK", chunk)
    if path == "served":
        ref, mine = _served("ref"), _served("port")
    else:
        jstore, pstore = _stores()
        ref = JaxEngine(jstore).any_k_batch([JaxQuery(*q) for q in _queries(jp)]).results
        mine = NeedleTailEngine(pstore, device="cpu").any_k_batch(
            [BatchQuery(*q) for q in _queries(tp)], device=path == "device_wave").results
    assert mine[-1].num_records == 0 and mine[-1].blocks_fetched.size > 0
    assert all(r.num_records > 0 for r in mine[:-1])
    for m, r in zip(mine, ref):
        _assert_query_equal(m, r)
        assert m.measures.tobytes() == np.asarray(r.measures).tobytes()


def _staging() -> np.ndarray:
    return multi_query._STAGING.bufs["records", False].numpy()


def test_later_rounds_leave_earlier_results_as_they_were():
    """A result's arrays lie in memory its round owns: a later wave's copies
    into the staging buffer leave them as they were, and none shares memory
    with it."""
    _, pstore = _stores()
    eng = NeedleTailEngine(pstore, device="cpu")
    later = [BatchQuery([(a, 1)], 300) for a in range(4)]
    eng.any_k_batch(later, device=True)  # the staging buffer grows to the later wave's size
    buf = multi_query._STAGING.bufs["records", False].data_ptr()
    first = eng.any_k_batch([BatchQuery(*q) for q in _queries(tp)], device=True).results
    kept = [(r.record_block.copy(), r.record_row.copy(), r.measures.copy()) for r in first]
    eng.any_k_batch(later, device=True)
    assert multi_query._STAGING.bufs["records", False].data_ptr() == buf  # reused, not regrown
    for r, (blk, row, meas) in zip(first, kept):
        for arr, was in ((r.record_block, blk), (r.record_row, row), (r.measures, meas)):
            np.testing.assert_array_equal(arr, was)
            assert not np.shares_memory(arr, _staging())


def test_result_dtypes_and_shapes():
    _, pstore = _stores()
    s = pstore.measures.shape[-1]
    for device in (True, False):
        res = NeedleTailEngine(pstore, device="cpu").any_k_batch(
            [BatchQuery(*q) for q in _queries(tp)], device=device).results
        for r in res:
            assert r.record_block.dtype == np.int64 and r.record_row.dtype == np.int64
            assert r.measures.dtype == np.float32 and r.measures.shape == (r.num_records, s)


def test_finalize_returns_one_part_as_it_is_and_joins_several():
    _, pstore = _stores()
    eng = NeedleTailEngine(pstore, device="cpu")
    rng = np.random.default_rng(3)
    parts = [(rng.integers(0, 78, n), rng.integers(0, RPB, n),
              rng.random((n, 2)).astype(np.float32)) for n in (5, 0, 7)]
    for used in (parts[:1], parts):
        st = new_query_state(BatchQuery([(0, 1)], 12))
        for blk, row, meas in used:
            st.rec_blocks.append(blk)
            st.rec_rows.append(row)
            st.meas.append(meas)
            st.planned.append(np.unique(blk))
        res = finalize_query_result(eng, st)
        for got, i in ((res.record_block, 0), (res.record_row, 1), (res.measures, 2)):
            want = np.concatenate([p[i] for p in used])
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype and got.shape == want.shape
            if len(used) == 1:
                assert got is used[0][i]
    empty = finalize_query_result(eng, new_query_state(BatchQuery([(0, 1)], 0)))
    assert empty.record_block.dtype == np.int64 and empty.measures.shape == (0, 0)


def _reader():
    return harness.load_module("metrics", "d2h_copies_per_round.sample").read


def test_copies_a_round_reader():
    """``None`` where no ``wave.records`` span carries ``d2h_copies`` (the
    budget fallback's spans, or a program without the counter); 1.0 on a
    traced device wave, whatever its rounds."""
    bare = [{"kind": "span", "name": "wave.records", "attrs": {}}]
    assert _reader()(types.SimpleNamespace(spans=bare)) is None
    assert _reader()(types.SimpleNamespace(spans=[])) is None
    _, pstore = _stores()
    rec = TraceRecorder()
    out = NeedleTailEngine(pstore, obs=rec, device="cpu").any_k_batch(
        [BatchQuery(*q) for q in _queries(tp)], device=True)
    spans = rec.to_events()
    assert out.rounds > 1
    assert sum(e["name"] == "wave.records" for e in spans) == out.rounds
    assert _reader()(types.SimpleNamespace(spans=spans)) == 1.0
