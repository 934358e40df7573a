"""The port's host-mirror loop against the JAX package's, on the CPU.

``any_k_batch(device=False)`` must return, per query, the reference's
``any_k_batch()`` results, and per batch its rounds, unique blocks, store
reads, cache hits and modeled store I/O; the port's device wave must equal
its host-mirror loop, and both must equal Q separate ``any_k`` calls (the
reference's per-query contract).
"""
import numpy as np
import pytest
from test_torch_engine import FIXTURES, _assert_query_equal, _fixture

from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery, new_query_state, plan_round_host

ALGOS = ("threshold", "two_prong", "auto")


def _assert_batch_equal(mine, ref):
    for m, r in zip(mine.results, ref.results):
        _assert_query_equal(m, r)
        assert m.modeled_io_s == r.modeled_io_s
    assert mine.rounds == ref.rounds
    np.testing.assert_array_equal(mine.unique_blocks_fetched, ref.unique_blocks_fetched)
    assert (mine.store_blocks_fetched, mine.cache_hits, mine.blocks_requested_total) == \
        (ref.store_blocks_fetched, ref.cache_hits, ref.blocks_requested_total)
    assert mine.modeled_store_io_s == ref.modeled_store_io_s
    assert mine.active_per_round == ref.active_per_round


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", sorted(FIXTURES) + ["underdelivery"])
def test_host_mirror_loop_equals_reference(name, algo):
    (jstore, pstore), qs = _fixture(name)
    eng, jeng = NeedleTailEngine(pstore, device="cpu"), JaxEngine(jstore)
    mqs, jqs = [BatchQuery(*q) for q in qs], [JaxQuery(*q) for q in qs]
    for _ in range(2):  # cold, then warm (cache and plan memo)
        mine = eng.any_k_batch(mqs, algo=algo, device=False)
        ref = jeng.any_k_batch(jqs, algo=algo)
        _assert_batch_equal(mine, ref)
        assert mine.device_transfers == 0
        assert len(mine.round_seconds) >= mine.rounds
    assert mine.store_blocks_fetched == 0 and mine.cache_hits > 0


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", sorted(FIXTURES) + ["underdelivery"])
def test_device_wave_equals_host_mirror_loop_and_separate_any_k(name, algo):
    (_, pstore), qs = _fixture(name)
    mqs = [BatchQuery(*q) for q in qs]
    host = NeedleTailEngine(pstore, device="cpu").any_k_batch(mqs, algo=algo, device=False)
    dev = NeedleTailEngine(pstore, device="cpu").any_k_batch(mqs, algo=algo, device=True)
    for h, d in zip(host.results, dev.results):
        _assert_query_equal(d, h)
    assert (dev.rounds, dev.store_blocks_fetched, dev.cache_hits) == \
        (host.rounds, host.store_blocks_fetched, host.cache_hits)
    np.testing.assert_array_equal(dev.unique_blocks_fetched, host.unique_blocks_fetched)
    solo = NeedleTailEngine(pstore, device="cpu")
    for (p, k, op), h in zip(qs, host.results):
        _assert_query_equal(solo.any_k(p, k, op=op, algo=algo), h)


def test_device_wave_under_a_short_budget_reads_query_by_query():
    """A budget smaller than a round's union: the wave reads through
    per-query ``get_many`` as the reference does, with its counters."""
    (jstore, pstore), qs = _fixture("uniform")
    budget = 2 * pstore.records_per_block * (pstore.dims.shape[-1] * 4
                                             + pstore.measures.shape[-1] * 4 + 1)
    mqs, jqs = [BatchQuery(*q) for q in qs], [JaxQuery(*q) for q in qs]
    for device in (True, False):
        mine = NeedleTailEngine(pstore, cache_bytes=budget, device="cpu").any_k_batch(
            mqs, algo="auto", device=device)
        ref = JaxEngine(jstore, cache_bytes=budget).any_k_batch(jqs, algo="auto", device=device)
        _assert_batch_equal(mine, ref)
        assert mine.store_blocks_fetched > mine.unique_blocks_fetched.size  # re-reads


def test_mixed_per_query_algorithms_plan_in_groups():
    (jstore, pstore), qs = _fixture("clustered")
    algos = ["threshold", "two_prong", None, "auto"]
    mqs = [BatchQuery(p, k, op, a) for (p, k, op), a in zip(qs, algos)]
    jqs = [JaxQuery(p, k, op, a) for (p, k, op), a in zip(qs, algos)]
    for device in (False, True):
        mine = NeedleTailEngine(pstore, device="cpu").any_k_batch(mqs, algo="two_prong",
                                                                  device=device)
        ref = JaxEngine(jstore).any_k_batch(jqs, algo="two_prong")
        _assert_batch_equal(mine, ref)


def test_plan_round_host_marks_exhausted_plans_done():
    (_, pstore), _ = _fixture("clustered")
    eng = NeedleTailEngine(pstore, device="cpu")
    st = new_query_state(BatchQuery([(0, 1), (1, 1), (2, 1), (3, 1)], 10_000_000))
    st.exclude = np.arange(pstore.num_blocks, dtype=np.int64)
    (blocks,) = plan_round_host(eng, [st], "threshold")
    assert blocks.size == 0 and st.done


def test_degenerate_waves_on_the_host_loop():
    (jstore, pstore), _ = _fixture("skewed")
    eng = NeedleTailEngine(pstore, device="cpu")
    batch = eng.any_k_batch([BatchQuery([(0, 1)], 0)], device=False)
    assert batch.rounds == 0 and batch.store_blocks_fetched == 0
    assert batch.results[0].algo == "auto" and batch.results[0].num_records == 0
    preds = [(0, 1), (1, 1)]
    mine = eng.any_k_batch([BatchQuery(preds, 10_000_000)], algo="threshold", device=False)
    ref = JaxEngine(jstore).any_k_batch([JaxQuery(preds, 10_000_000)], algo="threshold")
    _assert_batch_equal(mine, ref)
