"""The port's SLO admission against the reference's, on the CPU.

After ``tests/test_admission.py``: each controller case runs the same
request schedule through both packages' ``AdmissionController`` on one fake
clock and compares the waves popped and every ``AdmissionStats`` field; the
``ServeEngine`` cases drive real batched any-k waves of the 12,000-record
clustered store through both engines (the port on ``device="cpu"``) and
compare records, wave sizes and admission stats.
"""
import dataclasses
import itertools
from collections import deque

import numpy as np
import pytest

from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro.data.synthetic import make_clustered_table
from repro.serving.admission import AdmissionController as JaxController
from repro.serving.admission import AdmissionPolicy as JaxPolicy
from repro.serving.engine import ExemplarRequest as JaxExemplarRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.serving import (
    AdmissionController, AdmissionPolicy, AdmissionStats, ExemplarRequest, ServeEngine,
)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class Both:
    """The port's and the reference's controller under one policy and clock;
    every call goes to both and must give the same answer."""

    def __init__(self, clk: FakeClock, **policy):
        self.clk = clk
        self.mine = AdmissionController(AdmissionPolicy(**policy), clock=clk)
        self.ref = JaxController(JaxPolicy(**policy), clock=clk)

    def __getattr__(self, name):
        def call(*args, **kwargs):
            a = getattr(self.mine, name)(*args, **kwargs)
            b = getattr(self.ref, name)(*args, **kwargs)
            assert a == b, (name, a, b)
            self.check()
            return a
        return call

    @property
    def pending(self) -> int:
        assert self.mine.pending == self.ref.pending
        return self.mine.pending

    @property
    def stats(self) -> AdmissionStats:
        self.check()
        return self.mine.stats

    def check(self) -> None:
        assert dataclasses.asdict(self.mine.stats) == dataclasses.asdict(self.ref.stats)
        assert self.mine.stats.mean_wait_s == self.ref.stats.mean_wait_s
        assert self.mine.stats.mean_wave_size == self.ref.stats.mean_wave_size
        assert self.mine.next_deadline() == self.ref.next_deadline()


def test_full_wave_launches_immediately():
    adm = Both(FakeClock(), slo_s=10.0, max_wave=4)
    for i in range(4):
        adm.submit(i)
    assert adm.poll() == [0, 1, 2, 3]
    s = adm.stats
    assert s.full_waves == 1 and s.deadline_waves == 0
    assert s.max_wait_s == 0.0 and s.slo_violations == 0
    assert adm.pending == 0


def test_underfilled_wave_accumulates_until_slo_deadline():
    clk = FakeClock()
    adm = Both(clk, slo_s=0.5, max_wave=8)
    adm.submit("a")
    clk.advance(0.2)
    adm.submit("b")
    assert adm.poll() is None
    clk.advance(0.25)
    assert adm.poll() is None
    clk.advance(0.05)
    assert adm.poll() == ["a", "b"]
    assert adm.stats.deadline_waves == 1 and adm.stats.slo_violations == 0
    assert adm.stats.max_wait_s <= 0.5 + 1e-9


def test_waves_never_exceed_max_size():
    clk = FakeClock()
    adm = Both(clk, slo_s=1.0, max_wave=4)
    for i in range(11):
        adm.submit(i)
    waves = adm.drain_ready()
    assert [len(w) for w in waves] == [4, 4] and adm.pending == 3
    clk.advance(2.0)
    waves += adm.drain_ready()
    assert [len(w) for w in waves] == [4, 4, 3]
    assert list(itertools.chain(*waves)) == list(range(11))
    assert adm.stats.max_wave_size == 4


def test_min_wave_floor_defers_to_deadline_only_when_met():
    clk = FakeClock()
    adm = Both(clk, slo_s=0.1, max_wave=8, min_wave=2)
    adm.submit("x")
    clk.advance(0.5)
    assert adm.poll() is None
    adm.submit("y")
    assert adm.poll() == ["x", "y"]
    adm.submit("z")
    assert adm.flush() == [["z"]]


def test_requeue_front_preserves_fifo():
    clk = FakeClock()
    adm = Both(clk, slo_s=1.0, max_wave=3)
    for i in range(5):
        adm.submit(i)
    wave = adm.poll()
    assert wave == [0, 1, 2]
    adm.requeue_front(wave)
    clk.advance(2.0)
    assert adm.flush() == [[0, 1, 2], [3, 4]]


def test_no_starvation_under_continuous_seeded_load():
    """The reference's event-driven simulation (bursts, then a sparse
    tail): every request served in order within its SLO, and the port's
    waves and stats equal the reference's at every event."""
    rng = np.random.default_rng(7)
    clk = FakeClock()
    adm = Both(clk, slo_s=0.05, max_wave=4)
    served: list[int] = []
    gaps = np.concatenate([rng.exponential(0.004, 400), rng.exponential(0.1, 40)])
    arrivals = deque((float(t), i) for i, t in enumerate(np.cumsum(gaps)))
    n_total = len(arrivals)
    while arrivals or adm.pending:
        t_arr = arrivals[0][0] if arrivals else float("inf")
        t_due = adm.next_deadline()
        t_due = float("inf") if t_due is None else t_due
        if t_arr <= t_due:
            clk.t = t_arr
            adm.submit(arrivals.popleft()[1])
        else:
            clk.t = t_due
        for wave in adm.drain_ready():
            assert len(wave) <= 4
            served.extend(wave)
    assert served == list(range(n_total))
    s = adm.stats
    assert s.slo_violations == 0 and s.max_wait_s <= 0.05 + 1e-9
    assert s.full_waves > 0 and s.deadline_waves > 0


def test_claim_sizes_to_free_slots_and_books_its_reason():
    """``claim``: mid-wave pops book under ``refill_waves``, forced ones
    under ``flush_waves``, idle ones under the launch policy; the probes
    decide the cheap and resident launches; ``peek_pending`` pops nothing."""
    clk = FakeClock()
    adm = Both(clk, slo_s=1.0, max_wave=4, cheap_cost_s=0.5)
    for i in range(7):
        adm.submit(i)
    assert adm.peek_pending(2) == [0, 1] and adm.peek_pending() == list(range(7))
    assert adm.claim(2, mid_wave=True) == [0, 1]
    assert adm.claim(9, force=True) == [2, 3, 4, 5]
    assert adm.claim(2) == []  # one pending, no deadline, no probe
    prices = iter([0.7, 0.7, 0.2, 0.2])
    adm.mine.cost_probe = adm.ref.cost_probe = lambda reqs: next(prices)
    assert adm.claim(2) == []  # 0.7 > cheap_cost_s
    assert adm.mine.last_cost_price_s == adm.ref.last_cost_price_s == 0.7
    assert adm.claim(2) == [6]  # 0.2: cheap
    adm.submit(7)
    adm.mine.cost_probe = adm.ref.cost_probe = None
    adm.mine.residency_probe = adm.ref.residency_probe = lambda reqs: True
    assert adm.poll() == [7]
    s = adm.stats
    assert (s.refill_waves, s.flush_waves, s.cheap_waves, s.resident_waves) == (1, 1, 1, 1)
    assert adm.claim(0) == [] and adm.flush_one() is None


def test_policy_and_controller_arguments_are_checked():
    for bad in (dict(slo_s=-1), dict(max_wave=0), dict(min_wave=3, max_wave=2),
                dict(cheap_cost_s=-0.1)):
        with pytest.raises(ValueError):
            AdmissionPolicy(**bad)
        with pytest.raises(ValueError):
            JaxPolicy(**bad)
    assert AdmissionPolicy() == AdmissionPolicy(slo_s=0.05, max_wave=8, min_wave=1)


# ---------------------------------------------------------------------------
# ServeEngine: real batched any-k waves under a fake clock, both packages.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    t = make_clustered_table(num_records=12_000, num_dims=4, density=0.15, seed=5)
    ref = jax_build_block_store(JaxTable(t.dims, t.measures, t.cards), 64)
    mine = build_block_store(Table(t.dims, t.measures, t.cards), 64, device="cpu")
    return JaxEngine(ref), NeedleTailEngine(mine, device="cpu")


def _servers(clk, **policy):
    mine = ServeEngine(None, None, max_slots=policy["max_wave"], device="cpu",
                       exemplar_policy=AdmissionPolicy(**policy), clock=clk)
    ref = JaxServeEngine(None, None, max_slots=policy["max_wave"],
                         exemplar_policy=JaxPolicy(**policy), clock=clk)
    return mine, ref


def _assert_same_records(mine, ref):
    for a, b in zip(mine, ref):
        assert a.rid == b.rid and a.done and b.done
        np.testing.assert_array_equal(a.result.record_block, b.result.record_block)
        np.testing.assert_array_equal(a.result.record_row, b.result.record_row)
        np.testing.assert_array_equal(a.result.measures, b.result.measures)
        assert a.result.plan_rounds == b.result.plan_rounds


def _stats(serve):
    return dataclasses.asdict(serve.exemplar_admission.stats)


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_pump_launches_only_ready_waves(engines, device):
    jeng, eng = engines
    clk = FakeClock()
    mine, ref = _servers(clk, slo_s=0.1, max_wave=4)
    mine.exemplar_device = device
    reqs = [mine.submit_exemplar_request([(0, 1)], 30) for _ in range(6)]
    refs = [ref.submit_exemplar_request([(0, 1)], 30) for _ in range(6)]
    done = mine.pump_exemplar_requests(eng)
    assert [r.rid for r in done] == [r.rid for r in ref.pump_exemplar_requests(jeng)]
    assert [r.rid for r in done] == [r.rid for r in reqs[:4]]
    assert not reqs[4].done and not reqs[5].done
    clk.advance(0.2)
    done2 = mine.pump_exemplar_requests(eng)
    assert [r.rid for r in done2] == [r.rid for r in ref.pump_exemplar_requests(jeng)]
    assert [r.rid for r in done2] == [r.rid for r in reqs[4:]]
    _assert_same_records(reqs, refs)
    solo = eng.any_k([(0, 1)], 30, algo="auto")
    for r in reqs:
        np.testing.assert_array_equal(r.result.record_block, solo.record_block)
    assert _stats(mine) == _stats(ref)
    st = mine.last_wave_stats
    if device:
        assert st["rounds"] <= st["device_transfers"] <= st["rounds"] + 1
    else:
        assert st["device_transfers"] == 0


def test_drain_is_a_flush_barrier(engines):
    jeng, eng = engines
    mine, ref = _servers(FakeClock(), slo_s=100.0, max_wave=4)
    reqs = [mine.submit_exemplar_request([(1, 1)], 20) for _ in range(7)]
    refs = [ref.submit_exemplar_request([(1, 1)], 20) for _ in range(7)]
    assert len(mine.pump_exemplar_requests(eng)) == len(ref.pump_exemplar_requests(jeng)) == 4
    assert mine.exemplar_admission.pending == 3
    done = mine.drain_exemplar_requests(eng)
    assert len(done) == len(ref.drain_exemplar_requests(jeng)) == 3
    assert all(r.done for r in reqs)
    _assert_same_records(reqs, refs)
    assert _stats(mine) == _stats(ref)
    assert mine.exemplar_admission.stats.max_wave_size <= 4


def test_failed_wave_is_requeued_not_lost(engines):
    jeng, eng = engines
    mine, ref = _servers(FakeClock(), slo_s=0.0, max_wave=3)

    class Boom:
        def any_k_batch(self, queries, algo="auto", **kw):
            raise RuntimeError("engine down")

    reqs = [mine.submit_exemplar_request([(0, 1)], 10) for _ in range(7)]
    refs = [ref.submit_exemplar_request([(0, 1)], 10) for _ in range(7)]
    for serve in (mine, ref):
        with pytest.raises(RuntimeError):
            serve.drain_exemplar_requests(Boom())
    adm = mine.exemplar_admission
    assert adm.pending == 7 and adm.stats.served == 0 and adm.stats.waves == 0
    assert _stats(mine) == _stats(ref)
    done = mine.drain_exemplar_requests(eng)
    ref.drain_exemplar_requests(jeng)
    assert [r.rid for r in done] == [r.rid for r in reqs] and all(r.done for r in reqs)
    assert adm.stats.served == 7 and adm.stats.waves == 3
    assert _stats(mine) == _stats(ref)
    _assert_same_records(reqs, refs)


def test_legacy_queue_intake_migrates_into_controller(engines):
    jeng, eng = engines
    mine, ref = _servers(FakeClock(), slo_s=0.01, max_wave=2)
    mine.exemplar_queue.append(ExemplarRequest(99, [(0, 1)], 15))
    ref.exemplar_queue.append(JaxExemplarRequest(99, [(0, 1)], 15))
    done = mine.drain_exemplar_requests(eng)
    assert len(done) == 1 and done[0].rid == 99 and done[0].result.num_records >= 15
    _assert_same_records(done, ref.drain_exemplar_requests(jeng))


def test_serve_engine_runs_on_the_engines_device_only(engines):
    jeng, eng = engines
    serve = ServeEngine(None, None, device="cpu")
    with pytest.raises(ValueError, match="the any-k engine lies on"):
        serve.exemplar_tick(type("E", (), {"device": "cuda"})())
    with pytest.raises(ValueError, match="both cfg and model"):
        ServeEngine(None, object(), device="cpu")
    assert ServeEngine.select_exemplars(eng, [(0, 1)], 12).num_records >= 12
