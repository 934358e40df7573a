"""The port's continuous serving loops against the reference's, on the CPU.

After ``tests/test_serving_loop.py``: slot-level join/leave on both the
host-mirror round and the device wave, byte identity to solo ``any_k`` and
to the reference's ``exemplar_tick`` run on the same stores, mid-wave
refill, the occupancy ledger, the tier prefetcher inside the loop, the
cost-fed launch gate, requeue rollback, the drained wave's occupancy, the
aggregate pool's error-SLO release (``tests/test_online_agg.py``), and the
LM join on reduced qwen1.5-4b, zamba2-7b and gemma3-12b (whose window
rings wrap), whose tokens equal the reference's ``lm_tick`` run.  Tier
stacks of both packages are built from the reference's presets
(``convert.cost_model_from_reference``), so placement decisions are priced
alike.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro.data.synthetic import make_clustered_table
from repro.serving.admission import AdmissionPolicy as JaxPolicy
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.storage import make_tier_stack as jax_make_tier_stack
from repro_torch.convert import cost_model_from_reference as conv
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.serving import AdmissionController, AdmissionPolicy, ServeEngine, SlotScheduler
from repro_torch.storage import Tier, TierStack

TOL = 2e-3  # the LM near-tie bound of tests/test_torch_serve.py


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def _underdelivery_table():
    """30 decoy blocks where A0/A1 alternate rows (estimated AND density
    0.25, actual 0) and 10 tail blocks with the real joint matches: the
    joint query under-delivers round 0 and must refill."""
    rng = np.random.default_rng(0)
    rpb = 100
    n = 40 * rpb
    a0 = np.zeros(n, np.int32)
    a1 = np.zeros(n, np.int32)
    for b in range(30):
        lo = b * rpb
        a0[lo: lo + rpb: 2] = 1
        a1[lo + 1: lo + rpb: 2] = 1
    for b in range(30, 40):
        lo = b * rpb
        a0[lo: lo + 30] = 1
        a1[lo: lo + 30] = 1
    dims = np.stack([a0, a1], axis=1)
    return dims, rng.normal(size=(n, 1)).astype(np.float32), np.asarray([2, 2]), rpb


def _clustered(n=12_000, seed=5, density=0.15):
    t = make_clustered_table(num_records=n, num_dims=4, density=density, seed=seed)
    return t.dims, t.measures, np.asarray(t.cards), 64


def _stores(dims, meas, cards, rpb):
    return (jax_build_block_store(JaxTable(dims, meas, cards), rpb),
            build_block_store(Table(dims, meas, cards), rpb, device="cpu"))


def _port_stack(j) -> TierStack:
    return TierStack([Tier(t.name, t.capacity_bytes, conv(t.cost), device=t.device)
                      for t in j.tiers], backing=conv(j.backing), device_fill=j.device_fill,
                     device="cpu")


def _servers(max_slots, clock=None, slo_s=10.0, cheap_cost_s=None, **kw):
    """Exemplar-only serving engines of both packages around one clock."""
    clk = clock or FakeClock()
    mine = ServeEngine(None, None, max_slots=max_slots, device="cpu", clock=clk,
                       exemplar_policy=AdmissionPolicy(slo_s=slo_s, max_wave=max_slots,
                                                       cheap_cost_s=cheap_cost_s), **kw)
    kw.pop("exemplar_device", None)
    ref = JaxServeEngine(None, None, max_slots=max_slots, clock=clk,
                         exemplar_policy=JaxPolicy(slo_s=slo_s, max_wave=max_slots,
                                                   cheap_cost_s=cheap_cost_s), **kw)
    return mine, ref


def _submit(mine, ref, spec):
    return ([mine.submit_exemplar_request(p, k, op) for p, k, op in spec],
            [ref.submit_exemplar_request(p, k, op) for p, k, op in spec])


def _assert_rows_equal(a, b):
    np.testing.assert_array_equal(a.record_block, b.record_block)
    np.testing.assert_array_equal(a.record_row, b.record_row)
    np.testing.assert_array_equal(a.measures, b.measures)
    assert a.plan_rounds == b.plan_rounds


def _assert_solo_identical(store, reqs):
    """Every request's rows byte-identical to a cache-less solo ``any_k``."""
    ref = NeedleTailEngine(store, cache_bytes=0, device="cpu")
    for r in reqs:
        _assert_rows_equal(r.result, ref.any_k(r.predicates, r.k, op=r.op, algo="auto"))


def _ledger(st: dict) -> dict:
    """The comparable part of a wave ledger (the port's q-error and modeled
    seconds are the same sums, compared to rounding)."""
    out = {k: v for k, v in st.items() if k not in ("modeled_store_io_s", "plan_qerror",
                                                     "device_transfers")}
    out["modeled_store_io_s"] = round(st["modeled_store_io_s"], 12)
    return out


def _tick_both(mine, ref, eng, jeng, reqs, refs, drain=True, max_ticks=64, device=False):
    ticks = 0
    while not all(r.done for r in reqs):
        done = mine.exemplar_tick(eng, drain=drain)
        jdone = ref.exemplar_tick(jeng, drain=drain)
        assert [r.rid for r in done] == [r.rid for r in jdone]
        assert _ledger(mine.last_wave_stats) == _ledger(ref.last_wave_stats)
        if device:
            assert mine.last_wave_stats["device_transfers"] == 1
        ticks += 1
        assert ticks <= max_ticks, "continuous loop did not converge"
    assert all(r.done for r in refs)
    for a, b in zip(reqs, refs):
        _assert_rows_equal(a.result, b.result)
    assert dataclasses.asdict(mine.exemplar_admission.stats) == \
        dataclasses.asdict(ref.exemplar_admission.stats)
    return ticks


# ------------------------------------------------- (a) oracle byte identity
@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_continuous_rows_byte_identical_to_solo_anyk(device):
    """A multi-round under-deliverer in a mixed wave, more requests than
    slots: every completion equals solo ``any_k`` and the reference's
    ``exemplar_tick``, tick for tick, on both plan paths (the device wave
    ships one packed transfer a tick)."""
    jstore, store = _stores(*_underdelivery_table())
    mine, ref = _servers(2, exemplar_device=device)
    spec = [([(0, 1), (1, 1)], 250, "and"), ([(0, 1)], 100, "and"),
            ([(1, 1)], 100, "and"), ([(0, 1)], 40, "and")]
    reqs, refs = _submit(mine, ref, spec)
    _tick_both(mine, ref, NeedleTailEngine(store, device="cpu"), JaxEngine(jstore), reqs, refs,
               device=device)
    _assert_solo_identical(store, reqs)
    assert reqs[0].result.plan_rounds > 1 and reqs[0].result.num_records >= 250


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_continuous_matches_solo_on_clustered(device):
    jstore, store = _stores(*_clustered())
    mine, ref = _servers(3, exemplar_device=device)
    spec = [([(0, 1), (2, 1)], 300, "and"), ([(0, 1)], 50, "and"),
            ([(1, 1), (3, 1)], 200, "or"), ([(2, 1)], 64, "and"), ([(3, 1)], 16, "and"),
            ([(0, 1)], 0, "and")]  # k = 0: satisfied at once, never seats
    reqs, refs = _submit(mine, ref, spec)
    _tick_both(mine, ref, NeedleTailEngine(store, device="cpu"), JaxEngine(jstore), reqs, refs)
    _assert_solo_identical(store, reqs)
    assert reqs[-1].result.num_records == 0 and reqs[-1].result.plan_rounds == 0


# ------------------------------------------ (b) mid-wave refill of freed slots
@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_freed_slot_reoccupied_next_round_under_pressure(device):
    """A slot freed at round r is re-seated at round r + 1 while the queue
    is non-empty (the wave stays at ``max_slots``), the pops booked as
    ``refill_waves``; a slot freed and re-seated starts from a clean row."""
    jstore, store = _stores(*_underdelivery_table())
    mine, ref = _servers(2, exemplar_device=device)
    spec = [([(0, 1), (1, 1)], 250, "and")] + [([(0, 1)], 60, "and")] * 3
    reqs, refs = _submit(mine, ref, spec)
    eng, jeng = NeedleTailEngine(store, device="cpu"), JaxEngine(jstore)
    adm = mine.exemplar_admission
    sizes = []
    while not all(r.done for r in reqs):
        backlog = adm.pending
        mine.exemplar_tick(eng, drain=True)
        ref.exemplar_tick(jeng, drain=True)
        sizes.append(mine.last_wave_stats["wave_size"])
        assert mine.last_wave_stats["wave_size"] == ref.last_wave_stats["wave_size"]
        if backlog > 0:
            assert mine.last_wave_stats["wave_size"] == 2
    assert adm.stats.refill_waves >= 1 and sizes[0] == 2
    assert reqs[0].result.plan_rounds > 1
    _assert_solo_identical(store, reqs)
    for a, b in zip(reqs, refs):
        _assert_rows_equal(a.result, b.result)


def test_slot_scheduler_occupancy_ledger():
    sched = SlotScheduler(2)
    s0 = sched.join("a")
    sched.tick()
    s1 = sched.join("b")
    sched.tick()
    assert sched.leave(s0) == "a"
    assert sched.busy == 1 and sched.free_slots() == [s0]
    assert sched.joins == 2 and sched.leaves == 1 and sched.rounds == 2
    assert sched.occupancy == pytest.approx(3 / 4)
    assert sched.join("c") == s0
    assert s1 in sched.busy_slots()
    with pytest.raises(ValueError):
        sched.join("d")
    with pytest.raises(ValueError):
        SlotScheduler(2).leave(0)


# -------------------------------------------------- (c) prefetch in the loop
@pytest.mark.parametrize("async_fetch", [False, True], ids=["sync", "async"])
def test_prefetch_overlap_in_the_loop_equals_reference(async_fetch):
    """``exemplar_prefetch=True`` on a tiered engine: each tick drains, then
    kicks the still-pending requests' memo-predicted union into tier 0
    before the demand round, outside its ``fetch_log`` window.  Rows,
    per-tick ledgers (prefetch stats and tier deltas included) and tier
    counters equal the reference's; the asynchronous mode admits the same
    blocks one tick later and gives the same rows."""
    from repro_torch.storage.prefetch import TierPrefetcher

    jstore, store = _stores(*_clustered(8_000, seed=11, density=0.2))
    jstack = jax_make_tier_stack(None, None)
    jeng, eng = JaxEngine(jstore, tiers=jstack), NeedleTailEngine(store, tiers=_port_stack(jstack),
                                                                    device="cpu")
    spec = [([(0, 1)], 32, "and"), ([(1, 1)], 64, "and"), ([(2, 1)], 48, "and"),
            ([(3, 1)], 40, "and")] * 2
    warm = [(p, k, op) for p, k, op in spec[:4]]
    jeng.any_k_batch([JaxQuery(*q) for q in warm], algo="auto")  # memo the templates
    eng.any_k_batch([BatchQuery(*q) for q in warm], algo="auto", device=False)
    jstack.clear()
    eng.block_cache.clear()
    mine, ref = _servers(2, exemplar_prefetch=True)
    if async_fetch:
        mine._prefetcher = (eng, TierPrefetcher(eng, async_fetch=True))
    reqs, refs = _submit(mine, ref, spec)
    if not async_fetch:
        _tick_both(mine, ref, eng, jeng, reqs, refs)
        assert eng.block_cache.tier_counters() == jstack.tier_counters()
        pf = mine.last_wave_stats["prefetch"]
        assert pf == ref.last_wave_stats["prefetch"] and pf["issued"] > 0 and pf["hits"] > 0
    else:
        while not all(r.done for r in reqs):
            mine.exemplar_tick(eng, drain=True)
        ref.run_continuous(jeng)
        for a, b in zip(reqs, refs):
            _assert_rows_equal(a.result, b.result)
        pf = mine._prefetcher[1]
        assert pf.stats.issued > 0 and pf.stats.fetched > 0
    _assert_solo_identical(store, reqs)


# ------------------------------------------------- (d) cost-fed launch gate
def test_cost_fed_policy_launches_cheap_wave_holds_cold_one():
    """The memoized, tier-resident request prices at ~0 and launches at
    once through ``cheap_cost_s``; the cold one holds until its deadline;
    both packages book the same launches."""
    jstore, store = _stores(*_clustered(8_000, seed=11, density=0.2))
    jstack = jax_make_tier_stack(None, None)
    jeng, eng = JaxEngine(jstore, tiers=jstack), NeedleTailEngine(store, tiers=_port_stack(jstack),
                                                                    device="cpu")
    clk = FakeClock()
    mine, ref = _servers(4, clock=clk, slo_s=5.0, cheap_cost_s=1e-4)
    jeng.any_k_batch([JaxQuery([(0, 1)], 32)], algo="auto")
    eng.any_k_batch([BatchQuery([(0, 1)], 32)], algo="auto", device=False)
    (hot,), (jhot,) = _submit(mine, ref, [([(0, 1)], 32, "and")])
    mine.exemplar_tick(eng)
    ref.exemplar_tick(jeng)
    adm = mine.exemplar_admission
    assert hot.done and jhot.done and adm.stats.cheap_waves == 1
    assert adm.stats.deadline_waves == 0
    assert adm.last_cost_price_s == ref.exemplar_admission.last_cost_price_s
    (cold,), (jcold,) = _submit(mine, ref, [([(1, 1), (3, 1)], 500, "and")])
    mine.exemplar_tick(eng)
    ref.exemplar_tick(jeng)
    assert not cold.done and adm.pending == 1
    clk.advance(5.0)
    while not cold.done:
        mine.exemplar_tick(eng)
        ref.exemplar_tick(jeng)
    assert adm.stats.deadline_waves >= 1
    assert dataclasses.asdict(adm.stats) == dataclasses.asdict(ref.exemplar_admission.stats)
    _assert_solo_identical(store, [hot, cold])
    _assert_rows_equal(cold.result, jcold.result)


def test_residency_probe_and_recalibration_are_wired_as_the_reference():
    """``exemplar_residency`` installs one residency probe per engine (a
    memoized, resident wave launches early as ``resident_waves``) and
    uninstalls it when turned off; ``recalibrate_every`` refits every N
    ticks."""
    jstore, store = _stores(*_clustered(8_000, seed=11, density=0.2))
    jstack = jax_make_tier_stack(None, None)
    jeng, eng = JaxEngine(jstore, tiers=jstack), NeedleTailEngine(store, tiers=_port_stack(jstack),
                                                                    device="cpu")
    mine, ref = _servers(4, exemplar_residency=True, recalibrate_every=2)
    jeng.any_k_batch([JaxQuery([(2, 1)], 40)], algo="auto")
    eng.any_k_batch([BatchQuery([(2, 1)], 40)], algo="auto", device=False)
    calls = []
    eng.recalibrate = lambda: calls.append(1) or {}
    reqs, refs = _submit(mine, ref, [([(2, 1)], 40, "and")])
    _tick_both(mine, ref, eng, jeng, reqs, refs, drain=False)
    assert mine.exemplar_admission.stats.resident_waves == 1
    mine.exemplar_tick(eng)
    assert len(calls) == 1
    probe = mine.exemplar_admission.residency_probe
    mine.exemplar_tick(eng)
    assert mine.exemplar_admission.residency_probe is probe  # one per engine
    mine.exemplar_residency = False
    mine.exemplar_tick(eng)
    assert mine.exemplar_admission.residency_probe is None


# ----------------------------------------------- requeue rollback, occupancy
def test_partial_requeue_rolls_back_per_request_stats():
    clk = FakeClock()
    adm = AdmissionController(AdmissionPolicy(slo_s=0.1, max_wave=3), clock=clk)
    for name in ("a", "b", "c"):
        adm.submit(name)
    clk.advance(0.2)
    wave = adm.poll()
    assert wave == ["a", "b", "c"] and adm.stats.served == 3 and adm.stats.waves == 1
    w3 = adm.stats.total_wait_s
    adm.requeue_front(wave[1:])
    assert adm.stats.served == 1 and adm.stats.waves == 1
    assert adm.stats.total_wait_s == pytest.approx(w3 / 3) and adm.pending == 2
    clk.advance(0.2)
    assert adm.poll() == ["b", "c"] and adm.stats.served == 3
    assert adm.stats.total_wait_s == pytest.approx(w3 / 3 + 2 * 0.2)
    assert adm.stats.mean_wait_s == pytest.approx(adm.stats.total_wait_s / 3)


def test_full_requeue_unwinds_the_wave():
    adm = AdmissionController(AdmissionPolicy(slo_s=0.1, max_wave=2), clock=FakeClock())
    adm.submit("a"), adm.submit("b")
    wave = adm.poll()
    assert adm.stats.waves == 1 and adm.stats.full_waves == 1
    adm.requeue_front(wave)
    assert adm.stats.served == 0 and adm.stats.waves == 0
    assert adm.stats.full_waves == 0 and adm.stats.total_wait_s == 0.0
    assert adm.poll() == ["a", "b"]


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_wave_drain_surfaces_slot_occupancy(device):
    jstore, store = _stores(*_clustered())
    mine, ref = _servers(4, exemplar_device=device)
    spec = [([(0, 1)], k, "and") for k in (300, 50, 200, 16)]
    reqs, refs = _submit(mine, ref, spec)
    assert len(mine.drain_exemplar_requests(NeedleTailEngine(store, device="cpu"))) == 4
    ref.drain_exemplar_requests(JaxEngine(jstore))
    occ = mine.last_wave_stats["slot_occupancy"]
    assert 0.0 < occ <= 1.0 and occ == ref.last_wave_stats["slot_occupancy"]
    assert mine.last_wave_stats["modeled_store_io_s"] >= 0.0
    for a, b in zip(reqs, refs):
        _assert_rows_equal(a.result, b.result)


# ------------------------------------------------- the aggregate pool
def test_error_slo_releases_slot_mid_wave():
    """Three error-SLO requests on two slots (``tests/test_online_agg.py``):
    a CI-closing request leaves its slot the same tick, the queued one
    seats mid-wave, everyone answers within its SLO, and each request's
    estimate stream equals the reference's tick for tick."""
    from repro.data.block_store import build_block_store as jbuild

    t = make_clustered_table(12_000, num_dims=4, density=0.15, seed=5,
                             correlated_measure=True)
    jeng = JaxEngine(jbuild(JaxTable(t.dims, t.measures, np.asarray(t.cards)), 64))
    eng = NeedleTailEngine(build_block_store(Table(t.dims, t.measures, np.asarray(t.cards)), 64,
                                             device="cpu"), device="cpu")
    mine = ServeEngine(None, None, max_slots=2, device="cpu", clock=FakeClock(),
                       aggregate_policy=AdmissionPolicy(slo_s=10.0, max_wave=2))
    ref = JaxServeEngine(None, None, max_slots=2, clock=FakeClock(),
                         aggregate_policy=JaxPolicy(slo_s=10.0, max_wave=2))
    slos = (15.0, 3.0, 15.0)
    reqs = [mine.submit_aggregate_request(((0, 1),), 0, 300, error_slo=slo, seed=s,
                                          chunk_blocks=8) for s, slo in enumerate(slos)]
    refs = [ref.submit_aggregate_request(((0, 1),), 0, 300, error_slo=slo, seed=s,
                                         chunk_blocks=8) for s, slo in enumerate(slos)]
    done1 = mine.aggregate_tick(eng)
    assert [r.rid for r in ref.aggregate_tick(jeng)] == [r.rid for r in done1]
    st = mine.last_wave_stats
    assert st["kind"] == "aggregate" and st["wave_size"] == 2 and st["pending"] == 1
    assert [a["rid"] for a in st["answered"]] == [a["rid"] for a in ref.last_wave_stats["answered"]]
    assert [r.rid for r in done1] == [reqs[0].rid]
    a = st["answered"][0]
    assert a["reason"] == "ci" and a["halfwidth"] <= slos[0]
    assert reqs[0].done and reqs[0].reason == "ci" and reqs[0].stream[-1] is reqs[0].result
    assert not reqs[1].done
    mine.aggregate_tick(eng)
    ref.aggregate_tick(jeng)
    assert mine.aggregate_admission.stats.refill_waves >= 1
    assert mine.aggregate_admission.pending == 0
    ticks = 0
    while not all(r.done for r in reqs):
        mine.aggregate_tick(eng, drain=True)
        ref.aggregate_tick(jeng, drain=True)
        ticks += 1
        assert ticks < 64
    assert all(r.done for r in refs)
    for r, j, slo in zip(reqs, refs, slos):
        assert r.reason == j.reason == "ci" and r.rounds == j.rounds
        assert r.result.ci_halfwidth() <= slo
        assert [dataclasses.astuple(e) for e in r.stream] == \
            [dataclasses.astuple(e) for e in j.stream]
        assert r.spent_io_s == pytest.approx(j.spent_io_s, rel=1e-12)
    assert dataclasses.asdict(mine.aggregate_admission.stats) == \
        dataclasses.asdict(ref.aggregate_admission.stats)


# ------------------------------------------------- the continuous LM pool
def _lm_pair(arch):
    from repro.configs import get_config, reduced
    from repro.models import init_params
    from repro_torch import configs as tconfigs
    from repro_torch.convert import lm_params_from_reference

    cfg = reduced(get_config(arch))
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


def _same_tokens(mine, ref) -> int:
    """Tokens equal up to a near-tie (top-2 gap within 2·TOL); returns the
    near-ties counted."""
    near = 0
    for j, (a, b) in enumerate(zip(mine.out_tokens, ref.out_tokens)):
        if a != b:
            assert mine.top2_gap[j] <= 2 * TOL, (mine.rid, j, mine.top2_gap[j])
            return near + 1
    assert len(mine.out_tokens) == len(ref.out_tokens)
    return near


# (arch, first prompt length, joiner prompt lengths, max_new, max_seq): the
# gemma3 wave starts past its reduced window of 16, so the joiners' prefill
# rings wrap and the graft crosses wrapped rings
LM_JOIN_CASES = {
    "qwen1.5-4b": (6, (6, 3), 8, 32),
    "zamba2-7b": (7, (7, 5), 8, 32),
    "gemma3-12b": (20, (20, 9), 10, 48),
}


@pytest.mark.parametrize("arch", sorted(LM_JOIN_CASES))
def test_lm_continuous_join_equals_reference_and_solo(arch):
    """A prompt joining the live LM wave mid-decode (left-padded to the
    position counter, cache rows grafted) emits the reference's
    ``lm_tick`` tokens, and a joiner whose prompt length equals ``pos``
    emits its solo wave's tokens."""
    cfg, params, tcfg, model = _lm_pair(arch)
    plen, joins, max_new, max_seq = LM_JOIN_CASES[arch]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab, n).astype(np.int32) for n in (plen, *joins)]
    mine = ServeEngine(tcfg, model, max_slots=2, max_seq=max_seq, device="cpu")
    ref = JaxServeEngine(cfg, params, max_slots=2, max_seq=max_seq)
    runs = []
    for eng in (mine, ref):
        first = eng.submit(prompts[0], max_new_tokens=max_new)
        eng.lm_tick()  # the prefill tick seats the first; pos == plen
        later = [eng.submit(p, max_new_tokens=4) for p in prompts[1:]]
        for _ in range(64):
            if first.done and all(r.done for r in later):
                break
            eng.lm_tick()
        runs.append([first, *later])
    assert all(r.done for r in runs[0])
    assert mine.lm_tick_stats[1]["joiners"] == 1  # the first joiner seated next tick
    near = sum(_same_tokens(a, b) for a, b in zip(*runs))
    assert near <= 1, near
    assert mine.last_wave_stats["kind"] == "lm" and ref.last_wave_stats["kind"] == "lm"
    solo = ServeEngine(tcfg, model, max_slots=2, max_seq=max_seq, device="cpu")
    solo.submit(prompts[1], max_new_tokens=4)
    assert _same_tokens(runs[0][1], solo.run_until_drained()[0]) == 0
    assert mine.run_continuous() == {"lm": [], "exemplar": [], "aggregate": []}


def test_serve_engine_has_every_public_method_of_the_reference():
    import inspect

    ref = {n for n, f in inspect.getmembers(JaxServeEngine, inspect.isfunction)
           if not n.startswith("_")}
    mine = {n for n, f in inspect.getmembers(ServeEngine, inspect.isfunction)
            if not n.startswith("_")}
    assert ref <= mine, ref - mine
    for name in ("AdmissionController", "AdmissionPolicy", "AdmissionStats"):
        assert name in __import__("repro_torch.serving.admission", fromlist=[name]).__dict__
