"""The port's observability plane against the reference's, on the CPU.

After ``tests/test_obs.py``: the ``TraceRecorder`` (nesting, ids, ring
buffer, export), a disabled recorder's zero clock reads through a whole
serving run, records identical with tracing on and off, ``anyk.round``
spans, the closed wave-stats schema across every pool, the metrics
registry, the unchanged ``tools/trace_report.py`` reading the port's
export, and fetch events with predicted and observed I/O.  One case runs
the same traced serving schedule through both packages on injected clocks
and compares the two event streams: same names, kinds, ids, parents and
non-timing attributes, in the same order, once the port's own host-step
spans (``HOST_STEP_SPANS``) are taken out of its stream.  Those spans are
checked on their own: where each sits, that each parent's children tile
it, and their copy counts against the records returned.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro.data.synthetic import make_clustered_table
from repro.obs import TraceRecorder as JaxRecorder
from repro.serving.admission import AdmissionPolicy as JaxPolicy
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.storage import make_tier_stack as jax_make_tier_stack
from repro_torch.convert import cost_model_from_reference as conv
from repro_torch.core import multi_query
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.obs import (
    HOST_STEP_SPANS, NULL_SPAN, WAVE_STATS_KEYS, MetricsRegistry, TraceRecorder,
    make_wave_stats, record_wave_metrics,
)
from repro_torch.serving import AdmissionPolicy, ServeEngine
from repro_torch.storage import Tier, TierStack

RPB = 64
NB = RPB * (4 * 4 + 2 * 4 + 1)  # slab bytes of the 4-dim/2-measure table


class CountingClock:
    def __init__(self, t: float = 0.0, dt: float = 0.001):
        self.t = t
        self.dt = dt
        self.calls = 0

    def __call__(self) -> float:
        self.calls += 1
        self.t += self.dt
        return self.t


_STORES: dict = {}


def _stores():
    """(reference store, port store) of one 6,000-record clustered table."""
    if not _STORES:
        t = make_clustered_table(num_records=6_000, num_dims=4, density=0.15, seed=11)
        _STORES["ref"] = jax_build_block_store(JaxTable(t.dims, t.measures, t.cards), RPB)
        _STORES["port"] = build_block_store(Table(t.dims, t.measures, t.cards), RPB,
                                            device="cpu")
    return _STORES["ref"], _STORES["port"]


@pytest.fixture(scope="module")
def store():
    return _stores()[1]


QUERIES = [([(0, 1)], 40, "and"), ([(0, 1), (1, 1)], 80, "and"), ([(2, 1)], 25, "and")]


def _port_stack(j) -> TierStack:
    return TierStack([Tier(t.name, t.capacity_bytes, conv(t.cost), device=t.device)
                      for t in j.tiers], backing=conv(j.backing), device_fill=j.device_fill,
                     device="cpu")


# ---------------------------------------------------------------------------
# TraceRecorder core
# ---------------------------------------------------------------------------
def test_span_nesting_and_parents():
    clk = CountingClock()
    rec = TraceRecorder(clock=clk)
    with rec.span("outer", q=1) as outer:
        rec.event("point", x=2)
        with rec.span("inner"):
            pass
        outer.set(late=3)
    events = rec.to_events()
    assert [(e["kind"], e["name"]) for e in events] == \
        [("event", "point"), ("span", "inner"), ("span", "outer")]
    point, inner, outer = events
    assert point["parent"] == inner["parent"] == outer["id"] and outer["parent"] == 0
    assert outer["attrs"] == {"q": 1, "late": 3}
    assert outer["t0"] < inner["t0"] < inner["t1"] < outer["t1"]
    assert clk.calls == 2 * 2 + 1


def test_deterministic_ids_and_ring_buffer():
    def stream(rec):
        for i in range(8):
            with rec.span("s", i=i):
                rec.event("e", i=i)
        return [(e["id"], e["name"]) for e in rec.to_events()]

    assert stream(TraceRecorder(clock=CountingClock())) == \
        stream(TraceRecorder(clock=CountingClock())) == stream(JaxRecorder(clock=CountingClock()))
    small = TraceRecorder(clock=CountingClock(), max_events=5)
    stream(small)
    assert len(small.events) == 5 and small.dropped == 16 - 5
    with pytest.raises(ValueError):
        TraceRecorder(max_events=0)


def test_export_jsonl_round_trips_and_matches_the_reference_bytes(tmp_path):
    files = []
    for cls, name in ((TraceRecorder, "port"), (JaxRecorder, "ref")):
        rec = cls(clock=CountingClock())
        with rec.span("tick"):
            rec.event("fetch", n=3)
        path = rec.export_jsonl(str(tmp_path / f"{name}.jsonl"))
        assert [json.loads(line) for line in open(path)] == rec.to_events()
        files.append(open(path).read())
    assert files[0] == files[1] and files[0].startswith('{"attrs"')


def test_disabled_recorder_is_free():
    clk = CountingClock()
    rec = TraceRecorder(clock=clk, enabled=False)
    for i in range(50):
        span = rec.span("hot", i=i)
        assert span is NULL_SPAN
        with span as s:
            assert s.set(x=1) is NULL_SPAN
            rec.event("hot.point", i=i)
    assert clk.calls == 0 and len(rec.events) == 0 and rec.dropped == 0


@pytest.mark.parametrize("device", [False, True, "chunked"], ids=["host", "device", "chunked"])
def test_disabled_recorder_through_full_serving_run(store, device, monkeypatch):
    """A disabled recorder wired through the engine, a tier stack, admission
    and both continuous pools, then ``any_k_batch``'s own loop, reads the
    clock zero times (``chunked``: the device wave with a record chunk of
    two (query, block) pairs, so every host-step span site runs many times)."""
    if device == "chunked":
        monkeypatch.setattr(multi_query, "_PAIR_CHUNK", 2)
    clk = CountingClock()
    rec = TraceRecorder(clock=clk, enabled=False)
    jstack = jax_make_tier_stack(4 * NB, None)
    eng = NeedleTailEngine(store, tiers=_port_stack(jstack), obs=rec, device="cpu")
    serve = ServeEngine(None, None, max_slots=2, exemplar_policy=AdmissionPolicy(max_wave=2),
                        exemplar_device=device, obs=rec, device="cpu")
    reqs = [serve.submit_exemplar_request(p, k, op) for p, k, op in QUERIES]
    agg = serve.submit_aggregate_request([(0, 1)], 0, 200, error_slo=0.5)
    serve.run_continuous(eng)
    assert all(r.done for r in reqs) and agg.done
    eng.any_k_batch([BatchQuery(p, k, op) for p, k, op in QUERIES], device=bool(device))
    assert clk.calls == 0 and len(rec.events) == 0


# ---------------------------------------------------------------------------
# Tracing observes, never steers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,k", [(0, 16), (7, 64), (23, 200), (41, 64)])
@pytest.mark.parametrize("device", [False, True, "chunked"], ids=["host", "device", "chunked"])
def test_any_k_batch_identical_traced(store, seed, k, device, monkeypatch):
    if device == "chunked":  # the device wave, its records in chunks of 3 pairs
        monkeypatch.setattr(multi_query, "_PAIR_CHUNK", 3)
        device = True
    dim = int(np.random.default_rng(seed).integers(0, 4))
    queries = [BatchQuery([(dim, 1)], k), BatchQuery([(0, 1), (1, 1)], k, "and")]
    plain = NeedleTailEngine(store, device="cpu").any_k_batch(queries, device=device)
    rec = TraceRecorder(clock=CountingClock())
    traced = NeedleTailEngine(store, obs=rec, device="cpu").any_k_batch(queries, device=device)
    for a, b in zip(plain.results, traced.results):
        np.testing.assert_array_equal(a.record_block, b.record_block)
        np.testing.assert_array_equal(a.record_row, b.record_row)
        np.testing.assert_array_equal(a.measures, b.measures)
    events = rec.to_events()
    names = {e["name"] for e in events}
    assert {"batch.run", "wave.execute", "plan.round"} <= names
    assert ("device.transfer" in names) == device
    by_id = {e["id"]: e["name"] for e in events if e["kind"] == "span"}
    rounds = [by_id[e["parent"]] for e in events if e["name"] == "plan.device_round"]
    assert rounds if device else not rounds
    assert set(rounds) <= {"batch.run"}


def test_anyk_round_spans_carry_plan_attrs(store):
    rec = TraceRecorder(clock=CountingClock())
    eng = NeedleTailEngine(store, obs=rec, device="cpu")
    plain = NeedleTailEngine(store, device="cpu").any_k([(0, 1)], 64, algo="auto")
    res = eng.any_k([(0, 1)], 64, algo="auto")
    np.testing.assert_array_equal(res.record_block, plain.record_block)
    rounds = [e for e in rec.to_events() if e["kind"] == "span" and e["name"] == "anyk.round"]
    assert len(rounds) == res.plan_rounds
    for e in rounds:
        a = e["attrs"]
        assert a["algo"] in ("threshold", "two_prong")
        assert a["predicted_io_s"] >= 0.0 and a["n_blocks"] >= 0
    arbs = [e for e in rec.to_events() if e["name"] == "plan.arbitration"]
    assert len(arbs) == len(rounds) and arbs[0]["parent"] == rounds[0]["id"]


# ---------------------------------------------------------------------------
# One wave-stats schema across every pool
# ---------------------------------------------------------------------------
def test_make_wave_stats_schema_is_closed():
    s = make_wave_stats("exemplar", wave_size=3)
    assert tuple(s.keys()) == WAVE_STATS_KEYS
    from repro.obs import WAVE_STATS_KEYS as JAX_KEYS
    from repro.obs import make_wave_stats as jax_make

    assert WAVE_STATS_KEYS == JAX_KEYS and s == jax_make("exemplar", wave_size=3)
    with pytest.raises(ValueError, match="unknown wave-stats"):
        make_wave_stats("exemplar", wave_sz=3)


def test_wave_stats_schema_consistent_across_pools(store):
    eng = NeedleTailEngine(store, device="cpu")
    serve = ServeEngine(None, None, max_slots=2, exemplar_policy=AdmissionPolicy(max_wave=2),
                        device="cpu")
    keys = {}
    reqs = [serve.submit_exemplar_request(p, k, op) for p, k, op in QUERIES[:2]]
    for _ in range(64):
        if all(r.done for r in reqs):
            break
        serve.exemplar_tick(eng, drain=True)
    assert all(r.done for r in reqs) and serve.last_wave_stats["kind"] == "exemplar"
    keys["exemplar"] = tuple(serve.last_wave_stats)
    agg = serve.submit_aggregate_request([(0, 1)], 0, 200, error_slo=0.5)
    for _ in range(64):
        if agg.done:
            break
        serve.aggregate_tick(eng, drain=True)
    assert agg.done and serve.last_wave_stats["kind"] == "aggregate"
    keys["aggregate"] = tuple(serve.last_wave_stats)
    serve.submit_exemplar_request([(2, 1)], 25)
    serve.drain_exemplar_requests(eng)
    keys["drained"] = tuple(serve.last_wave_stats)
    serve._note_lm_wave(2)
    assert serve.last_wave_stats["kind"] == "lm"
    keys["lm"] = tuple(serve.last_wave_stats)
    for kind, k in keys.items():
        assert k == WAVE_STATS_KEYS, kind


def test_record_wave_metrics_mirrors_ledger():
    m = MetricsRegistry()
    record_wave_metrics(m, make_wave_stats(
        "exemplar", wave_size=4, rounds=2, device_transfers=1, store_blocks_fetched=7,
        cache_hits=3, unique_blocks=9, tiers={"hbm_hits": 5}, slot_occupancy=0.5,
        plan_qerror=1.25, prefetch={"issued": 2}, pending=1))
    snap = m.snapshot()
    assert snap["counters"]["wave.exemplar.waves"] == 1
    assert snap["counters"]["wave.exemplar.store_blocks_fetched"] == 7
    assert snap["counters"]["tiers.hbm_hits"] == 5 and snap["counters"]["prefetch.issued"] == 2
    assert snap["gauges"]["wave.exemplar.slot_occupancy"] == 0.5
    assert m.quantile("wave.exemplar.wave_size", 0.5) == 4
    assert m.quantile("wave.exemplar.plan_qerror", 0.99) == 1.25


def test_metrics_registry_quantiles_and_render_equal_the_reference():
    from repro.obs import MetricsRegistry as JaxMetrics

    texts = []
    for m in (MetricsRegistry(), JaxMetrics()):
        m.inc("requests", 3)
        m.set_gauge("occupancy", 0.75)
        m.absorb("cache", {"hits": 4, "flag": True, "name": "x"})
        for v in range(1, 101):
            m.observe("wait_s", v / 1000.0)
        assert m.counter("requests") == 3 and m.counter("cache.hits") == 4
        assert m.quantile("wait_s", 0.50) == pytest.approx(0.050)
        assert m.quantile("wait_s", 0.99) == pytest.approx(0.099)
        texts.append((m.render_prometheus(), m.snapshot()))
    assert texts[0] == texts[1]
    text = texts[0][0]
    assert "requests 3" in text and "occupancy 0.75" in text
    assert "wait_s_count 100" in text and "wait_s_p99 0.099" in text
    with pytest.raises(ValueError):
        MetricsRegistry(max_samples=0)


# ---------------------------------------------------------------------------
# The offline report, and the port's stream against the reference's
# ---------------------------------------------------------------------------
def _traced_run(pkg: str, device: bool = False, tiered: bool = False):
    """One traced continuous serving run, exemplar and aggregate requests, on
    an injected clock; returns (recorder, exemplar requests, aggregate)."""
    jstore, pstore = _stores()
    clk = CountingClock(dt=0.0005)
    if pkg == "port":
        rec = TraceRecorder(clock=clk)
        stack = _port_stack(jax_make_tier_stack(4 * NB, None)) if tiered else None
        eng = NeedleTailEngine(pstore, tiers=stack, device="cpu")
        serve = ServeEngine(None, None, max_slots=2, exemplar_policy=AdmissionPolicy(max_wave=2),
                            clock=clk, obs=rec, exemplar_device=device, device="cpu")
    else:
        rec = JaxRecorder(clock=clk)
        stack = jax_make_tier_stack(4 * NB, None) if tiered else None
        eng = JaxEngine(jstore, tiers=stack)
        serve = JaxServeEngine(None, None, max_slots=2, exemplar_policy=JaxPolicy(max_wave=2),
                               clock=clk, obs=rec, exemplar_device=device)
    reqs = [serve.submit_exemplar_request(p, k, op) for p, k, op in QUERIES]
    agg = serve.submit_aggregate_request([(0, 1)], 0, 200, error_slo=0.5)
    for _ in range(64):
        if all(r.done for r in reqs) and agg.done:
            break
        serve.step(eng, drain=True)
    assert all(r.done for r in reqs) and agg.done
    return rec, reqs, agg


_TIMING = {"t", "t0", "t1"}
_TIMING_ATTRS = {"waits_s", "observed_io_s"}  # clock-derived values


def _shape(events):
    """Each event without its times; float attributes rounded to 9 digits
    (the port's modeled costs are the reference's sums in the same order)."""
    out = []
    for e in events:
        d = {k: v for k, v in e.items() if k not in _TIMING and k != "attrs"}
        attrs = {}
        for k, v in e.get("attrs", {}).items():
            if k in _TIMING_ATTRS:
                continue
            attrs[k] = round(v, 9) if isinstance(v, float) else v
        d["attrs"] = attrs
        out.append(d)
    return out


def _without_host_steps(events):
    """The port's stream less its ``HOST_STEP_SPANS``, which the reference
    does not have: each kept event's parent becomes its nearest kept
    ancestor, and the kept ids are renumbered 1, 2, ... in their order."""
    dropped = {e["id"]: e["parent"] for e in events
               if e["kind"] == "span" and e["name"] in HOST_STEP_SPANS}

    def kept(pid):
        while pid in dropped:
            pid = dropped[pid]
        return pid

    out = [e for e in events if e["id"] not in dropped]
    new = {old: i for i, old in enumerate(sorted(e["id"] for e in out), start=1)}
    new[0] = 0
    return [dict(e, id=new[e["id"]], parent=new[kept(e["parent"])]) for e in out]


@pytest.mark.parametrize("variant", ["host", "device", "tiered"])
def test_event_stream_equals_the_reference(variant):
    """The same traced serving schedule through both packages: every event
    and span has the same name, kind, id, parent and non-timing attributes,
    in the same order (the device wave's transfer size is the packed plan's
    bytes in each package's layout), once the port's host-step spans are
    taken out (:func:`_without_host_steps`)."""
    device, tiered = variant == "device", variant == "tiered"
    mine, reqs, agg = _traced_run("port", device, tiered)
    ref, jreqs, jagg = _traced_run("ref", device, tiered)
    a, b = _shape(_without_host_steps(mine.to_events())), _shape(ref.to_events())
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x["attrs"].pop("nbytes", None)
        y["attrs"].pop("nbytes", None)
        assert x == y
    for r, j in zip(reqs, jreqs):
        np.testing.assert_array_equal(r.result.record_block, j.result.record_block)
    assert [dataclasses.astuple(e) for e in agg.stream] == \
        [dataclasses.astuple(e) for e in jagg.stream]
    names = {e["name"] for e in mine.to_events()}
    assert {"request.submit", "admission.launch", "serve.exemplar_tick",
            "serve.aggregate_tick", "request.done"} <= names
    if tiered:
        assert "fetch.store" in names
    assert mine.metrics.snapshot()["counters"] == ref.metrics.snapshot()["counters"]


def test_traced_run_gives_the_untraced_records():
    rec, reqs, agg = _traced_run("port", device=True)
    _, pstore = _stores()
    eng = NeedleTailEngine(pstore, device="cpu")
    serve = ServeEngine(None, None, max_slots=2, exemplar_policy=AdmissionPolicy(max_wave=2),
                        exemplar_device=True, device="cpu")
    plain = [serve.submit_exemplar_request(p, k, op) for p, k, op in QUERIES]
    pagg = serve.submit_aggregate_request([(0, 1)], 0, 200, error_slo=0.5)
    serve.run_continuous(eng)
    for a, b in zip(reqs, plain):
        np.testing.assert_array_equal(a.result.record_block, b.result.record_block)
        np.testing.assert_array_equal(a.result.record_row, b.result.record_row)
        np.testing.assert_array_equal(a.result.measures, b.result.measures)
    assert agg.stream == pagg.stream
    assert len(rec.events) > 0


def test_trace_report_reconstructs_every_request(tmp_path):
    from tools.trace_report import load_events, render, request_paths, wave_summary

    rec, reqs, agg = _traced_run("port", device=True)
    events = load_events(rec.export_jsonl(str(tmp_path / "trace.jsonl")))
    paths = request_paths(events)
    jrec = _traced_run("ref", device=True)[0]
    ref = request_paths(load_events(jrec.export_jsonl(str(tmp_path / "ref.jsonl"))))
    # the port's host-step spans read the shared injected clock too, so only
    # the paths' non-timing fields equal the reference's
    untimed = ("kind", "reason", "ticks", "rounds")
    assert {rid: [r[f] for f in untimed] for rid, r in paths.items()} == \
        {rid: [r[f] for f in untimed] for rid, r in ref.items()}
    assert sorted(paths) == sorted([r.rid for r in reqs] + [agg.rid])
    for rid, r in paths.items():
        assert r["kind"] == ("aggregate" if rid == agg.rid else "exemplar")
        assert r["reason"] in ("full_waves", "deadline_waves", "cheap_waves", "resident_waves",
                               "refill_waves", "flush_waves")
        assert r["ticks"] >= 1 and 0.0 <= r["wait_s"] <= r["wall_s"]
        # the tick spans tile an exemplar's wall time (each clock read is one
        # step of the injected clock; an aggregate tick reads it fewer times)
        if rid != agg.rid:
            assert r["coverage"] >= 0.95
    summary = wave_summary(events)
    assert summary["spans"]["serve.exemplar_tick"]["count"] >= 1
    assert summary["launch_reasons"] and summary["device_transfers"] >= 1
    report = render(events)
    assert "requests (critical path):" in report and "serve.exemplar_tick" in report


def test_trace_report_merge_overlap():
    from tools.trace_report import _merge_overlap

    ivs = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert _merge_overlap(ivs, 0.0, 10.0) == pytest.approx(4.0)
    assert _merge_overlap(ivs, 2.5, 5.5) == pytest.approx(1.0)
    assert _merge_overlap([], 0.0, 1.0) == 0.0


def test_fetch_events_carry_predicted_vs_observed_io(store):
    """A tier stack priced only for the recorder (no ledger) emits one
    ``fetch.store`` event per miss batch; an append emits
    ``tier.invalidate``; the prefetcher's kick and drain, and a refit, are
    traced too."""
    from repro_torch.storage.prefetch import TierPrefetcher

    rec = TraceRecorder(clock=CountingClock())
    stack = _port_stack(jax_make_tier_stack(4 * NB, None))
    eng = NeedleTailEngine(store, tiers=stack, obs=rec, device="cpu")
    assert stack.obs is rec and stack.ledger is None
    queries = [BatchQuery(p, k, op) for p, k, op in QUERIES]
    eng.any_k_batch(queries, device=False)
    fetches = [e for e in rec.to_events() if e["name"] == "fetch.store"]
    assert fetches
    for e in fetches:
        a = e["attrs"]
        assert a["n"] > 0 and a["predicted_io_s"] >= 0.0 and a["observed_io_s"] >= 0.0
        assert a["level"] == stack.backing.name
    stack.clear()
    pf = TierPrefetcher(eng, async_fetch=True)
    assert pf.kick(queries) > 0 and pf.drain(wait=True) > 0
    names = [e["name"] for e in rec.to_events()]
    assert "prefetch.kick" in names and "prefetch.drain" in names
    stack.invalidate([0, 1])
    ev = rec.to_events()[-1]
    assert ev["name"] == "tier.invalidate" and ev["attrs"]["dirtied"] == 2
    from repro_torch.storage import SyntheticTimingBackend

    eng.timing_backend = SyntheticTimingBackend({eng.cost.name: eng.cost})
    eng.recalibrate()
    assert rec.to_events()[-1]["name"] == "calibration.refit"


# ---------------------------------------------------------------------------
# The port's host-step spans inside the served device-wave tick
# ---------------------------------------------------------------------------
_HOST_STEP_RUNS: dict = {}


def _host_step_run(chunk: int):
    """The traced device-wave run of :func:`_traced_run`, its records taken
    in chunks of ``chunk`` (query, block) pairs; cached per chunk.  Returns
    (recorder, exemplar requests, the (query, block) pairs of each
    ``_wave_records`` call in order)."""
    if chunk not in _HOST_STEP_RUNS:
        saved = multi_query._PAIR_CHUNK, multi_query._wave_records
        pairs: list[int] = []

        def counted(slabs, union, states, blocks, obs=None):
            pairs.append(sum(int(b.size) for b in blocks))
            return saved[1](slabs, union, states, blocks, obs)

        multi_query._PAIR_CHUNK, multi_query._wave_records = chunk, counted
        try:
            rec, reqs, _ = _traced_run("port", device=True)
        finally:
            multi_query._PAIR_CHUNK, multi_query._wave_records = saved
        _HOST_STEP_RUNS[chunk] = rec, reqs, pairs
    return _HOST_STEP_RUNS[chunk]


CHUNKS = [multi_query._PAIR_CHUNK, 2]
PARENT = {"tick.claim": "serve.exemplar_tick", "plan.device_round": "serve.exemplar_tick",
          "plan.join": "plan.device_round", "plan.device": "plan.device_round",
          "plan.choose": "plan.device_round", "wave.read": "wave.execute",
          "wave.records": "wave.execute", "records.select": "wave.records",
          "records.copy": "wave.records", "records.split": "wave.records",
          "wave.bookkeep": "wave.execute", "tick.retire": "serve.exemplar_tick"}


def test_host_step_spans_are_listed_once():
    """Each once, innermost first: a span's parent, where it is one of them,
    comes after it."""
    assert sorted(PARENT) == sorted(HOST_STEP_SPANS) and len(set(HOST_STEP_SPANS)) == 12
    order = HOST_STEP_SPANS.index
    assert all(order(PARENT[n]) > order(n) for n in PARENT if PARENT[n] in HOST_STEP_SPANS)


@pytest.mark.parametrize("name", list(PARENT))
def test_host_step_span_sits_under_its_parent(name):
    events = _host_step_run(CHUNKS[0])[0].to_events()
    by_id = {e["id"]: e for e in events if e["kind"] == "span"}
    spans = [e for e in events if e["kind"] == "span" and e["name"] == name]
    assert spans
    assert {by_id[e["parent"]]["name"] for e in spans} == {PARENT[name]}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("parent", ["serve.exemplar_tick", "plan.device_round", "wave.execute",
                                    "wave.records"])
def test_children_tile_their_parent(parent, chunk):
    """Each parent's children follow one another with no clock read between
    them: the injected clock, which admission shares, steps once from the
    parent's start to its first child, from each child's end to the next
    child's start, and from the last child's end to the parent's end."""
    events = _host_step_run(chunk)[0].to_events()
    dt = 0.0005  # _traced_run's clock step
    spans = [e for e in events if e["kind"] == "span" and e["name"] == parent]
    assert spans
    for sp in spans:
        kids = sorted((e for e in events if e["parent"] == sp["id"]),
                      key=lambda e: e.get("t0", e.get("t")))
        assert kids and all(k["kind"] == "span" for k in kids), [k["name"] for k in kids]
        reads = [sp["t0"]] + [t for k in kids for t in (k["t0"], k["t1"])] + [sp["t1"]]
        for a, b in zip(reads[0::2], reads[1::2]):
            assert b == a + dt


@pytest.mark.parametrize("chunk", CHUNKS)
def test_record_copies_count_the_records_returned(chunk):
    """Each round copies its records to the host once: a (pair, row) int64
    and the measures' 4 B each for each record, packed into one buffer.  So
    a ``wave.records`` span's ``d2h_bytes`` is (16 + 4·s) a record,
    ``d2h_copies`` is 1, and the spans' ``d2h_bytes`` and ``records`` sum to
    those of the records the answered requests hold; each span holds a
    ``records.select`` a chunk of its pairs, then one ``records.copy`` and
    one ``records.split``."""
    rec, reqs, pairs = _host_step_run(chunk)
    events = rec.to_events()
    s = _stores()[1].measures.shape[-1]
    records = sum(r.result.num_records for r in reqs)
    assert records > 0 and all(r.result.measures.shape[1] == s for r in reqs)
    recs = [e for e in events if e["kind"] == "span" and e["name"] == "wave.records"]
    assert sum(e["attrs"]["d2h_bytes"] for e in recs) == records * (16 + 4 * s)
    assert sum(e["attrs"]["records"] for e in recs) == records
    assert len(recs) == len(pairs)
    for e, n in zip(recs, pairs):
        a = e["attrs"]
        assert a["d2h_bytes"] == a["records"] * (16 + 4 * s)
        assert a["d2h_copies"] == 1
        kids = [k["name"] for k in events if k["parent"] == e["id"]]
        chunks = math.ceil(n / chunk)
        assert kids == ["records.select"] * chunks + ["records.copy", "records.split"]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_request_done_ends_the_tick_last_span(chunk):
    """Each request's one ``request.done`` event sits in ``tick.retire``, or
    in ``tick.claim`` on a tick without a round, after every other record
    of that span."""
    rec, reqs, _ = _host_step_run(chunk)
    events = rec.to_events()
    by_id = {e["id"]: e for e in events if e["kind"] == "span"}
    done = [e for e in events
            if e["name"] == "request.done" and e["attrs"]["kind"] == "exemplar"]
    assert sorted(e["attrs"]["rid"] for e in done) == sorted(r.rid for r in reqs)
    for pid in {e["parent"] for e in done}:
        assert by_id[pid]["name"] in ("tick.retire", "tick.claim")
        names = [k["name"] for k in events if k["parent"] == pid]
        first = names.index("request.done")
        assert set(names[first:]) == {"request.done"}
