"""The union read's and the masks' counters on a CPU device wave of
three-predicate queries: ``wave.read``'s ``union_blocks`` and
``gather_bytes`` (the union's slabs, copied out of the block cache's pool)
and ``wave.records``' ``pair_rows`` ((query, block) pairs masked × rows a
block), their readers in ``bench/metrics/``, and a disabled recorder that
still reads no clock and keeps no event."""
import types

import numpy as np
import pytest

from bench import harness
from repro_torch.core import multi_query
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.obs import TraceRecorder

RPB = 64
CARDS = [3, 4, 5, 2]
BLOCK_BYTES = RPB * (4 * len(CARDS) + 4 * 2 + 1)  # int32 dims, two f32 measures, valid byte
# three pairs each, from a needle to most of a block's rows; the last meets no row
QUERIES = [([(0, 1), (1, 2), (3, 0)], 120, "and"), ([(2, 4), (0, 0), (1, 1)], 40, "and"),
           ([(1, 3), (2, 0), (3, 1)], 300, "and"), ([(0, 2), (2, 2), (0, 1)], 5, "and")]


def _store():
    rng = np.random.default_rng(17)
    n = 60 * RPB - 9
    dims = np.stack([rng.integers(0, c, n) for c in CARDS], axis=1).astype(np.int32)
    meas = rng.normal(100.0, 20.0, (n, 2)).astype(np.float32)
    return build_block_store(Table(dims, meas, np.asarray(CARDS)), RPB, device="cpu")


def _traced_wave(monkeypatch, obs):
    """The device wave of ``QUERIES``; returns, per round, the union's size
    and the (query, block) pairs its masks covered."""
    orig = multi_query._wave_records
    rounds: list[tuple[int, int]] = []

    def counted(slabs, union, states, blocks, obs=None):
        rounds.append((int(union.size), sum(int(b.size) for b in blocks)))
        return orig(slabs, union, states, blocks, obs)

    monkeypatch.setattr(multi_query, "_wave_records", counted)
    out = NeedleTailEngine(_store(), obs=obs, device="cpu").any_k_batch(
        [BatchQuery(*q) for q in QUERIES], device=True)
    return out, rounds


def _spans(rec, name):
    return [e for e in rec.to_events() if e["kind"] == "span" and e["name"] == name]


def test_counters_equal_the_union_and_the_pairs(monkeypatch):
    rec = TraceRecorder()
    out, rounds = _traced_wave(monkeypatch, rec)
    assert out.rounds > 1 and len(rounds) == out.rounds
    reads, records = _spans(rec, "wave.read"), _spans(rec, "wave.records")
    assert len(reads) == len(records) == len(rounds)
    for read, recs, (union, pairs) in zip(reads, records, rounds):
        assert read["attrs"] == {"union_blocks": union, "gather_bytes": union * BLOCK_BYTES}
        assert recs["attrs"]["pair_rows"] == pairs * RPB
    # every block a query read was masked once, in the round that read it
    blocks = sum(r.blocks_fetched.size for r in out.results)
    assert sum(e["attrs"]["pair_rows"] for e in records) == blocks * RPB


def test_the_readers_of_the_counters(monkeypatch):
    gather = harness.load_module("metrics", "gather_mb_per_round.sample").read
    select = harness.load_module("metrics", "select_ms.sample").read
    bare = [{"kind": "span", "name": "wave.read", "t0": 0.0, "t1": 1.0}]
    assert gather(types.SimpleNamespace(spans=bare)) is None  # a program without the counter
    assert select(types.SimpleNamespace(spans=bare, host_until=2.0)) is None
    rec = TraceRecorder()
    _, rounds = _traced_wave(monkeypatch, rec)
    run = types.SimpleNamespace(spans=rec.to_events(), host_until=float("inf"))
    assert gather(run) == pytest.approx(
        sum(u for u, _ in rounds) * BLOCK_BYTES / len(rounds) / 1e6, rel=1e-12)
    sel = _spans(rec, "records.select")
    assert select(run) == pytest.approx(
        1e3 * sum(e["t1"] - e["t0"] for e in sel) / len(rounds), rel=1e-12)


def test_a_disabled_recorder_counts_nothing(monkeypatch):
    clock = types.SimpleNamespace(calls=0)

    def tick():
        clock.calls += 1
        return 0.0

    rec = TraceRecorder(clock=tick, enabled=False)
    out, rounds = _traced_wave(monkeypatch, rec)
    assert out.rounds > 1 and rounds
    assert clock.calls == 0 and len(rec.events) == 0 and rec.to_events() == []
