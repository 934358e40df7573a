"""The port's cooperative peer-memory tier against the JAX package's, on the CPU.

After ``tests/test_peer_tier.py``, on its fixtures and sizes (6,000 records,
R = 64): each case runs the same call sequence through the reference's peer
group and two copies of the port's (``device="cpu"``), one driven through
the host-mirror loop (``any_k_batch(device=False)``, the reference's loop)
and one through the device wave.  Records are compared exactly on both
copies; on the host-mirror copy also ``PeerGroupStats``, every stack's
counters, ``tier_counters()`` (``peer.*`` included), resident ids, the
ownership directory and the heat maps, all exactly.  The port's stacks take
the reference's cost presets (``convert.cost_model_from_reference``), so
placement is priced alike; its measured ``ici`` preset enters only the
pricing case.  Also: ``tests/test_tiering.py``'s fitted-``ici`` pricing
case, ``ServeEngine``'s recorder and tick deltas on a peer stack, and a
rehearsal of ``chip_smoke.py``'s ``peer`` phase.
"""
import datetime
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.cost_model import make_cost_model as jax_cost
from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro.storage import HeatTracker as JaxHeatTracker
from repro.storage import OwnershipRebalancer as JaxRebalancer
from repro.storage import PeerGroup as JaxPeerGroup
from repro.storage import PeerUnavailable as JaxPeerUnavailable
from repro.storage import SyntheticTimingBackend as JaxSynthetic
from repro.storage import calibrate_model as jax_calibrate
from repro.storage import make_peer_group as jax_make_peer_group
from repro.storage import make_peer_stack as jax_make_peer_stack
from repro_torch.convert import cost_model_from_reference as conv
from repro_torch.core.cost_model import ICI_BYTES_PER_S, make_cost_model
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.storage import (
    HeatTracker, OwnershipRebalancer, PeerGroup, PeerTier, PeerUnavailable,
    SyntheticTimingBackend, TierStack, calibrate_model, make_peer_group, make_peer_stack,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
RPB = 64
NB = RPB * (4 * 4 + 2 * 4 + 1)  # slab bytes of the 4-dim/2-measure tables
STAT_FIELDS = ("hits", "misses", "evictions", "invalidations", "invalidation_rereads",
               "store_fetch_calls", "store_blocks_fetched", "bytes_cached", "blocks_cached")


def _make_table(seed: int, n: int = 6_000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, (n, 4)).astype(np.int32),
            rng.normal(size=(n, 2)).astype(np.float32), np.asarray([3, 3, 3, 3]))


def _build(seed: int, n: int = 6_000):
    dims, meas, cards = _make_table(seed, n)
    return (jax_build_block_store(JaxTable(dims, meas, cards), RPB),
            build_block_store(Table(dims, meas, cards), RPB, device="cpu"))


_STORES: dict = {}


def _stores(seed: int):
    """(reference store, port store) of seed ``seed``, shared across cases."""
    if seed not in _STORES:
        _STORES[seed] = _build(seed)
    return _STORES[seed]


QUERY_POOL = [
    ([(0, 1)], 40, "and"),
    ([(0, 1), (1, 1)], 120, "and"),
    ([(1, 1), (2, 1)], 60, "or"),
    ([(2, 0)], 25, "and"),
    ([(0, 1), (2, 1), (3, 1)], 200, "and"),
]


def _assert_batch_equal(mine, ref):
    assert len(mine.results) == len(ref.results)
    for a, b in zip(mine.results, ref.results):
        np.testing.assert_array_equal(a.record_block, b.record_block)
        np.testing.assert_array_equal(a.record_row, b.record_row)
        np.testing.assert_array_equal(a.measures, b.measures)
        np.testing.assert_array_equal(a.blocks_fetched, b.blocks_fetched)


def _assert_stack_equal(mine, ref):
    assert {f: getattr(mine.stats, f) for f in STAT_FIELDS} == \
        {f: getattr(ref.stats, f) for f in STAT_FIELDS}
    assert mine.tier_counters() == ref.tier_counters()
    for mt, rt in zip(mine.tiers, ref.tiers):
        assert list(mt.block_ids()) == [int(b) for b in rt.block_ids()]
    assert mine.access_counts() == {int(b): int(c) for b, c in ref.access_counts().items()}


def _assert_slab_equal(mine, ref):
    for m, r in zip(mine[:3], ref[:3]):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))
    assert int(mine[3]) == int(ref[3])


class Cluster:
    """One call sequence through the reference's peer group (``j``) and two
    copies of the port's: ``host`` waves run the host-mirror loop, ``dev``
    waves the device wave.  ``fresh`` builds each member its own stores
    (appends mutate them); otherwise all share the seed's."""

    def __init__(self, seed: int, n_shards: int, fresh: bool = False, **kw):
        if fresh:
            self.jstore, hstore = _build(seed)
            dstore = _build(seed)[1]
        else:
            self.jstore, hstore = _stores(seed)
            dstore = hstore
        self.j = jax_make_peer_group(self.jstore, n_shards, **kw)
        self.host = make_peer_group(hstore, n_shards, device="cpu", **kw)
        self.dev = make_peer_group(dstore, n_shards, device="cpu", **kw)
        for g in (self.host, self.dev):
            for ms, rs in zip(g.stacks, self.j.stacks):
                for mt, rt in zip(ms.tiers, rs.tiers):
                    mt.cost = conv(rt.cost)
                ms.backing = conv(rs.backing)
        self.jeng = JaxEngine(self.jstore, tiers=self.j.stacks[0])
        self.heng = NeedleTailEngine(hstore, tiers=self.host.stacks[0], device="cpu")
        self.deng = NeedleTailEngine(dstore, tiers=self.dev.stacks[0], device="cpu")

    def groups(self):
        return self.j, self.host, self.dev

    def stores(self):
        return self.jeng.store, self.heng.store, self.deng.store

    def each(self, fn):
        """``fn(group, store)`` on every member; the three results."""
        return [fn(g, s) for g, s in zip(self.groups(), self.stores())]

    def union(self, spec=QUERY_POOL):
        """The flat oracle's working set of ``spec`` and its batch."""
        ref = JaxEngine(self.jeng.store).any_k_batch([JaxQuery(*q) for q in spec])
        return sorted({int(b) for r in ref.results for b in r.blocks_fetched}), ref

    def wave(self, spec=QUERY_POOL, ref=None):
        """One wave through every member, records equal on all three (and
        to ``ref``, the flat oracle's, when given)."""
        jb = self.jeng.any_k_batch([JaxQuery(*q) for q in spec])
        hb = self.heng.any_k_batch([BatchQuery(*q) for q in spec], device=False)
        db = self.deng.any_k_batch([BatchQuery(*q) for q in spec], device=True)
        for b in (hb, db):
            _assert_batch_equal(b, jb)
        if ref is not None:
            _assert_batch_equal(jb, ref)
        assert hb.tier_stats == jb.tier_stats
        return jb

    def check(self, trackers=()):
        """The host-mirror copy's state equals the reference's exactly."""
        assert self.host.stats.snapshot() == self.j.stats.snapshot()
        assert self.host.owner == {int(b): int(s) for b, s in self.j.owner.items()}
        for ms, rs in zip(self.host.stacks, self.j.stacks):
            _assert_stack_equal(ms, rs)
        for mine, ref in trackers:
            assert mine.heat == [{int(b): h for b, h in m.items()} for m in ref.heat]


# ---------------------------------------------------------------------------
# Equivalence: warm peers serve the whole wave, byte-identical, 0 store reads.
# ---------------------------------------------------------------------------
def test_warm_peer_wave_is_byte_identical_and_store_free():
    c = Cluster(0, n_shards=3)
    union, ref = c.union()
    half = len(union) // 2
    c.each(lambda g, s: g.warm(s, {1: union[:half], 2: union[half:]}))
    sf0 = [g.stacks[0].stats.store_blocks_fetched for g in c.groups()]
    c.wave(ref=ref)
    for g, s0 in zip(c.groups(), sf0):
        assert g.stacks[0].stats.store_blocks_fetched == s0
        assert g.stats.remote_fetches > 0
        counters = g.stacks[0].tier_counters()
        assert counters["peer.hits"] > 0
        assert counters["peer.remote_fetches"] == g.stats.remote_fetches
    c.check()


def test_peer_tier_is_skipped_by_placement():
    c = Cluster(1, n_shards=2, dram_bytes=3 * NB)
    _, ref = c.union()
    c.wave(ref=ref)
    for g in (c.host, c.dev):
        peer = g.stacks[0].peer_tier
        assert isinstance(peer, PeerTier)
        assert len(peer) == 0 and peer.stats.admissions == 0
        assert g.stats.remote_fetches == 0
        assert peer.stats.demotions_in == 0
    c.check()


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 3), st.integers(1, 9), st.lists(st.integers(0, 10_000), max_size=6))
def test_equivalence_under_any_ownership_schedule(seed, split_tenths, migrations):
    c = Cluster(seed, n_shards=3)
    union, ref = c.union()
    cut = len(union) * split_tenths // 10
    c.each(lambda g, s: g.warm(s, {1: union[:cut], 2: union[cut:]}))
    c.wave(ref=ref)
    for m in migrations:  # adversarial migration between waves
        b = union[m % len(union)]
        moved = c.each(lambda g, s: g.migrate(b, (g.owner_of(b) + 1) % g.n_shards))
        assert moved[1] == moved[2] == moved[0]
    c.wave(ref=ref)
    c.check()


# ---------------------------------------------------------------------------
# Failure modes: a dead peer is a miss, never a wedged wave.
# ---------------------------------------------------------------------------
def test_raising_peer_falls_through_to_store():
    c = Cluster(2, n_shards=3)
    union, ref = c.union()
    c.each(lambda g, s: g.warm(s, {1: union}))
    c.each(lambda g, s: g.fail_shard(1, mode="raise"))
    sf0 = [g.stacks[0].stats.store_blocks_fetched for g in c.groups()]
    c.wave(ref=ref)
    for g, s0 in zip(c.groups(), sf0):
        assert g.stacks[0].peer_tier.failures > 0
        assert g.stats.failed_fetches > 0
        assert g.stacks[0].stats.store_blocks_fetched > s0
    c.check()
    with pytest.raises(JaxPeerUnavailable):
        c.j.fetch_block(union[0], requester=0)
    for g in (c.host, c.dev):
        with pytest.raises(PeerUnavailable):
            g.fetch_block(union[0], requester=0)
    c.check()


def test_missing_peer_is_a_clean_miss():
    c = Cluster(3, n_shards=3)
    union, ref = c.union()
    c.each(lambda g, s: g.warm(s, {1: union}))
    c.each(lambda g, s: g.fail_shard(1, mode="miss"))
    sf0 = [g.stacks[0].stats.store_blocks_fetched for g in c.groups()]
    c.wave(ref=ref)
    for g, s0 in zip(c.groups(), sf0):
        assert g.stacks[0].peer_tier.failures == 0
        assert g.stats.remote_fetches == 0
        assert g.stacks[0].stats.store_blocks_fetched > s0
    c.check()
    c.each(lambda g, s: (g.heal_shard(1), g.stacks[0].clear()))
    c.wave(ref=ref)
    for g in c.groups():
        assert g.stats.remote_fetches > 0
    c.check()


# ---------------------------------------------------------------------------
# Append racing a peer fetch: the epoch guard aborts the in-flight read.
# ---------------------------------------------------------------------------
def _extra():
    dims, meas, cards = _make_table(99, n=40)
    return JaxTable(dims, meas, cards), Table(dims, meas, cards)


def test_append_racing_peer_fetch_aborts_in_flight_read():
    c = Cluster(7, n_shards=2, fresh=True)
    jextra, extra = _extra()
    tail = c.jstore.num_blocks - 1  # the block the append will dirty
    c.each(lambda g, s: g.warm(s, {1: [tail]}))
    for g, eng, new in zip(c.groups(), (c.jeng, c.heng, c.deng), (jextra, extra, extra)):
        fired = []

        def hook(b, eng=eng, new=new, fired=fired):
            if not fired:
                fired.append(b)
                eng.append(new)

        g.mid_fetch_hook = hook
        assert g.fetch_block(tail, requester=0) is None  # the stale copy is not served
        assert fired == [tail]
        assert g.stats.stale_aborts == 1
        assert g.locate(tail) is None  # the listener dropped the peer resident too
    c.check()


def test_append_invalidates_peer_residents_like_local_tiers():
    c = Cluster(7, n_shards=2, fresh=True)
    jextra, extra = _extra()
    union, _ = c.union(QUERY_POOL[:2])
    tail = c.jstore.num_blocks - 1
    c.each(lambda g, s: g.warm(s, {1: sorted(set(union) | {tail})}))
    for eng, new in zip((c.jeng, c.heng, c.deng), (jextra, extra, extra)):
        eng.append(new)
    survivors = [b for b in union if b != tail]
    for g in c.groups():
        assert g.locate(tail) is None
        assert all(g.locate(b) == 1 for b in survivors)
    _, ref = c.union(QUERY_POOL[:2])  # the flat oracle on the grown store
    c.wave(QUERY_POOL[:2], ref=ref)
    c.check()


# ---------------------------------------------------------------------------
# Ownership migration: heat moves blocks toward the shard that touches them.
# ---------------------------------------------------------------------------
def test_ownership_migrates_toward_hot_shard():
    c = Cluster(4, n_shards=3)
    union, ref = c.union()
    half = len(union) // 2
    c.each(lambda g, s: g.warm(s, {1: union[:half], 2: union[half:]}))
    c.wave(ref=ref)
    c.wave(ref=ref)
    rebs = [cls(g, hysteresis=1.2, min_heat=0.5)
            for cls, g in zip((JaxRebalancer, OwnershipRebalancer, OwnershipRebalancer),
                              c.groups())]
    moved = [r.rebalance() for r in rebs]
    assert moved[0] > 0 and moved == [moved[0]] * 3
    for g, r in zip(c.groups(), rebs):
        assert r.moves_applied == moved[0] and g.stats.migrations > 0
        assert all(g.owner_of(b) == 0 for b in union)
    c.check(trackers=[(rebs[1].tracker, rebs[0].tracker)])
    sf0 = [g.stacks[0].stats.store_blocks_fetched for g in c.groups()]
    rf0 = [g.stats.remote_fetches for g in c.groups()]
    c.wave(ref=ref)
    for g, s0, r0 in zip(c.groups(), sf0, rf0):
        assert g.stacks[0].stats.store_blocks_fetched == s0  # bytes moved, not re-read
        assert g.stats.remote_fetches == r0  # no cross-shard traffic left
    c.check()


def test_rebalancer_hysteresis_and_cadence():
    c = Cluster(5, n_shards=2)
    union, ref = c.union(QUERY_POOL[:2])
    c.each(lambda g, s: g.warm(s, {1: union}))
    ids = np.asarray(union, dtype=np.int64)
    c.each(lambda g, s: g.stacks[1].get_many(s, ids))  # the owner touches its blocks
    classes = (JaxRebalancer, OwnershipRebalancer, OwnershipRebalancer)
    frozen = [cls(g, hysteresis=1e9, min_heat=0.5) for cls, g in zip(classes, c.groups())]
    c.wave(QUERY_POOL[:2], ref=ref)
    assert [f.rebalance() for f in frozen] == [0, 0, 0]
    for g in c.groups():
        assert all(g.owner_of(b) == 1 for b in union)
    for _ in range(4):
        c.wave(QUERY_POOL[:2], ref=ref)
    rebs = [cls(g, hysteresis=1.2, min_heat=0.5, every=3) for cls, g in zip(classes, c.groups())]
    assert [r.tick() for r in rebs] == [0, 0, 0]
    assert [r.tick() for r in rebs] == [0, 0, 0]
    third = [r.tick() for r in rebs]
    assert third[0] > 0 and third == [third[0]] * 3
    c.check(trackers=[(frozen[1].tracker, frozen[0].tracker),
                      (rebs[1].tracker, rebs[0].tracker)])


def test_heat_tracker_decay_and_eviction_reset():
    c = Cluster(6, n_shards=2)
    trackers = [cls(g, decay=0.5) for cls, g in
                zip((JaxHeatTracker, HeatTracker, HeatTracker), c.groups())]
    ids = np.asarray([0, 1], dtype=np.int64)
    c.each(lambda g, s: g.stacks[0].get_many(s, ids))
    for t in trackers:
        t.sample()
    h0 = trackers[1].heat[0][0]
    assert h0 > 0
    for t in trackers:
        t.sample()  # no new touches: heat decays toward zero
    assert trackers[1].heat[0][0] == h0 * 0.5
    c.each(lambda g, s: g.stacks[0].clear())
    for t in trackers:
        t.sample()  # a cleared ledger clamps the delta, never negative
    assert all(h >= 0 for h in trackers[1].heat[0].values())
    c.check(trackers=[(trackers[1], trackers[0]), (trackers[2], trackers[0])])


def test_heat_tracker_invalidation_resets_heat_and_baseline():
    c = Cluster(7, n_shards=2, fresh=True)
    trackers = [cls(g, decay=0.5) for cls, g in
                zip((JaxHeatTracker, HeatTracker, HeatTracker), c.groups())]
    c.each(lambda g, s: g.stacks[0].get_many(s, np.asarray([0, 0, 0, 1], dtype=np.int64)))
    for t in trackers:
        t.sample()
    assert trackers[1].heat[0][0] == 3.0 and trackers[1]._last[0][0] == 3
    c.each(lambda g, s: s.notify_invalidated(np.asarray([0], dtype=np.int64)))
    for t in trackers:
        assert 0 not in t.heat[0] and 0 not in t._last[0]
        assert t.heat[0][1] > 0
    c.each(lambda g, s: g.stacks[0].get_many(s, np.asarray([0], dtype=np.int64)))
    for t in trackers:
        t.sample()
    assert trackers[1].heat[0][0] == 1.0  # the rewritten block starts cold
    c.check(trackers=[(trackers[1], trackers[0]), (trackers[2], trackers[0])])


# ---------------------------------------------------------------------------
# Mesh routing: remote reads answered through DistributedAnyK.fetch_remote.
# ---------------------------------------------------------------------------
def test_mesh_routes_peer_fetches_through_distributed_planner(tmp_path):
    import jax

    from repro_torch.launch.mesh import make_host_mesh

    spec = QUERY_POOL[:3]
    c = Cluster(0, n_shards=3)
    union, ref = c.union(spec)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(device_type="cpu")
        planners = [c.jeng.attach_mesh(jax.make_mesh((1,), ("data",)), peer_group=c.j),
                    c.heng.attach_mesh(mesh, peer_group=c.host),
                    c.deng.attach_mesh(mesh, peer_group=c.dev)]
        for p, g in zip(planners, c.groups()):
            assert p.peer_group is g
        assert planners[1].remote_cost.name == "ici"
        c.each(lambda g, s: g.warm(s, {1: union}))
        outs = [p.fetch_remote(union[:3], requester=0) for p in planners]
        assert sorted(outs[0]) == sorted(int(b) for b in union[:3])
        for out in outs[1:]:
            assert sorted(out) == sorted(outs[0])
            for b in out:
                _assert_slab_equal(out[b], outs[0][b])
        rf0 = [g.stats.remote_fetches for g in c.groups()]
        c.wave(spec, ref=ref)
        for g, r0 in zip(c.groups(), rf0):
            assert g.stats.remote_fetches > r0  # served through the planner
        c.check()
    finally:
        dist.destroy_process_group()
    assert c.heng.distributed.fetch_remote(union[:1]) != {}
    c.heng.distributed.peer_group = None
    assert c.heng.distributed.fetch_remote(union[:1]) == {}


# ---------------------------------------------------------------------------
# Serving: the recorder reaches the peer group, the tick delta its counters.
# ---------------------------------------------------------------------------
class CountingClock:
    def __init__(self, dt: float = 0.0005):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def _peer_events(rec) -> list:
    return [(e["name"], e["attrs"]) for e in rec.to_events() if e["name"] == "fetch.peer"]


def test_serving_engine_shares_its_recorder_with_the_peer_group():
    """``ServeEngine(obs=...)`` hands its recorder to the stack's peer
    group, which emits the reference's ``fetch.peer`` events, and each
    exemplar tick's tier delta (``last_wave_stats["tiers"]``) carries the
    ``peer.*`` counters, equal to the reference's."""
    from repro.obs import TraceRecorder as JaxRecorder
    from repro.serving.admission import AdmissionPolicy as JaxPolicy
    from repro.serving.engine import ServeEngine as JaxServeEngine
    from repro_torch.obs import TraceRecorder
    from repro_torch.serving import AdmissionPolicy, ServeEngine

    c = Cluster(0, n_shards=3)
    union, _ = c.union()
    c.each(lambda g, s: g.warm(s, {1: union}))
    jrec, rec = JaxRecorder(clock=CountingClock()), TraceRecorder(clock=CountingClock())
    jserve = JaxServeEngine(None, None, max_slots=2, exemplar_policy=JaxPolicy(max_wave=2),
                            clock=CountingClock(), obs=jrec)
    serve = ServeEngine(None, None, max_slots=2, exemplar_policy=AdmissionPolicy(max_wave=2),
                        clock=CountingClock(), obs=rec, device="cpu")
    jreqs = [jserve.submit_exemplar_request(p, k, op) for p, k, op in QUERY_POOL]
    reqs = [serve.submit_exemplar_request(p, k, op) for p, k, op in QUERY_POOL]
    ticks = 0
    while not all(r.done for r in reqs):
        jserve.step(c.jeng, drain=True)
        serve.step(c.heng, drain=True)
        assert serve.last_wave_stats["tiers"] == jserve.last_wave_stats["tiers"]
        ticks += 1
        assert ticks < 64
    assert all(r.done for r in jreqs)
    assert c.host.obs is rec and c.j.obs is jrec
    for r, j in zip(reqs, jreqs):
        np.testing.assert_array_equal(r.result.record_block, j.result.record_block)
    mine, ref = _peer_events(rec), _peer_events(jrec)
    assert mine and mine == [(n, {k: int(v) for k, v in a.items()}) for n, a in ref]
    assert c.host.stats.snapshot() == c.j.stats.snapshot()
    for ms, rs in zip(c.host.stacks, c.j.stacks):
        _assert_stack_equal(ms, rs)


# ---------------------------------------------------------------------------
# Pricing the peer hop (tests/test_tiering.py's fitted-ici case).
# ---------------------------------------------------------------------------
def test_effective_io_time_prices_peer_hop_with_fitted_ici():
    """A peer-resident block prices at the peer hop, and a model fitted from
    timings 4x slower than the ``ici`` preset overrides it through
    ``make_peer_stack(ici_cost=...)``: as the reference on its presets, and
    on the port's measured ``ici`` preset."""
    jstore, pstore = _stores(5)
    ids = np.asarray([42])

    def price(mod, store, truth, fitted_ici, device=None):
        kw = {} if device is None else {"device": device}
        group = mod[0](store, 2)
        local = mod[1](group, 0, block_bytes=NB, ici_cost=fitted_ici, **kw)
        remote = mod[1](group, 1, block_bytes=NB, **kw)
        remote.get_many(store, ids)  # shard 1 holds block 42
        peer_idx = local.tiers.index(local.peer_tier)
        assert local.residency_tier(ids)[0] == peer_idx
        return local, local.effective_io_time([42])

    truth = jax_cost("ici", 4 * NB)
    jfit = jax_calibrate(JaxSynthetic({"ici": truth}), "ici", base=jax_cost("ici", NB))
    jlocal, jgot = price((JaxPeerGroup, jax_make_peer_stack), jstore, truth, jfit)
    mine, got = price((PeerGroup, make_peer_stack), pstore, conv(truth), conv(jfit), "cpu")
    assert got == jgot == jfit.io_time([42])
    # the port's measured preset, fitted the same way
    ptruth = make_cost_model("ici", 4 * NB)
    pfit = calibrate_model(SyntheticTimingBackend({"ici": ptruth}), "ici",
                           base=make_cost_model("ici", NB))
    local, got = price((PeerGroup, make_peer_stack), pstore, ptruth, pfit, "cpu")
    assert got == pytest.approx(pfit.io_time([42]))
    assert max(got, ptruth.io_time([42])) / min(got, ptruth.io_time([42])) < 1.5
    assert got > make_cost_model("ici", NB).io_time([42])  # dearer than the preset
    assert got < local.backing.io_time([42])  # cheaper than a seek
    assert make_cost_model("ici", NB).seq_cost == NB / ICI_BYTES_PER_S


# ---------------------------------------------------------------------------
# chip_smoke.py's peer phase at a small size on the CPU.
# ---------------------------------------------------------------------------
def test_chip_smoke_peer_phase_passes_on_a_small_cpu_store():
    """chip_smoke.py's ``peer`` phase on the plain versions: a 300,000-record
    table, tier 0 cut to 8 blocks, the mesh on a gloo world of one (CUDA-event
    timing replaced by a call)."""
    from repro_torch.data import synthetic

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.paired_event_ms = lambda fa, fb: (fa(), fb(), ([0.0], [0.0]))[2]
    table = synthetic.make_real_like_table("airline", num_records=300_000, seed=0)
    store = build_block_store(table, cs.RPB, device="cpu")
    cpu_store = build_block_store(table, cs.RPB, device="cpu")
    nb = TierStack.block_nbytes(store)
    queries = cs.make_wave(table.cards, 16, seed=0)
    flat = NeedleTailEngine(store, device="cpu").any_k_batch(queries)

    def run(name, fn):
        assert name in cs.PHASE_KERNELS
        return fn(), 0.0, {}

    pe = cs.peer_check(table, store, cpu_store, queries, flat, {"cold": 0.0, "warm": 0.0},
                       run, seed=0, device="cpu", hbm_bytes=8 * nb, append_rows=20_000)
    union = int(flat.unique_blocks_fetched.size)
    assert pe["union_blocks"] == union and sum(pe["warmed"]) == union
    assert pe["served"]["store_blocks"] == 0 and pe["served"]["peer_hits"] > 0
    assert pe["raise"]["failures"] > 0 and pe["miss"]["failures"] == 0
    assert pe["race"]["stale_aborts"] >= 1
    assert pe["rebalance"]["moved"] == union and pe["rebalance"]["peer_hits"] == 0
    assert pe["mesh"]["served"] == 3
    assert set(pe["ici"]) >= {"bytes_per_s", "latency_s"}
