"""Cooperative peer-memory tier: the cluster's host memory as one block cache.

Counterpart of ``repro/storage/peer.py``.  A :class:`PeerTier` slots into a
shard's :class:`~repro_torch.storage.tiers.TierStack` *below* the local host
tier and answers residency and gather requests from the OTHER shards'
resident host slots, priced by the ``ici`` preset:

    slot pool on the card  →  pinned host pool  →  peer host pool  →  store

A :class:`PeerGroup` is the in-process simulation of the cluster, as in the
reference: one ``TierStack`` per shard over ONE shared ``BlockStore``, plus
the **ownership directory** (``block id → owning shard``) that
:mod:`repro_torch.storage.rebalance` migrates toward the shards that touch
each block.  Every stack lives on the store's device; each shard's host tier
is a pinned host pool when that device is a card.

Design contract (the reference's)
---------------------------------
* A :class:`PeerTier` owns **no local bytes**: ``capacity_bytes`` is 0, it
  never admits, never yields a victim and is skipped by every placement
  cascade.  It is a *view*: ``__contains__`` asks the group's directory,
  ``host_view`` copies the holder's slot rows.  The requesting stack stages
  every row a call copied this way into one host buffer that crosses to the
  card in one copy per tensor.  Placement changes the medium, never the
  bytes.
* **Failure fall-through**: a peer that raises (:class:`PeerUnavailable`)
  or is marked down makes the block a plain miss; the stack falls through to
  the backing store.
* **Append invalidation**: every shard's stack registers the store's
  invalidation listener, and the group stamps every block with an epoch: a
  remote read in flight across an append is aborted (``stale_aborts``) and
  the requester re-reads the store.
* **No promotion out of the peer tier**: a hot remote block is not copied
  into the local stack on a hit; the
  :class:`~repro_torch.storage.rebalance.OwnershipRebalancer` migrates its
  *ownership*, the one resident copy, toward the hottest shard.

With a mesh attached, remote requests route through
:meth:`repro_torch.core.sharded.DistributedAnyK.fetch_remote`
(:meth:`PeerTier.route_through`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import TYPE_CHECKING, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel, make_cost_model
from repro_torch.storage.policy import PlacementPolicy
from repro_torch.storage.tiers import Tier, TierStack

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.data.block_store import BlockStore


class PeerUnavailable(RuntimeError):
    """A remote shard did not answer a block fetch (simulated peer death)."""


@dataclasses.dataclass
class PeerGroupStats:
    """Cluster-wide counters (monotonic)."""

    remote_fetches: int = 0  # slabs served across the peer hop
    remote_bytes: int = 0  # bytes moved across the peer hop
    failed_fetches: int = 0  # fetches refused by a down peer
    stale_aborts: int = 0  # in-flight remote reads invalidated by append
    migrations: int = 0  # ownership moves that relocated a resident slab
    directory_moves: int = 0  # ownership flips with no resident copy to move

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class PeerGroup:
    """In-process peer cluster: per-shard ``TierStack``s over one store, an
    ownership directory, and the epoch guard for in-flight reads.

    Shards register through :func:`make_peer_stack` (or
    :func:`make_peer_group`, which builds the whole symmetric cluster).
    ``stacks[s]`` is shard ``s``'s stack; any of them can serve as an
    engine's ``tiers=``, the others are the simulated peers.
    """

    def __init__(self, store: "BlockStore", n_shards: int):
        if n_shards < 2:
            raise ValueError("a peer group needs at least 2 shards")
        self.n_shards = int(n_shards)
        self.stacks: list[TierStack | None] = [None] * self.n_shards
        self._host_idx: list[int | None] = [None] * self.n_shards
        # block id -> owning shard; static-hashed on first sight, migrated by
        # repro_torch.storage.rebalance afterwards
        self.owner: dict[int, int] = {}
        self.stats = PeerGroupStats()
        self.obs = None  # optional repro_torch.obs.TraceRecorder
        self._down: dict[int, str] = {}  # shard -> "miss" | "raise"
        self._epoch: dict[int, int] = {}  # per-block invalidation stamp
        self._lock = threading.Lock()
        # test seam: called with the block id between the epoch snapshot and
        # the row copy of fetch_block, the window an append can race into
        self.mid_fetch_hook: Callable[[int], None] | None = None
        self._store = store
        store.register_invalidation_listener(self._on_invalidate)

    # ------------------------------------------------------------- membership
    def register_shard(self, shard: int, stack: TierStack, host_tier: int) -> None:
        """Attach shard ``shard``'s stack; ``host_tier`` is the index of its
        host tier (the level peers answer from).  Registers the stack's
        invalidation listener, so peer residents drop exactly like local
        tiers."""
        if not (0 <= shard < self.n_shards):
            raise ValueError(f"shard {shard} out of range")
        self.stacks[shard] = stack
        self._host_idx[shard] = int(host_tier)
        self._store.register_invalidation_listener(stack.invalidate)

    def _host_tier(self, shard: int) -> Tier:
        stack = self.stacks[shard]
        assert stack is not None
        return stack.tiers[self._host_idx[shard]]

    # ------------------------------------------------------------ invalidation
    def _on_invalidate(self, block_ids) -> None:
        """An append dirtied ``block_ids``: bump their epoch so a remote read
        in flight across the append aborts instead of serving stale bytes."""
        with self._lock:
            for b in np.asarray(block_ids).ravel():
                b = int(b)
                self._epoch[b] = self._epoch.get(b, 0) + 1

    # -------------------------------------------------------------- directory
    def owner_of(self, block_id: int) -> int:
        """Owning shard of ``block_id`` (static hash until migrated)."""
        b = int(block_id)
        sid = self.owner.get(b)
        if sid is None:
            sid = b % self.n_shards
            self.owner[b] = sid
        return sid

    def fail_shard(self, shard: int, mode: str = "miss") -> None:
        """Simulate shard death.  ``"miss"``: the shard silently leaves the
        directory (requests miss cleanly).  ``"raise"``: fetches routed to
        it raise :class:`PeerUnavailable`, which the requester's
        :class:`PeerTier` turns into a store read."""
        if mode not in ("miss", "raise"):
            raise ValueError(f"unknown failure mode {mode!r}")
        self._down[int(shard)] = mode

    def heal_shard(self, shard: int) -> None:
        self._down.pop(int(shard), None)

    def locate(self, block_id: int, exclude: int | None = None) -> int | None:
        """Shard whose host tier holds ``block_id`` (owner first, then any
        resident copy), or ``None``.  Skips ``exclude`` and shards down in
        ``"miss"`` mode."""
        b = int(block_id)
        for sid in (self.owner_of(b), *range(self.n_shards)):
            if sid == exclude or self.stacks[sid] is None:
                continue
            if self._down.get(sid) == "miss":
                continue
            if b in self._host_tier(sid):
                return sid
        return None

    # ------------------------------------------------------------------ fetch
    def fetch_block(self, block_id: int, requester: int | None = None):
        """One simulated peer fetch: copy ``block_id``'s slot rows out of the
        shard that holds it.  Returns ``(dims, meas, valid, nbytes)`` (the
        rows on the holder's pool device), or ``None`` when no peer holds
        the block or the read was invalidated in flight.  Raises
        :class:`PeerUnavailable` when the serving shard is down in
        ``"raise"`` mode."""
        b = int(block_id)
        sid = self.locate(b, exclude=requester)
        if sid is None:
            return None
        if self._down.get(sid) == "raise":
            with self._lock:
                self.stats.failed_fetches += 1
            raise PeerUnavailable(f"shard {sid} is not responding")
        with self._lock:
            token = self._epoch.get(b, 0)
        tier = self._host_tier(sid)
        entry = tier.peek(b)
        if entry is None:  # raced an eviction between locate and peek
            return None
        if self.mid_fetch_hook is not None:
            self.mid_fetch_hook(b)
        slab = (*tier.rows(entry[0]), int(entry[1]))
        with self._lock:
            if self._epoch.get(b, 0) != token:
                # an append dirtied this block while the copy was under way:
                # the rows predate it, and the requester re-reads the store
                self.stats.stale_aborts += 1
                return None
            self.stats.remote_fetches += 1
            self.stats.remote_bytes += int(entry[1])
        if self.obs is not None:
            self.obs.event("fetch.peer", block=b, shard=sid, nbytes=int(entry[1]))
        tier.touch(b)
        return slab

    # -------------------------------------------------------------- migration
    def migrate(self, block_id: int, to: int, store: "BlockStore" | None = None) -> bool:
        """Move ``block_id``'s ownership (and its resident copy, if any) to
        shard ``to``.  The rows are copied out of the holder's slot before
        the pop frees it, then placed into the new owner's host tier under
        that stack's placement cascade: bytes move, never re-read."""
        b, to = int(block_id), int(to)
        if not (0 <= to < self.n_shards) or self.stacks[to] is None:
            raise ValueError(f"cannot migrate to unregistered shard {to}")
        if self.owner_of(b) == to and self.locate(b) in (to, None):
            return False
        src = self.locate(b)
        self.owner[b] = to
        if src is None or src == to:
            with self._lock:
                self.stats.directory_moves += 1
            return True
        src_tier = self._host_tier(src)
        entry = src_tier.peek(b)
        rows = src_tier.rows(entry[0]) if entry is not None else None
        src_tier.pop(b)
        self.stacks[src]._sync_gauges()
        if rows is None:
            with self._lock:
                self.stats.directory_moves += 1
            return True
        self.stacks[to].prefetch(store or self._store, [b], tier=self._host_idx[to],
                                 slabs={b: rows})
        with self._lock:
            self.stats.migrations += 1
        return True

    # ----------------------------------------------------------------- warm-up
    def warm(self, store: "BlockStore", assignment: Mapping[int, Sequence[int]]) -> None:
        """Load blocks into shards' host tiers and take ownership:
        ``assignment`` maps shard id → block ids.  Reads go through each
        shard's own stack (counted on THAT stack)."""
        for sid, ids in assignment.items():
            stack = self.stacks[int(sid)]
            if stack is None:
                raise ValueError(f"shard {sid} not registered")
            ids = np.asarray(list(ids), dtype=np.int64)
            if ids.size == 0:
                continue
            stack.prefetch(store, ids, tier=self._host_idx[int(sid)])
            for b in ids:
                self.owner[int(b)] = int(sid)


class PeerTier(Tier):
    """The local stack's view of the rest of the cluster's host memory.

    Owns no bytes (``capacity_bytes`` 0): residency is answered by the group
    directory, gathers copy the holder's slot rows, and every placement hook
    is inert.  Priced by the ``ici`` preset, so ``effective_io_time`` and
    the residency-aware planner see the peer hop.
    """

    def __init__(self, group: PeerGroup, shard: int, block_bytes: int = 256 * 1024,
                 name: str = "peer", cost: CostModel | None = None):
        super().__init__(name, 0, cost or make_cost_model("ici", block_bytes))
        self.group = group
        self.shard = int(shard)
        self.failures = 0  # fetches lost to a raising peer (fell to store)
        self._fetch: Callable[[int], tuple | None] = (
            lambda b: group.fetch_block(b, requester=self.shard))

    def route_through(self, planner) -> None:
        """Serve remote reads through a :class:`repro_torch.core.sharded.
        DistributedAnyK` (its ``fetch_remote``) instead of calling the group
        directly: the wiring ``NeedleTailEngine.attach_mesh`` applies."""
        self._fetch = lambda b: planner.fetch_remote([b], requester=self.shard).get(int(b))

    # ------------------------------------------------------------- residency
    def __contains__(self, block_id: int) -> bool:
        return self.group.locate(int(block_id), exclude=self.shard) is not None

    def __len__(self) -> int:
        return 0

    def has_room(self, nbytes: int) -> bool:
        return False

    def fits_at_all(self, nbytes: int) -> bool:
        return False

    # ----------------------------------------------------- inert placement ops
    def touch(self, block_id: int) -> None:
        pass

    def peek(self, block_id: int):
        # None keeps promotion and every gather's slot read off this tier:
        # remote blocks move shards by ownership migration only
        return None

    def put(self, *args) -> None:
        raise RuntimeError("PeerTier owns no local bytes; placement skips it")

    def pop(self, block_id: int):
        return None

    def pop_lru(self):
        return None, None

    # ------------------------------------------------------------------ serve
    def host_view(self, block_id: int):
        """The holder's copied rows ``(dims, meas, valid, nbytes)``; ``None``
        (the stack then reads the store) when no peer holds the block, the
        read was invalidated in flight, or the peer raised."""
        try:
            return self._fetch(int(block_id))
        except PeerUnavailable:
            self.failures += 1
            return None

    # ------------------------------------------------------------- reporting
    def extra_counters(self) -> dict[str, int]:
        """Extra ``tier_counters`` keys (``peer.remote_fetches``, ...) the
        serving loop's per-wave tier delta picks up."""
        g = self.group.stats
        return {
            "remote_fetches": g.remote_fetches,
            "migrations": g.migrations + g.directory_moves,
            "stale_aborts": g.stale_aborts,
            "failures": self.failures,
        }


def make_peer_stack(
    group: PeerGroup,
    shard: int,
    dram_bytes: int | None = None,
    hbm_bytes: int | None = None,
    backing: CostModel | str = "hdd",
    block_bytes: int = 256 * 1024,
    policy: PlacementPolicy | None = None,
    device_fill: bool | None = None,
    ici_cost: CostModel | None = None,
    device: str | torch.device = "cuda",
) -> TierStack:
    """One shard's stack on ``device``: optional slot pool on the card →
    host pool → :class:`PeerTier` → backing store.  Registers the shard with
    ``group`` and tags the stack with ``peer_tier`` (what ``attach_mesh``
    routes through ``DistributedAnyK.fetch_remote``).  ``ici_cost``
    overrides the peer tier's ``ici`` preset, e.g. with a model fitted by
    :func:`repro_torch.storage.calibration.calibrate_model`."""
    if isinstance(backing, str):
        backing = make_cost_model(backing, block_bytes)
    tiers: list[Tier] = []
    if hbm_bytes is not None:
        tiers.append(Tier("hbm", hbm_bytes, make_cost_model("hbm", block_bytes), device=True))
    host_idx = len(tiers)
    tiers.append(Tier("dram", dram_bytes, make_cost_model("dram", block_bytes)))
    peer = PeerTier(group, shard, block_bytes, cost=ici_cost)
    tiers.append(peer)
    stack = TierStack(tiers, backing=backing, policy=policy, device_fill=device_fill,
                      device=device)
    stack.peer_tier = peer
    group.register_shard(shard, stack, host_tier=host_idx)
    return stack


def make_peer_group(
    store: "BlockStore",
    n_shards: int,
    dram_bytes: int | None = None,
    hbm_bytes: int | None = None,
    backing: CostModel | str = "hdd",
    block_bytes: int = 256 * 1024,
    policy: PlacementPolicy | None = None,
    device_fill: bool | None = None,
    device: str | torch.device = "cuda",
) -> PeerGroup:
    """A symmetric ``n_shards``-shard cluster over one ``store``, every
    stack on ``device`` with the same budgets; ``group.stacks[0]`` is the
    conventional engine-side stack (``NeedleTailEngine(store,
    tiers=group.stacks[0])``)."""
    group = PeerGroup(store, n_shards)
    for sid in range(n_shards):
        make_peer_stack(group, sid, dram_bytes=dram_bytes, hbm_bytes=hbm_bytes,
                        backing=backing, block_bytes=block_bytes, policy=policy,
                        device_fill=device_fill, device=device)
    return group
