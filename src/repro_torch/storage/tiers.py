"""Tiered block storage: a slot pool on the card → pinned host memory →
backing store.

Counterpart of ``repro/storage/tiers.py``.  Instead of one flat
engine-lifetime ``BlockLRUCache`` in front of the ``BlockStore``, a
:class:`TierStack` layers byte-budgeted tiers, each priced by its own
:class:`~repro_torch.core.cost_model.CostModel` preset (``hbm``, ``dram``,
whatever the store sits on), with a pluggable
:class:`~repro_torch.storage.policy.PlacementPolicy` arbitrating admission,
promotion, demotion and victim selection by modeled **io_time saved per
byte**.  The placement bookkeeping (which block lands where, every counter)
is the reference's step for step.

Drop-in contract
----------------
``TierStack`` implements the surface of the port's ``BlockLRUCache``:
``get_many`` / ``ensure`` / ``invalidate`` / ``clear`` / ``__contains__`` /
``__len__`` / ``stats`` / ``fetch_log`` and ``get_wave``, so
``NeedleTailEngine(tiers=...)`` routes every fetch path through it:
``any_k``, ``aggregate``, the online fold, the three wave loops and
``DistributedAnyK.fetch_plan``.

**Byte identity.**  For any budgets, any policy and any sequence of
``get_many`` / ``ensure`` / ``invalidate`` calls, ``get_many(store, ids)``
returns slabs byte-identical to ``store.fetch(ids)``, on the store's
device (the reference returns host slabs; the port, as its flat cache,
keeps them on the card).  Placement changes which medium serves a block,
never the data.

Where the tiers live
--------------------
Each tier is a slot pool: three tensors ``[C, R, r]`` int32, ``[C, R, s]``
f32 and ``[C, R]`` bool that grow by doubling, never past the tier's budget
in blocks (nor the store's λ); each resident block owns one slot.  A tier
built with ``device=True`` (tier 0, ``hbm``) keeps its pool on the stack's
device and is read by one ``block_gather`` launch per tensor over the
slots.  Any other tier (``dram``) keeps its pool in host memory, pinned
when the stack's device is a card: its hits gather on the host into a
pinned staging buffer and cross in one ``non_blocking`` copy per tensor
per call; a demotion from the card is one device→host copy of the slot
rows.  On the CPU (``device="cpu"``, as in the tests) both pools are plain
CPU tensors.  A placement records which slot receives which bytes; the
copies run once per call, grouped by source and destination, every source
read before any slot is written, so a slot reused within a call still
serves the bytes it held when the call began.

The backing store is ``store.fetch`` (``block_gather`` on the store's
slabs), priced by the ``backing`` model: in both packages the store really
lives in device memory, so backing reads are modeled, not physical.
``device_fill`` keeps the reference's split of a miss batch into the ids
bound for device tiers and the rest (two store reads, so
``store_fetch_calls`` equals the reference's); ``None`` turns it on when
the stack's device is a card.

Invalidation contract: the store reports exactly the dirtied ids and
:meth:`TierStack.invalidate` evicts them from **every** tier; anything that
swaps the store wholesale calls :meth:`TierStack.clear`.

Cost accounting: :meth:`TierStack.effective_io_time` prices a block set by
where it is resident (each tier's ids as one §4.1 ascending pass under that
tier's model, misses under the backing model), which the residency-aware
§7.2 arbitration (``NeedleTailEngine(residency_aware=True)``) compares.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.block_cache import CacheStats
from repro_torch.core.cost_model import CostModel, make_cost_model
from repro_torch.device import resolve_device
from repro_torch.kernels.plan_wave import block_gather
from repro_torch.storage.policy import CostAwarePolicy, PlacementPolicy

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.data.block_store import BlockStore

Slabs = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class TierStats:
    """Per-tier placement counters (monotonic except the two gauges)."""

    hits: int = 0  # gathers served by this tier
    admissions: int = 0  # fresh store reads admitted here
    promotions_in: int = 0  # blocks moved up into this tier
    demotions_in: int = 0  # blocks displaced down into this tier
    demotions_out: int = 0  # residents displaced down out of this tier
    evictions: int = 0  # residents dropped out of the stack from here
    invalidations: int = 0  # residents evicted by append invalidation
    bytes_cached: int = 0  # gauge
    blocks_cached: int = 0  # gauge

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class Tier:
    """One byte-budgeted level of the hierarchy.

    Parameters
    ----------
    name : str
        Display/counter key (``"hbm"``, ``"dram"``, ...).
    capacity_bytes : int | None
        Byte budget; ``None`` is unbounded.  A slab larger than the whole
        budget skips the tier (it is placed at the demotion target instead).
    cost : CostModel
        The preset this tier prices its residents with.
    device : bool
        ``True`` keeps the tier's slot pool on the stack's device (tier 0);
        ``False`` in host memory, pinned when the stack's device is a card.
    """

    def __init__(self, name: str, capacity_bytes: int | None, cost: CostModel,
                 device: bool = False):
        self.name = name
        self.capacity_bytes = capacity_bytes
        self.cost = cost
        self.device = device
        self.stats = TierStats()
        # bytes promised to in-flight admissions of the current miss batch,
        # so sequential admit_tier decisions see the tier filling up
        self.reserved_bytes = 0
        # block id -> (pool slot, nbytes), least recently used first
        self._slabs: "OrderedDict[int, tuple[int, int]]" = OrderedDict()
        self._pool: Slabs | None = None
        self._free: list[int] = []  # free slots, lowest last
        self._where: torch.device | None = None  # pool device (set by the stack)
        self._pinned = False
        # device tiers only: memoized host copies of resident slabs (one
        # download per residency), outside the tier's byte budget
        self._host_mirror: dict[int, tuple] = {}

    # ----------------------------------------------------------------- state
    def __contains__(self, block_id: int) -> bool:
        return int(block_id) in self._slabs

    def __len__(self) -> int:
        return len(self._slabs)

    def block_ids(self) -> Iterable[int]:
        """Resident ids in LRU order (least recently used first)."""
        return self._slabs.keys()

    def slab_nbytes(self, block_id: int) -> int | None:
        entry = self._slabs.get(int(block_id))
        return entry[1] if entry is not None else None

    def has_room(self, nbytes: int) -> bool:
        if self.capacity_bytes is None:
            return True
        return self.stats.bytes_cached + self.reserved_bytes + nbytes <= self.capacity_bytes

    def fits_at_all(self, nbytes: int) -> bool:
        """Whether a slab of ``nbytes`` could ever reside here."""
        return self.capacity_bytes is None or nbytes <= self.capacity_bytes

    # --------------------------------------------------------------- mutate
    def touch(self, block_id: int) -> None:
        self._slabs.move_to_end(int(block_id))

    def peek(self, block_id: int):
        """``(slot, nbytes)`` of a resident, else ``None``."""
        return self._slabs.get(int(block_id))

    def put(self, block_id: int, slot: int, nbytes: int) -> None:
        """Record ``block_id`` as resident in ``slot`` (the stack has made
        room and schedules the slot's bytes)."""
        self._slabs[int(block_id)] = (slot, nbytes)
        self.stats.bytes_cached += nbytes
        self.stats.blocks_cached = len(self._slabs)

    def _forget(self, block_id: int, entry: tuple[int, int]) -> None:
        self._host_mirror.pop(int(block_id), None)
        self._free.append(entry[0])
        self.stats.bytes_cached -= entry[1]
        self.stats.blocks_cached = len(self._slabs)

    def pop(self, block_id: int):
        entry = self._slabs.pop(int(block_id), None)
        if entry is not None:
            self._forget(block_id, entry)
        return entry

    def pop_lru(self):
        if not self._slabs:
            return None, None
        b, entry = self._slabs.popitem(last=False)
        self._forget(b, entry)
        return b, entry

    def drop_all(self) -> None:
        """Forget every resident and free the pool."""
        self._slabs.clear()
        self._host_mirror.clear()
        self._pool, self._free = None, []
        self.stats.bytes_cached = 0
        self.stats.blocks_cached = 0

    # ----------------------------------------------------------------- pool
    def alloc(self, shapes: tuple, limit: int) -> int:
        """A free slot, doubling the pool (at least 16 slots, at most
        ``limit``, the tier's budget in blocks) when none is free."""
        if not self._free:
            old = 0 if self._pool is None else self._pool[0].shape[0]
            new = min(max(limit, old + 1), max(16, 2 * old))
            pool = tuple(torch.empty((new, *shape), dtype=dtype, device=self._where,
                                     pin_memory=self._pinned)
                         for shape, dtype in shapes)
            if self._pool is not None:
                for n, o in zip(pool, self._pool):
                    n[:old].copy_(o)
            self._pool = pool
            self._free.extend(range(new - 1, old - 1, -1))
        return self._free.pop()

    def host_view(self, block_id: int):
        """Host ``(dims, meas, valid, nbytes)`` of a resident slab, memoized
        for device tiers (ONE download per residency, not one per access)."""
        entry = self._slabs.get(int(block_id))
        if entry is None:
            return None
        slot, nb = entry
        if not self.device:  # a copy: the slot is reused once the block leaves
            return (*(p[slot].clone() for p in self._pool), nb)
        mirror = self._host_mirror.get(int(block_id))
        if mirror is None:
            mirror = (*(p[slot].cpu() for p in self._pool), nb)
            self._host_mirror[int(block_id)] = mirror
        return mirror


def _gather(tensors: Slabs, idx: np.ndarray, pinned_out: bool) -> Slabs:
    """``tensors[idx]`` on their own device: ``block_gather`` on the card;
    on the host an ``index_select``, into pinned memory when the rows go on
    to the card."""
    if tensors[0].device.type == "cuda":
        ids = torch.from_numpy(idx.astype(np.int32)).to(tensors[0].device)
        return (block_gather(tensors[0], ids), block_gather(tensors[1], ids),
                block_gather(tensors[2].view(torch.int8), ids) != 0)
    ids = torch.from_numpy(idx.astype(np.int64))
    if not pinned_out:
        return tuple(t.index_select(0, ids) for t in tensors)
    outs = []
    for t in tensors:
        out = torch.empty((ids.numel(), *t.shape[1:]), dtype=t.dtype, pin_memory=True)
        torch.index_select(t, 0, ids, out=out)
        outs.append(out)
    return tuple(outs)


def _move(rows: Slabs, dev: torch.device) -> Slabs:
    """Rows on ``dev``: host→card as one ``non_blocking`` copy per tensor
    from pinned rows; card→host as one copy per tensor into pinned memory."""
    src = rows[0].device
    if src == dev:
        return rows
    if src.type == "cpu":
        return tuple(r.to(dev, non_blocking=True) for r in rows)
    outs = []
    for r in rows:
        out = torch.empty(r.shape, dtype=r.dtype, pin_memory=dev.type == "cpu")
        out.copy_(r)
        outs.append(out)
    return tuple(outs)


class TierStack:
    """Byte-budgeted storage tiers with cost-model-arbitrated placement.

    Parameters
    ----------
    tiers : Sequence[Tier]
        Fast-to-slow cache tiers (tier 0 first).  The backing store is the
        implicit bottom level: always consistent, never "full".
    backing : CostModel | None
        Cost model of the backing store (defaults to the paper's ``hdd``).
    policy : PlacementPolicy | None
        The placement arbiter; defaults to :class:`~repro_torch.storage.
        policy.CostAwarePolicy`.
    device_fill : bool | None
        Read the misses bound for device tiers in their own store read (the
        reference's fill path); ``None`` turns it on on a card.
    device : str | torch.device
        Where the store lives and tier 0's pool is kept; defaults to
        ``"cuda"`` and raises without it.

    ``stats`` aggregates the flat-cache counters; ``evictions`` counts only
    blocks dropped *out of the stack*, a demotion is not an eviction.
    Per-tier counters live on each ``Tier.stats`` and are exported flat by
    :meth:`tier_counters`.
    """

    def __init__(
        self,
        tiers: Sequence[Tier],
        backing: CostModel | None = None,
        policy: PlacementPolicy | None = None,
        device_fill: bool | None = None,
        device: str | torch.device = "cuda",
    ):
        if not tiers:
            raise ValueError("TierStack needs at least one tier")
        self.device = resolve_device(device)
        self.tiers = list(tiers)
        for tier in self.tiers:
            tier._where = self.device if tier.device else torch.device("cpu")
            tier._pinned = not tier.device and self.device.type == "cuda"
        self.backing = backing or make_cost_model("hdd")
        self.policy = policy or CostAwarePolicy()
        self.device_fill = device_fill
        self.stats = CacheStats()
        # run_batch swaps in a list for exact per-batch physical-I/O logging
        self.fetch_log: list | None = None
        self._accesses: dict[int, int] = {}  # logical touches per block id
        # ids the store reported dirtied: their next admission books as
        # ``invalidation_rereads`` instead of ``misses`` (one-shot marks)
        self._invalidated: set[int] = set()
        # not carried by this slice of the port (the serving slice's traces)
        self.obs = None
        # measured-cost feedback (storage.calibration, core.plan_ledger)
        self.ledger = None
        self.timing_backend = None
        # within a call: (tier, slot) -> the bytes it receives, as
        # ("batch", key, row) of a store read or ("slot", tier, slot) as the
        # call found it; run by _flush at the end of the call
        self._pending: dict[tuple[int, int], tuple] = {}
        self._batches: dict[int, Slabs] = {}
        self._shapes: tuple | None = None
        self._lam = 0

    # ------------------------------------------------------------------ admin
    def __contains__(self, block_id: int) -> bool:
        return self._find(int(block_id)) is not None

    def __len__(self) -> int:
        return sum(len(t) for t in self.tiers)

    @property
    def nbytes(self) -> int:
        return self.stats.bytes_cached

    def accesses(self, block_id: int) -> int:
        """Logical access count of ``block_id`` (policy scoring input)."""
        return self._accesses.get(int(block_id), 0)

    def access_counts(self) -> dict[int, int]:
        """Copy of the per-block logical-access ledger."""
        return dict(self._accesses)

    def _find(self, block_id: int) -> int | None:
        for t, tier in enumerate(self.tiers):
            if block_id in tier:
                return t
        return None

    def _sync_gauges(self) -> None:
        self.stats.bytes_cached = sum(t.stats.bytes_cached for t in self.tiers)
        self.stats.blocks_cached = sum(len(t) for t in self.tiers)

    def clear(self) -> None:
        self.stats.invalidations += len(self)
        for tier in self.tiers:
            tier.stats.invalidations += len(tier)
            tier.drop_all()
        self._accesses.clear()
        # wholesale swap: the next reads hit genuinely new data (cold misses)
        self._invalidated.clear()
        self._sync_gauges()

    def invalidate(self, block_ids: Iterable[int]) -> int:
        """Evict exactly ``block_ids`` from EVERY tier (the dirtied blocks);
        returns the number of resident copies evicted."""
        n = 0
        for b in block_ids:
            b = int(b)
            self._invalidated.add(b)
            for tier in self.tiers:
                if tier.pop(b) is not None:
                    tier.stats.invalidations += 1
                    n += 1
            self._accesses.pop(b, None)
        if len(self._invalidated) > (1 << 20):  # safety valve: marks degrade
            self._invalidated.clear()  # to plain misses, never grow unbounded
        self.stats.invalidations += n
        self._sync_gauges()
        return n

    def _split_rereads(self, miss_set: set[int]) -> set[int]:
        """The invalidated ids among ``miss_set`` (consuming their marks)."""
        if not self._invalidated:
            return set()
        re_ids = self._invalidated & miss_set
        if re_ids:
            self._invalidated -= re_ids
        return re_ids

    # ------------------------------------------------------------- residency
    def residency_tier(self, block_ids) -> np.ndarray:
        """Tier index per id; ``len(self.tiers)`` marks a miss (backing)."""
        ids = np.asarray(block_ids, dtype=np.int64).ravel()
        out = np.full(ids.shape, len(self.tiers), dtype=np.int64)
        for i, b in enumerate(ids):
            t = self._find(int(b))
            if t is not None:
                out[i] = t
        return out

    def _corr(self, level: str) -> float:
        """Plan-ledger price correction for ``level`` (1.0 if none)."""
        lg = self.ledger
        return lg.correction(level) if lg is not None else 1.0

    def effective_io_time(self, block_ids, backing: CostModel | None = None) -> float:
        """Residency-aware modeled I/O time of fetching ``block_ids``: each
        tier's residents as one §4.1 ascending pass under that tier's model,
        misses under ``backing`` (default: the stack's), each component
        scaled by its level's plan-ledger correction."""
        backing = backing or self.backing
        ids = np.asarray(block_ids, dtype=np.int64).ravel()
        if ids.size == 0:
            return 0.0
        where = self.residency_tier(ids)
        total = 0.0
        for t, tier in enumerate(self.tiers):
            sel = ids[where == t]
            if sel.size:
                total += tier.cost.io_time(sel) * self._corr(tier.name)
        miss = ids[where == len(self.tiers)]
        if miss.size:
            total += backing.io_time(miss) * self._corr(backing.name)
        return total

    def calibrate(self, backend=None, **fit_kw) -> dict:
        """Refit every measurable tier/backing model from ``backend`` in
        place (:func:`repro_torch.storage.calibration.calibrate_stack`);
        with no argument, reuses the retained backend."""
        from repro_torch.storage.calibration import calibrate_stack

        be = backend if backend is not None else self.timing_backend
        if be is None:
            raise ValueError("TierStack.calibrate needs a timing backend")
        return calibrate_stack(self, be, **fit_kw)

    # --------------------------------------------------------------- the data
    def _bind(self, store: "BlockStore") -> None:
        if store.device != self.device:
            raise ValueError(f"store lives on {store.device}, the tier stack on {self.device}")
        r, s = int(store.dims.shape[-1]), int(store.measures.shape[-1])
        rpb = store.records_per_block
        self._shapes = (((rpb, r), torch.int32), ((rpb, s), torch.float32),
                        ((rpb,), torch.bool))
        self._lam = store.num_blocks

    def _batch(self, slabs: Slabs) -> int:
        key = len(self._batches)
        self._batches[key] = slabs
        return key

    def _read_store(self, store: "BlockStore", ids: np.ndarray) -> int:
        """One booked store read; returns its batch key."""
        self.stats.store_fetch_calls += 1
        self.stats.store_blocks_fetched += int(ids.size)
        if self.fetch_log is not None:
            self.fetch_log.append(ids)
        return self._batch(store.fetch(ids))

    def _source(self, tier_idx: int, slot: int) -> tuple:
        """Where the bytes of ``slot`` of ``tier_idx`` come from in this
        call: its scheduled source, or the slot itself as the call found it."""
        return self._pending.get((tier_idx, slot), ("slot", tier_idx, slot))

    def _rows(self, src: tuple, idx: list[int], dev: torch.device) -> Slabs:
        kind, a = src
        tensors = self._batches[a] if kind == "batch" else self.tiers[a]._pool
        pinned = tensors[0].device.type == "cpu" and dev.type == "cuda"
        return _move(_gather(tensors, np.asarray(idx, dtype=np.int64), pinned), dev)

    def _flush(self, out_srcs: list | None = None) -> Slabs | None:
        """Run the call's scheduled slot writes and gather ``out_srcs`` onto
        the stack's device: every source is read before any slot is written."""
        ops, self._pending = self._pending, {}
        groups: dict[tuple, tuple[list, list]] = {}
        for (t, slot), (kind, a, i) in ops.items():
            g = groups.setdefault((t, kind, a), ([], []))
            g[0].append(i)
            g[1].append(slot)
        out = None
        if out_srcs is not None:
            by_src: dict[tuple, tuple[list, list]] = {}
            for pos, (kind, a, i) in enumerate(out_srcs):
                g = by_src.setdefault((kind, a), ([], []))
                g[0].append(i)
                g[1].append(pos)
            parts = [(pos, self._rows(src, idx, self.device)) for src, (idx, pos) in by_src.items()]
            if len(parts) == 1:
                out = parts[0][1]  # one source, positions in order
            else:
                n = len(out_srcs)
                out = tuple(torch.empty((n, *r.shape[1:]), dtype=r.dtype, device=self.device)
                            for r in parts[0][1])
                for pos, rows in parts:
                    p = torch.as_tensor(pos, dtype=torch.long, device=self.device)
                    for o, r in zip(out, rows):
                        o.index_copy_(0, p, r)
        writes = [(self.tiers[t], slots, self._rows((kind, a), idx, self.tiers[t]._where))
                  for (t, kind, a), (idx, slots) in groups.items()]
        for tier, slots, rows in writes:
            s = torch.as_tensor(slots, dtype=torch.long, device=tier._where)
            for p, r in zip(tier._pool, rows):
                p.index_copy_(0, s, r)
        self._batches = {}
        return out

    # ------------------------------------------------------------- placement
    def _drop(self, tier_idx: int, block_id: int) -> None:
        self.tiers[tier_idx].stats.evictions += 1
        self.stats.evictions += 1
        self._accesses.pop(int(block_id), None)

    def _resolve_target(self, tier_idx: int | None, nbytes: int) -> int | None:
        """Walk the demote chain until a tier that can hold ``nbytes`` at
        all; ``None`` means the slab leaves the stack."""
        while tier_idx is not None and not self.tiers[tier_idx].fits_at_all(nbytes):
            tier_idx = self.policy.demote_target(self, tier_idx)
        return tier_idx

    def _place(self, tier_idx: int, block_id: int, src: tuple, nbytes: int, *,
               how: str) -> None:
        """Insert ``block_id`` (bytes from ``src``) at ``tier_idx``,
        displacing residents per the policy (victim selection + demotion
        cascade).  A slab too large for the tier's whole budget falls
        through to the demotion target; a fresh admission that fits nowhere
        is simply not admitted."""
        tier_idx = self._resolve_target(tier_idx, nbytes)
        if tier_idx is None:
            self._accesses.pop(int(block_id), None)
            return
        tier = self.tiers[tier_idx]
        while not tier.has_room(nbytes) and len(tier):
            victim = self.policy.victim(self, tier_idx)
            if victim is None or victim not in tier:
                victim, ventry = tier.pop_lru()
            else:
                ventry = tier.pop(victim)
            vsrc = self._source(tier_idx, ventry[0])
            # resolve where the victim can actually land BEFORE writing the
            # demotion ledger: a "demotion" whose every lower tier is too
            # small for the slab is a drop, and must be counted as one
            target = self._resolve_target(self.policy.demote_target(self, tier_idx), ventry[1])
            if target is None:
                self._drop(tier_idx, victim)
            else:
                tier.stats.demotions_out += 1
                self.tiers[target].stats.demotions_in += 1
                self._place(target, victim, vsrc, ventry[1], how="demote")
        limit = self._lam
        if tier.capacity_bytes is not None:
            limit = min(limit, max(1, tier.capacity_bytes // max(nbytes, 1)))
        slot = tier.alloc(self._shapes, max(limit, 1))
        tier.put(int(block_id), slot, nbytes)
        self._pending[(tier_idx, slot)] = src
        if how == "admit":
            tier.stats.admissions += 1
        elif how == "promote":
            tier.stats.promotions_in += 1
        self._sync_gauges()

    def _promote_if_worthy(self, block_id: int, tier_idx: int) -> None:
        """Policy hook on a hit: move the block up one level if the arbiter
        says so (and it can land strictly above)."""
        target = self.policy.promote_tier(self, block_id, tier_idx)
        if target is None or target >= tier_idx:
            return
        entry = self.tiers[tier_idx].peek(block_id)
        if entry is None:  # defensive: racing policies
            return
        land = self._resolve_target(tier_idx - 1, entry[1])
        if land is None or land >= tier_idx:
            return
        src = self._source(tier_idx, entry[0])
        self.tiers[tier_idx].pop(block_id)
        self._place(land, block_id, src, entry[1], how="promote")

    # ------------------------------------------------------------------ fetch
    @staticmethod
    def block_nbytes(store: "BlockStore") -> int:
        """Bytes of one block slab ``(dims i32 [R, r], meas f32 [R, s],
        valid bool [R])``: the unit tier budgets are sized in."""
        r = int(store.dims.shape[-1])
        s = int(store.measures.shape[-1])
        return store.records_per_block * (r * 4 + s * 4 + 1)

    def _use_device_fill(self) -> bool:
        if self.device_fill is not None:
            return bool(self.device_fill)
        return self.device.type == "cuda"

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fetch_and_admit(self, store: "BlockStore", miss: np.ndarray) -> dict:
        """Read ``miss`` (ascending) from the backing store and admit each
        block at its policy-chosen tier: device-tier admissions in one read
        when ``device_fill``, everything else in another.  Returns
        ``block_id -> ("batch", key, row)`` for the miss batch, which serves
        a block this call admitted and displaced again."""
        nb = self.block_nbytes(store)
        # predicted price of this miss batch BEFORE fetching (ledger-
        # corrected like every other quote); the observation closes the loop
        priced = self.ledger is not None and miss.size
        pred = t_wall = 0.0
        if priced:
            pred = self.backing.io_time(miss) * self._corr(self.backing.name)
            self._sync()
            t_wall = time.perf_counter()
        # sequential admission decisions: reserve bytes as targets are chosen
        targets: dict[int, int] = {}
        try:
            for b in miss:
                t = self.policy.admit_tier(self, int(b), nb)
                targets[int(b)] = t
                self.tiers[t].reserved_bytes += nb
        finally:
            for tier in self.tiers:
                tier.reserved_bytes = 0
        dev_fill = self._use_device_fill()
        dev_ids = np.asarray(
            sorted(b for b, t in targets.items() if self.tiers[t].device and dev_fill),
            dtype=np.int64)
        host_ids = np.asarray(sorted(set(targets) - {int(b) for b in dev_ids}), dtype=np.int64)
        inscope: dict[int, tuple] = {}
        for ids in (host_ids, dev_ids):
            if not ids.size:
                continue
            key = self._read_store(store, ids)
            for off, b in enumerate(ids):
                inscope[int(b)] = ("batch", key, off)
                self._place(targets[int(b)], int(b), inscope[int(b)], nb, how="admit")
        if priced:
            from repro_torch.storage.calibration import measurable

            be = self.timing_backend
            # a backend wrapping THIS store would re-fetch to answer: the
            # demand read just timed is already the observation there
            if be is not None and measurable(be, self.backing.name) and \
                    getattr(be, "store", None) is not store:
                obs = be.io_seconds(self.backing.name, miss)
            else:
                self._sync()
                obs = time.perf_counter() - t_wall
            self.ledger.record("placement", self.backing.name, pred, obs)
        return inscope

    def ensure(self, store: "BlockStore", block_ids) -> int:
        """Admit every miss among ``block_ids`` (ascending §4.1 order);
        returns the number of blocks read from the backing store."""
        self._bind(store)
        ids = np.asarray(block_ids, dtype=np.int64).ravel()
        miss_set = {int(b) for b in ids if self._find(int(b)) is None}
        if not miss_set:
            return 0
        miss = np.asarray(sorted(miss_set), dtype=np.int64)
        re_ids = self._split_rereads(miss_set)
        # admissions are logical misses, except append-invalidated re-reads
        self.stats.misses += int(miss.size) - len(re_ids)
        self.stats.invalidation_rereads += len(re_ids)
        self._fetch_and_admit(store, miss)
        self._flush()
        return int(miss.size)

    def prefetch(self, store: "BlockStore", block_ids, tier: int = 0,
                 slabs: dict | None = None) -> int:
        """Speculatively promote ``block_ids`` into ``tier`` ahead of demand
        (:mod:`repro_torch.storage.prefetch`).

        Residents at or above ``tier`` are untouched; residents below it are
        promoted; misses are read from the backing store, or taken from
        ``slabs`` (``block_id -> (dims, meas, valid)`` tensors, the async
        prefetcher's completed reads) without touching it, and admitted at
        ``tier``.  No hit/miss accounting: only ``store_fetch_calls`` /
        ``store_blocks_fetched`` and ``fetch_log`` record the physical
        reads.  Returns how many blocks are resident anywhere afterwards."""
        if not (0 <= tier < len(self.tiers)):
            raise ValueError(f"tier {tier} out of range")
        self._bind(store)
        nb = self.block_nbytes(store)
        todo = list(dict.fromkeys(int(b) for b in np.asarray(block_ids, np.int64).ravel()))
        miss: list[int] = []
        for b in todo:
            at = self._find(b)
            if at is None:
                miss.append(b)
            elif at > tier:
                slot, nbytes = self.tiers[at].peek(b)
                src = self._source(at, slot)
                self.tiers[at].pop(b)
                self._place(tier, b, src, nbytes, how="promote")
        if miss:
            given = sorted(b for b in miss if slabs and b in slabs)
            have: dict[int, tuple] = {}
            if given:
                key = self._batch(tuple(torch.stack([slabs[b][i] for b in given])
                                        for i in range(3)))
                have = {b: ("batch", key, off) for off, b in enumerate(given)}
            need = np.asarray(sorted(set(miss) - set(have)), dtype=np.int64)
            if need.size:
                key = self._read_store(store, need)  # ascending §4.1 order
                have.update({int(b): ("batch", key, off) for off, b in enumerate(need)})
            for b in sorted(have):
                self._place(tier, b, have[b], nb, how="admit")
        self._flush()
        return sum(1 for b in todo if self._find(b) is not None)

    def get_many(self, store: "BlockStore", block_ids) -> Slabs:
        """Slabs for ``block_ids`` (order preserved) on the stack's device,
        reading every miss from the backing store in one ascending pass per
        fill path: ``(dims [B, R, r], measures [B, R, s], valid [B, R])``,
        byte-identical to ``store.fetch(block_ids)``."""
        self._bind(store)
        ids = np.asarray(block_ids, dtype=np.int64).ravel()
        if ids.size == 0:
            return store.fetch(ids)
        miss_set = {int(b) for b in ids if self._find(int(b)) is None}
        hits = sum(1 for b in ids if int(b) not in miss_set)
        self.stats.hits += int(hits)
        re_ids = self._split_rereads(miss_set)
        n_re = sum(1 for b in ids if int(b) in re_ids) if re_ids else 0
        self.stats.misses += int(ids.size - hits) - n_re
        self.stats.invalidation_rereads += n_re
        inscope: dict[int, tuple] = {}
        if miss_set:
            inscope = self._fetch_and_admit(store, np.asarray(sorted(miss_set), dtype=np.int64))
        srcs = []
        for b in ids:
            b = int(b)
            self._accesses[b] = self._accesses.get(b, 0) + 1
            t = self._find(b)
            if t is not None:
                tier = self.tiers[t]
                tier.touch(b)
                if b not in miss_set:
                    tier.stats.hits += 1
                    self._promote_if_worthy(b, t)
                t2 = self._find(b)  # promotion may have moved (or dropped) it
                if t2 is not None:
                    srcs.append(self._source(t2, self.tiers[t2].peek(b)[0]))
                    continue
            if b in inscope:
                # admitted this call but already displaced out of the stack
                # (budgets smaller than the request): the miss batch's row
                srcs.append(inscope[b])
            else:
                # a pre-call hit dropped by this call's own placements: the
                # one case left needing a re-read
                srcs.append(("batch", self._read_store(store, np.asarray([b], np.int64)), 0))
        if self.ledger is not None and self.timing_backend is not None:
            self._record_hit_observations(ids, miss_set)
        return self._flush(srcs)

    def get_wave(self, union: np.ndarray, per_query: Sequence[np.ndarray]) -> Slabs | None:
        """A wave's reads in one gather, after :meth:`ensure` of its
        ``union``.  When every union block is tier-0 resident, books exactly
        what ``get_many`` of each query's blocks, in order, would book (hits,
        accesses, LRU touches, the policy's promotion check, the ledger's
        hit observations) and returns the union's slabs, one
        ``block_gather`` launch per tensor; otherwise returns ``None`` and
        books nothing (the caller then reads query by query)."""
        tier0 = self.tiers[0]
        if any(int(b) not in tier0 for b in union):
            return None
        for blocks in per_query:
            self.stats.hits += int(blocks.size)
            for b in blocks:
                b = int(b)
                self._accesses[b] = self._accesses.get(b, 0) + 1
                tier0.touch(b)
                tier0.stats.hits += 1
                self._promote_if_worthy(b, 0)
            if self.ledger is not None and self.timing_backend is not None:
                self._record_hit_observations(np.asarray(blocks, np.int64), set())
        return self._flush([self._source(0, tier0.peek(int(b))[0]) for b in union])

    def get_device(self, store: "BlockStore", block_ids) -> Slabs:
        """Gather for device-side slab consumers with the reference's
        bookkeeping: misses admitted through :meth:`ensure`, pre-call
        residents booked as hits (promotion check included), tier-0
        residents read from the pool, lower-tier residents copied up without
        moving their residency.  Byte-identical to ``store.fetch``; requires
        tier 0 to be a device tier."""
        if not self.tiers[0].device:
            raise ValueError("get_device requires a device tier at level 0")
        self._bind(store)
        ids = np.asarray(block_ids, dtype=np.int64).ravel()
        if ids.size == 0:
            return store.fetch(ids)
        pre = {int(b) for b in ids if self._find(int(b)) is not None}
        self.ensure(store, ids)
        # device gathers are logical accesses like any other: they feed the
        # policy's frequency scores and the hit ledger
        for b in ids:
            b = int(b)
            self._accesses[b] = self._accesses.get(b, 0) + 1
            t = self._find(b)
            if t is not None and b in pre:
                self.tiers[t].touch(b)
                self.tiers[t].stats.hits += 1
                self.stats.hits += 1
                self._promote_if_worthy(b, t)
        # blocks displaced out of the stack by this very ensure: ONE
        # batched re-read, accounted like every other backing-store read
        gone = sorted({int(b) for b in ids if self._find(int(b)) is None})
        key = self._read_store(store, np.asarray(gone, np.int64)) if gone else None
        gone_off = {b: off for off, b in enumerate(gone)}
        srcs = []
        for b in ids:
            b = int(b)
            t = self._find(b)
            if t is None:
                srcs.append(("batch", key, gone_off[b]))
            else:
                srcs.append(self._source(t, self.tiers[t].peek(b)[0]))
        return self._flush(srcs)

    def _record_hit_observations(self, ids: np.ndarray, miss_set: set[int]) -> None:
        """Close the pricing loop for resident hits: each tier's quoted vs
        backend-observed io_time for the ids this gather served from it."""
        from repro_torch.storage.calibration import measurable

        lg, be = self.ledger, self.timing_backend
        res = np.unique(np.asarray([int(b) for b in ids if int(b) not in miss_set],
                                   dtype=np.int64))
        if res.size == 0:
            return
        where = self.residency_tier(res)
        for t, tier in enumerate(self.tiers):
            sel = res[where == t]
            if sel.size and measurable(be, tier.name):
                pred = tier.cost.io_time(sel) * self._corr(tier.name)
                lg.record("placement", tier.name, pred, be.io_seconds(tier.name, sel))

    # ------------------------------------------------------------- reporting
    def tier_counters(self) -> dict[str, int]:
        """Flat monotonic per-tier counters, keyed ``"<tier>.<counter>"``
        (``hbm.hits``, ``dram.demotions_in``, ...): the per-wave placement
        ledger ``run_batch`` diffs into ``BatchQueryResult.tier_stats``."""
        out: dict[str, int] = {}
        for tier in self.tiers:
            s = tier.stats
            for k in ("hits", "admissions", "promotions_in", "demotions_in",
                      "demotions_out", "evictions", "invalidations"):
                out[f"{tier.name}.{k}"] = getattr(s, k)
        return out

    def snapshot(self) -> dict:
        """Aggregate + per-tier stats (gauges included), for logging."""
        return {
            "aggregate": self.stats.snapshot(),
            "tiers": {t.name: t.stats.snapshot() for t in self.tiers},
        }


def make_tier_stack(
    hbm_bytes: int | None,
    dram_bytes: int | None = None,
    backing: CostModel | str = "hdd",
    block_bytes: int = 256 * 1024,
    policy: PlacementPolicy | None = None,
    device_fill: bool | None = None,
    device: str | torch.device = "cuda",
) -> TierStack:
    """The canonical two-tier stack: a slot pool on the card over host
    memory.

    ``hbm_bytes`` / ``dram_bytes`` are the tiers' byte budgets (``None`` =
    unbounded); ``backing`` the backing store's model or a preset name;
    ``block_bytes`` the block size fed to the ``hbm`` / ``dram`` presets;
    ``policy``, ``device_fill`` and ``device`` go to :class:`TierStack`.
    """
    if isinstance(backing, str):
        backing = make_cost_model(backing, block_bytes)
    return TierStack(
        tiers=[
            Tier("hbm", hbm_bytes, make_cost_model("hbm", block_bytes), device=True),
            Tier("dram", dram_bytes, make_cost_model("dram", block_bytes)),
        ],
        backing=backing,
        policy=policy,
        device_fill=device_fill,
        device=device,
    )
