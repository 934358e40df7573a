"""Batched any-k evaluation: the device-resident wave and the host-mirror loop.

Counterpart of ``repro/core/multi_query.py``.  Q concurrent
``(predicates, k)`` queries are evaluated as one unit:

1. **One combine** — the wave's predicate rows are ⊕-combined into a
   ``[Q, λ]`` matrix on the device, each under its query's op
   (:func:`repro_torch.core.density_map.combine_densities_wave`, one launch
   of the ``density_combine_batch`` kernel); a query's
   :class:`~repro_torch.core.predicates.Predicate` tree is compiled on the
   device beside it (:func:`_wave_rows`).
2. **Plan rounds**, in one of two loops:

   * the **device wave** (``run_batch(plan_on_host=False)``): a
     :class:`DevicePlanState` (base combined matrix, exclusion masks, last
     round's prefix cursors) stays on the device across refill rounds; each
     round replays the host's choices onto the exclusion masks, re-plans
     every query (sort → prefix scan → cut → θ-stats → window) and ships ONE
     packed ``[Q, λ+3]`` plan to the host (``BatchQueryResult.
     device_transfers``);
   * the **host-mirror loop** (``plan_on_host=True``, the reference's
     default and oracle): each round combines the active queries on the
     device, brings the ``[Qa, λ]`` rows to the host to key the
     :class:`~repro_torch.core.block_cache.PlanOrderCache` by row bytes,
     sorts and scans only the unique rows the memo misses (and windows only
     the unique (row, need) pairs it misses) on the device, and cuts each
     query's THRESHOLD prefix on the host.

   Both make the §7.2 ``auto`` cost comparison on the host (the cost model
   is float64 host code), and both plan ``forward_optimal`` queries with
   the host DP of Algorithm 3 on a host copy of their rows, as the
   reference does.
3. **Union fetch** — each round's deduplicated ascending union goes through
   the engine-lifetime :class:`~repro_torch.core.block_cache.BlockLRUCache`
   (one store read of the misses); when the cache holds the whole union, one
   gather serves the wave, each query's predicate mask is evaluated on the
   device over its own blocks, and the matching records come back to the
   host in the reference's order (the query's blocks ascending, then rows)
   in one packed copy a round (:func:`_wave_records`).
   When the byte budget cannot hold the union, each query reads through
   ``get_many`` as in the reference.

Per-query results (records, blocks, rounds, algorithm) are byte-identical
to the reference's ``run_batch`` and to Q separate ``any_k`` calls, and the
batch's ``store_blocks_fetched``, ``cache_hits`` and ``modeled_store_io_s``
come from the cache's counters with the reference's meaning.

With a sharded ``planner`` (:class:`repro_torch.core.sharded.DistributedAnyK`,
``run_batch(planner=...)`` or ``engine.attach_mesh``) every rank runs the
same loop and each round's plans come from collectives over the λ-sharded
wave: in the device wave each rank combines its λ-shard of the joiners'
rows (#3) and the round plans the shards
(:meth:`~repro_torch.core.sharded.DistributedAnyK.device_round_fn`); in the
host-mirror loop the memo misses go to the planner's wave methods.  Plans
and results equal the unsharded ones.  Reads go through the engine's block
cache or :class:`~repro_torch.storage.tiers.TierStack`
(``BatchQueryResult.tier_stats``).

With ``engine.obs`` (a :class:`~repro_torch.obs.TraceRecorder`) a batch is
a ``batch.run`` span, each host-mirror round a ``plan.round`` span, each
union read a ``wave.execute`` span, and each device round a
``device.transfer`` and a ``plan.round`` event; their attributes come from
host copies the loops already hold (the device wave's from its one packed
transfer), so tracing adds no synchronisation.  The port's host steps are
spans of their own (:data:`~repro_torch.obs.trace.HOST_STEP_SPANS`): a
device round is a ``plan.device_round`` of ``plan.join``, ``plan.device``
and ``plan.choose``; a union read is ``wave.read``, ``wave.records`` (a
``records.select`` a chunk, then ``records.copy`` and ``records.split``)
and ``wave.bookkeep``.  ``wave.read`` carries the round's ``union_blocks``
and the ``gather_bytes`` its one union gather wrote; ``wave.records`` the
``records`` it extracted, the ``d2h_bytes`` and the ``d2h_copies`` of their
one packed copy to the host, and the ``pair_rows`` its masks covered; all
counted only while tracing.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.density_map import AND, OR, combine_densities_wave, pack_row_matrix
from repro_torch.core.forward_optimal import forward_optimal_faithful
from repro_torch.core.predicates import Predicate
from repro_torch.core.threshold import threshold_cut, threshold_sort_batch
from repro_torch.core.two_prong import two_prong_select_batch
from repro_torch.kernels.density_combine import exclusion_ids
from repro_torch.kernels.plan_wave import (
    apply_chosen, join_wave_slots, pack_plan, plan_wave_from_combined, unpack_plan,
)
from repro_torch.obs.trace import span_or_null

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.engine import NeedleTailEngine, QueryResult

_ALGOS = ("threshold", "two_prong", "auto", "forward_optimal")
# (query, block) pairs whose predicate masks are evaluated per launch group;
# bounds the [pairs, R] temporaries (4096 × 8192 rows × 4 B = 128 MiB)
_PAIR_CHUNK = 4096


def check_algo(algo: str) -> None:
    """Raise ``ValueError`` for an algorithm the engine does not know."""
    if algo not in _ALGOS:
        raise ValueError(f"unknown algo {algo!r}")


def check_predicates(predicates, op: str) -> None:
    """A query's predicates are a :class:`~repro_torch.core.predicates.
    Predicate` tree or a non-empty sequence of ``(attr, value)`` pairs, and
    its op is AND or OR."""
    if op not in (AND, OR):
        raise ValueError(f"unknown op {op!r}")
    if isinstance(predicates, Predicate):
        return
    pairs = isinstance(predicates, (list, tuple)) and len(predicates) > 0 and all(
        isinstance(p, (list, tuple)) and len(p) == 2 for p in predicates
    )
    if not pairs:
        raise TypeError("predicates must be a Predicate tree or a non-empty sequence of "
                        f"(attr, value) pairs, not {predicates!r}")


def _check_query(q: "BatchQuery") -> None:
    if q.algo is not None:
        check_algo(q.algo)
    check_predicates(q.predicates, q.op)


@dataclasses.dataclass(frozen=True)
class BatchQuery:
    """One wave member: a LIMIT-k query over ⊕-combined (attr, value) pairs
    or a :class:`~repro_torch.core.predicates.Predicate` tree (``op`` is
    then not read).

    ``algo`` overrides the batch-level algorithm for this query; ``None``
    inherits the ``algo`` argument of the ``any_k_batch`` call.
    """

    predicates: Sequence[tuple[int, int]] | Predicate
    k: int
    op: str = AND
    algo: str | None = None


@dataclasses.dataclass
class BatchQueryResult:
    """Per-query results plus the wave's accounting."""

    results: list["QueryResult"]
    unique_blocks_fetched: np.ndarray  # every block touched, first-touch order
    blocks_requested_total: int  # Σ over queries/rounds of planned fetches
    rounds: int  # waves executed
    cpu_time_s: float  # host wall time of the whole wave (ends synchronised)
    modeled_io_s: float  # one shared pass over unique touched blocks
    # blocks read from the store's slabs this batch: the engine's block
    # cache misses (0 on a fully warm cache), as in the reference
    store_blocks_fetched: int = 0
    modeled_store_io_s: float = 0.0  # one pass over only the blocks read
    cache_hits: int = 0  # block reads served from the engine's block cache
    # device wave only: device→host plan transfers, one packed plan per
    # planning round, so rounds <= device_transfers <= rounds + 1 (a last
    # round whose plans come up empty ends the loop); 0 on the host loop
    device_transfers: int = 0
    active_per_round: list = dataclasses.field(default_factory=list)
    # tiered storage only (engine.block_cache is a storage.TierStack): the
    # batch's per-tier placement deltas, "<tier>.<counter>"; None when flat
    tier_stats: dict | None = None
    # host wall seconds of each planning round (plan + fetch), synchronised
    round_seconds: list = dataclasses.field(default_factory=list)

    @property
    def num_queries(self) -> int:
        return len(self.results)

    @property
    def dedup_ratio(self) -> float:
        """Planned block reads per unique block touched (1.0 when empty)."""
        u = int(self.unique_blocks_fetched.size)
        if u == 0 or self.blocks_requested_total == 0:
            return 1.0
        return float(self.blocks_requested_total) / u

    @property
    def store_dedup_ratio(self) -> float:
        """Planned block reads per store read: ``inf`` on a fully warm
        cache, 1.0 for an empty batch."""
        if self.blocks_requested_total == 0:
            return 1.0
        if self.store_blocks_fetched == 0:
            return float("inf")
        return float(self.blocks_requested_total) / self.store_blocks_fetched


@dataclasses.dataclass
class _QueryState:
    query: BatchQuery
    need: int
    got: int = 0
    rounds: int = 0
    done: bool = False
    used_algo: str = ""
    exclude: np.ndarray = dataclasses.field(
        default_factory=lambda: np.asarray([], dtype=np.int64)
    )
    planned: list[np.ndarray] = dataclasses.field(default_factory=list)
    rec_blocks: list[np.ndarray] = dataclasses.field(default_factory=list)
    rec_rows: list[np.ndarray] = dataclasses.field(default_factory=list)
    meas: list[np.ndarray] = dataclasses.field(default_factory=list)


def new_query_state(query: "BatchQuery | tuple") -> _QueryState:
    """Fresh per-query refill state (satisfied at once when ``k <= 0``)."""
    q = query if isinstance(query, BatchQuery) else BatchQuery(*query)
    _check_query(q)
    return _QueryState(query=q, need=q.k, done=(q.k <= 0))


@dataclasses.dataclass
class DevicePlanState:
    """Round-carried device state of the wave planner.

    ``combined0`` is the base ⊕-combined wave matrix (exclusion-free; with a
    sharded planner this rank's ``[Qb, λ_local]`` shard of it);
    ``excl`` the per-query exclusion mask the device updates itself from the
    host's choice codes (:func:`repro_torch.kernels.plan_wave.apply_chosen`);
    ``th_mask`` / ``tp_win`` the previous round's THRESHOLD prefix and
    TWO-PRONG window.  ``transfers`` counts the device→host plan transfers.
    """

    combined0: torch.Tensor  # [Qb, λ] f32 ([Qb, λ_local] when sharded)
    excl: torch.Tensor  # [Qb, λ] bool
    th_mask: torch.Tensor  # [Qb, λ] bool
    tp_win: torch.Tensor  # [Qb, 2] i32
    transfers: int = 0


def _bucket(n: int) -> int:
    """Next power of two ≥ n (the reference pads the wave's Q axis so)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _local_round_fn(records_per_block: int):
    """The single-device round of the device wave: replay the host's
    choices onto the exclusion mask, re-plan every row
    (:func:`~repro_torch.kernels.plan_wave.plan_wave_from_combined`) and
    pack the round's plans for its one transfer.  Returns ``(packed, excl,
    th_mask, tp_win)``; a sharded planner's ``device_round_fn`` has the same
    form."""

    def round_fn(combined0, excl, th_prev, tp_prev, chosen_prev, needs):
        excl = apply_chosen(excl, th_prev, tp_prev, chosen_prev)
        res = plan_wave_from_combined(combined0, excl, needs, records_per_block)
        packed = pack_plan(res.th_mask, res.n_sel, res.tp_start, res.tp_end)
        return packed, excl, res.th_mask, torch.stack([res.tp_start, res.tp_end], dim=1)

    return round_fn


class DeviceWave:
    """A slot-pooled device-resident wave planner.

    Owns a fixed ``[Qb, λ]`` :class:`DevicePlanState` whose rows are slots:
    queries :meth:`join` a slot between rounds and :meth:`leave` when they
    are satisfied.  Departures are host-side only (the row's choice code
    goes to -1 and its outputs are never decoded); joins are combined and
    seated in one batch at the top of the next :meth:`plan_round`.  Rows are
    planned independently, so an occupant's plans do not depend on what the
    other slots hold, and each round ships exactly one packed transfer.
    With a sharded ``planner`` the base rows are this rank's λ-shards and the
    round is the planner's.
    """

    def __init__(self, engine: "NeedleTailEngine", n_slots: int,
                 default_algo: str = "auto", planner=None):
        check_algo(default_algo)
        self.engine = engine
        self.planner = planner
        self.default_algo = default_algo
        self.n_slots = n_slots
        self.lam = engine.store.num_blocks
        self.rpb = engine.store.records_per_block
        self.qb = _bucket(max(n_slots, 1))
        if planner is None:
            self.round_fn, width = _local_round_fn(self.rpb), self.lam
        else:
            self.round_fn = planner.device_round_fn(self.lam, self.rpb)
            width = planner.local_width(self.lam)
        dev = engine.device
        self.state = DevicePlanState(
            combined0=torch.zeros((self.qb, width), dtype=torch.float32, device=dev),
            excl=torch.zeros((self.qb, self.lam), dtype=torch.bool, device=dev),
            th_mask=torch.zeros((self.qb, self.lam), dtype=torch.bool, device=dev),
            tp_win=torch.zeros((self.qb, 2), dtype=torch.int32, device=dev),
        )
        self.chosen = np.full((self.qb,), -1, np.int8)
        self.slots: list[_QueryState | None] = [None] * n_slots
        self._joining: list[int] = []

    @property
    def transfers(self) -> int:
        return self.state.transfers

    def busy_slots(self) -> list[int]:
        return [s for s in range(self.n_slots) if self.slots[s] is not None]

    def join(self, slot: int, st: _QueryState) -> None:
        if self.slots[slot] is not None:
            raise ValueError(f"slot {slot} is occupied")
        self.slots[slot] = st
        self.chosen[slot] = -1
        self._joining.append(slot)

    def leave(self, slot: int) -> _QueryState | None:
        st = self.slots[slot]
        self.slots[slot] = None
        self.chosen[slot] = -1
        if slot in self._joining:  # joined and left without ever planning
            self._joining.remove(slot)
        return st

    def _flush_joins(self) -> None:
        """The queued joiners' rows in one :func:`_wave_rows` (one ⊕-combine
        for the pair lists, #2, or #3 on this rank's λ-shard with a sharded
        planner; Predicate trees compiled beside it), then one scatter seats
        them all.  Traced as ``plan.join``."""
        if not self._joining:
            return
        with span_or_null(self.engine.obs, "plan.join"):
            joining, self._joining = self._joining, []
            dev = self.engine.device
            rows = _wave_rows(self.engine, [self.slots[slot].query for slot in joining],
                              planner=self.planner)
            excl_rows = np.zeros((len(joining), self.lam), dtype=bool)
            for j, slot in enumerate(joining):
                ex = self.slots[slot].exclude
                if ex.size:
                    excl_rows[j, ex] = True
            ds = self.state
            ds.combined0, ds.excl, ds.th_mask, ds.tp_win = join_wave_slots(
                ds.combined0, ds.excl, ds.th_mask, ds.tp_win,
                torch.as_tensor(joining, device=dev), rows,
                torch.from_numpy(excl_rows).to(dev),
            )

    def plan_round(self) -> tuple[list[_QueryState], list[np.ndarray]]:
        """One device planning round over the current occupants.

        Returns ``(active_states, wave_blocks)`` in slot order, ready for
        :func:`_execute_wave`; both are empty (and nothing is shipped) when
        no slot is occupied.  Traced as a ``plan.device_round`` span.
        """
        with span_or_null(self.engine.obs, "plan.device_round"):
            return self._plan_round()

    def _plan_round(self) -> tuple[list[_QueryState], list[np.ndarray]]:
        self._flush_joins()
        active_slots = self.busy_slots()
        active = [self.slots[s] for s in active_slots]
        if not active:
            return [], []
        engine = self.engine
        dev = engine.device
        ds = self.state
        obs = engine.obs
        with span_or_null(obs, "plan.device"):
            needs_np = np.ones((self.qb,), np.float32)
            for s, st in zip(active_slots, active):
                needs_np[s] = float(st.need)
            packed, ds.excl, ds.th_mask, ds.tp_win = self.round_fn(
                ds.combined0, ds.excl, ds.th_mask, ds.tp_win,
                torch.from_numpy(self.chosen).to(dev), torch.from_numpy(needs_np).to(dev),
            )
            # the round's single device→host transfer: the packed [Qb, λ+3]
            # plan, into a reused buffer that the round's choice reads
            packed_np = _STAGING.copy("plan", packed).numpy()
            ds.transfers += 1
            if obs is not None:
                obs.event("device.transfer", n=ds.transfers, nbytes=int(packed_np.nbytes),
                          n_active=len(active))
        with span_or_null(obs, "plan.choose"):
            wave_blocks = self._choose(active_slots, active, packed_np)
            if obs is not None:
                union = _union(wave_blocks)
                obs.event("plan.round", site="device", n_active=len(active),
                          n_blocks=int(union.size), choices=_choices(active),
                          predicted_io_s=float(engine.cost.io_time(union)))
        return active, wave_blocks

    def _choose(self, active_slots: list[int], active: list[_QueryState],
                packed_np: np.ndarray) -> list[np.ndarray]:
        """Each occupant's blocks from the round's packed plan: its planner's
        choice (``auto``: both costed on the host, the cheaper taken, and its
        choice code noted for the next round's replay), less its exclusions."""
        engine = self.engine
        th_mask, _, tps, tpe = unpack_plan(packed_np, self.lam)
        # forward_optimal occupants plan on the host DP, from the host mirror
        # of their rows (exclusions applied), as the reference does
        fo_active = [st for st in active
                     if (st.query.algo or self.default_algo) == "forward_optimal"]
        fo_plans: dict[int, np.ndarray] = {}
        if fo_active:
            fo_rows = _combined_matrix(engine, fo_active).cpu().numpy()
            for st, comb in zip(fo_active, fo_rows):
                sel, _ = forward_optimal_faithful(comb, st.need, self.rpb, engine.cost)
                fo_plans[id(st)] = np.asarray(sel, dtype=np.int64)
        self.chosen = np.full((self.qb,), -1, np.int8)
        wave_blocks: list[np.ndarray] = []
        for s, st in zip(active_slots, active):
            a = st.query.algo or self.default_algo
            if a == "forward_optimal":
                plan = fo_plans[id(st)]
                st.used_algo = a
            elif a == "threshold":
                plan = np.flatnonzero(th_mask[s]).astype(np.int64)
                self.chosen[s] = 0
                st.used_algo = a
            elif a == "two_prong":
                plan = np.arange(int(tps[s]), int(tpe[s]), dtype=np.int64)
                self.chosen[s] = 1
                st.used_algo = a
            else:  # auto — §7.2: cost both on the host, take the cheaper
                bt = np.flatnonzero(th_mask[s]).astype(np.int64)
                b2 = np.arange(int(tps[s]), int(tpe[s]), dtype=np.int64)
                ct, c2 = engine.plan_cost(bt), engine.plan_cost(b2)
                if ct <= c2:
                    plan, self.chosen[s], st.used_algo = bt, 0, "threshold"
                else:
                    plan, self.chosen[s], st.used_algo = b2, 1, "two_prong"
            blocks = np.setdiff1d(plan, st.exclude)
            if blocks.size == 0:
                st.done = True  # plan exhausted: nothing new to read
            wave_blocks.append(blocks)
        return wave_blocks


def _union(wave_blocks: list[np.ndarray]) -> np.ndarray:
    """The round's deduplicated ascending block union."""
    return np.unique(np.concatenate(wave_blocks)) if wave_blocks else np.asarray([], np.int64)


def _choices(active: list[_QueryState]) -> dict[str, int]:
    """How many of the round's states took each planner."""
    choices: dict[str, int] = {}
    for st in active:
        choices[st.used_algo] = choices.get(st.used_algo, 0) + 1
    return choices


def _predicate_table(states: list[_QueryState]):
    """Per-query ``(attrs [J, γ_max], values [J, γ_max], is_or [J])`` of the
    pair lists, with attr -1 marking a padded slot; a Predicate tree's row
    is all padding (its mask is the tree's own)."""
    pairs = [st.query.predicates for st in states]
    gmax = max([len(p) for p in pairs if not isinstance(p, Predicate)], default=1)
    attrs = np.full((len(states), gmax), -1, np.int64)
    vals = np.zeros((len(states), gmax), np.int64)
    for j, p in enumerate(pairs):
        if not isinstance(p, Predicate):
            for g, (a, v) in enumerate(p):
                attrs[j, g], vals[j, g] = a, v
    is_or = np.asarray([st.query.op == OR for st in states])
    return attrs, vals, is_or


class _HostStaging(threading.local):
    """Reused host buffers that a device round's int32 results land in, one
    a use and thread, grown by doubling and never shrunk, so a serving
    loop's warm-up sizes them and its later rounds reuse them.  Pinned where
    the source is on a card, so its one copy runs at the card's copy
    bandwidth (the choice ``storage.tiers.stage`` makes); plain memory on
    the CPU.  What :meth:`copy` returns is valid until the next copy to the
    same use."""

    def __init__(self):
        self.bufs: dict[tuple[str, bool], torch.Tensor] = {}
        self.copies = 0  # copies made, which ``wave.records`` counts

    def copy(self, use: str, src: torch.Tensor) -> torch.Tensor:
        """``src`` (int32) copied into the buffer of ``use``, on the current
        stream, then that stream synchronised; returns the filled part in
        ``src``'s shape."""
        pinned = src.device.type == "cuda"
        n = src.numel()
        buf = self.bufs.get((use, pinned))
        if buf is None or buf.numel() < n:
            cap = max(n, 2 * (0 if buf is None else buf.numel()))
            buf = self.bufs[use, pinned] = torch.empty(cap, dtype=torch.int32, pin_memory=pinned)
        host = buf[:n].view(src.shape)
        host.copy_(src, non_blocking=True)
        self.copies += 1
        if pinned:
            torch.cuda.current_stream(src.device).synchronize()
        return host


_STAGING = _HostStaging()


def _wave_records(
    slabs, union: np.ndarray, states: list[_QueryState], blocks: list[np.ndarray], obs=None,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Extract each query's matching records over its own blocks from the
    round's union slabs ``(dims [U, R, r], measures [U, R, s], valid [U, R])``
    on the device.

    Returns, per query, ``(record_block, record_row, measures)`` in the
    reference's order (the query's blocks ascending, then rows): int64,
    int64 and float32 ``[n, s]``, slices of arrays the round owns.  Each
    (query, block) pair's mask is the reference's ``predicate_mask`` fold
    (AND over the pairs from ``True``, OR from ``False``; padded slots are
    the identity), or for a Predicate tree its ``mask`` over the query's
    pairs of the group, ANDed with the valid rows.

    ``nonzero`` already yields the records in that order (pairs grouped by
    query, rows ascending), so nothing is reordered: on the device each
    record's pair index and row (int64, as ``nonzero`` gives them) and its
    measures' bits are packed into one buffer, a column after the other; the
    round makes one copy of it into a reused host buffer, then one owned
    copy (each record's block id taken from its pair) whose slices, at the
    queries' pair bounds, are the queries' records.  Results keep that copy
    alive, so it is fresh memory each round, and one array a column a round
    fills far faster than one small array a query and column.

    With ``obs`` this is a ``wave.records`` span: a ``records.select`` a
    chunk of pairs (its copies to the card, the masks, the synchronising
    ``nonzero``), then one ``records.copy`` (the packing and the one copy
    to the host) and one ``records.split`` (the round's owned copy); the
    span carries the ``records``, the ``d2h_bytes`` and the ``d2h_copies``
    of the copy to the host, and the ``pair_rows`` its masks covered ((query,
    block) pairs × rows a block).
    """
    with span_or_null(obs, "wave.records") as sp:
        copies0 = _STAGING.copies
        dims_u, meas_u, valid_u = slabs
        dev = dims_u.device
        r, s = dims_u.shape[1], meas_u.shape[2]
        sizes = np.asarray([b.size for b in blocks])
        pos = np.concatenate([np.searchsorted(union, b) for b in blocks])
        owner = np.repeat(np.arange(len(states)), sizes)
        attrs, vals, is_or = _predicate_table(states)
        trees = np.asarray([isinstance(st.query.predicates, Predicate) for st in states])
        rows_idx = torch.arange(r, device=dev)[None, :]
        chunks = []
        for lo in range(0, pos.size, _PAIR_CHUNK):
            with span_or_null(obs, "records.select"):
                p = torch.from_numpy(pos[lo:lo + _PAIR_CHUNK]).to(dev)
                own = owner[lo:lo + _PAIR_CHUNK]
                a_p = torch.from_numpy(attrs[own]).to(dev)  # [P, γ_max]
                v_p = torch.from_numpy(vals[own]).to(dev)
                acc_and = torch.ones((p.numel(), r), dtype=torch.bool, device=dev)
                acc_or = torch.zeros_like(acc_and)
                for g in range(attrs.shape[1]):
                    pad = (a_p[:, g] < 0)[:, None]
                    col = dims_u[p[:, None], rows_idx, a_p[:, g].clamp(min=0)[:, None]]
                    eq = col == v_p[:, g][:, None]
                    acc_and &= eq | pad
                    acc_or |= eq & ~pad
                or_p = torch.from_numpy(is_or[own]).to(dev)[:, None]
                mask = torch.where(or_p, acc_or, acc_and)
                for j in np.unique(own[trees[own]]):
                    sel = torch.from_numpy(np.flatnonzero(own == j)).to(dev)
                    mask[sel] = states[j].query.predicates.mask(dims_u[p[sel]])
                mask &= valid_u[p]
                hit = torch.nonzero(mask)  # [n, 2] (pair, row), row-major order
                chunks.append((lo, p, hit))
        with span_or_null(obs, "records.copy"):
            # int32 words: the round's pair indices, then the rows (int64
            # each), then the measures' float32 bits [n, s]
            n = sum(int(hit.shape[0]) for _, _, hit in chunks)
            packed = torch.empty(n * (4 + s), dtype=torch.int32, device=dev)
            pair_col = packed[:2 * n].view(torch.int64)
            row_col = packed[2 * n:4 * n].view(torch.int64)
            meas_col = packed[4 * n:].view(n, s)
            o = 0
            for lo, p, hit in chunks:
                m = hit.shape[0]
                torch.add(hit[:, 0], lo, out=pair_col[o:o + m])
                row_col[o:o + m].copy_(hit[:, 1])
                meas_col[o:o + m].copy_(meas_u[p[hit[:, 0]], hit[:, 1]].view(torch.int32))
                o += m
            host = _STAGING.copy("records", packed)
        with span_or_null(obs, "records.split"):
            # the round's own copy (the next round overwrites the staging
            # buffer); each query's records are slices of it
            h = host.numpy()
            ids = h[:4 * n].view(np.int64)
            pair = ids[:n]
            blk = np.concatenate(blocks)[pair]
            rows = ids[n:].copy()
            meas = h[4 * n:].view(np.float32).reshape(n, s).copy()
            rb = np.searchsorted(pair, np.concatenate([[0], np.cumsum(sizes)]))
            out = [(blk[b0:b1], rows[b0:b1], meas[b0:b1]) for b0, b1 in zip(rb[:-1], rb[1:])]
        if obs is not None:
            sp.set(records=n, d2h_bytes=int(packed.nbytes), d2h_copies=_STAGING.copies - copies0,
                   pair_rows=int(pos.size) * r)
    return out


def _execute_wave(
    engine: "NeedleTailEngine",
    active: list[_QueryState],
    wave_blocks: list[np.ndarray],
    touched: list[int],
    touched_set: set[int],
) -> tuple[bool, int]:
    """Read one round's deduplicated union through the engine's block cache
    and apply each query's §4.1 post-fetch bookkeeping (records, exclusion
    growth, refill accounting).  Shared by the device and host-mirror loops,
    so they differ only in where plans are computed.  Returns
    ``(progressed, blocks_requested_delta)``."""
    obs = engine.obs
    if obs is None:
        return _execute_wave_body(engine, active, wave_blocks, touched, touched_set)
    with obs.span("wave.execute", n_active=len(active)) as sp:
        progressed, requested = _execute_wave_body(engine, active, wave_blocks, touched,
                                                   touched_set)
        sp.set(requested=requested, progressed=progressed,
               satisfied=sum(1 for st in active if st.done))
    return progressed, requested


def _execute_wave_body(
    engine: "NeedleTailEngine",
    active: list[_QueryState],
    wave_blocks: list[np.ndarray],
    touched: list[int],
    touched_set: set[int],
) -> tuple[bool, int]:
    obs = engine.obs
    cache = engine.block_cache
    with span_or_null(obs, "wave.read") as sp:
        union = _union(wave_blocks)
        if union.size:
            for b in union:
                if int(b) not in touched_set:
                    touched_set.add(int(b))
                    touched.append(int(b))
            cache.ensure(engine.store, union)
        members = [(st, b) for st, b in zip(active, wave_blocks) if b.size]
        if not members:
            return False, 0
        blocks = [b for _, b in members]
        slabs = cache.get_wave(union, blocks)
        if obs is not None:  # no union gather where the budget cannot hold the union
            sp.set(union_blocks=int(union.size),
                   gather_bytes=0 if slabs is None else sum(int(t.nbytes) for t in slabs))
    if slabs is not None:
        recs = _wave_records(slabs, union, [st for st, _ in members], blocks, obs)
    else:  # the budget cannot hold the union: the reference's per-query reads
        # (a ``wave.records`` span without counters: the copies are the engine's)
        with span_or_null(obs, "wave.records"):
            recs = [
                engine._records(st.query.predicates, st.query.op, b,
                                cache.get_many(engine.store, b))
                for st, b in members
            ]
    with span_or_null(obs, "wave.bookkeep"):
        requested = 0
        for (st, b), (rb, rr, rm) in zip(members, recs):
            st.rec_blocks.append(rb)
            st.rec_rows.append(rr)
            st.meas.append(rm)
            st.planned.append(b)
            requested += int(b.size)
            st.got += int(rb.size)
            st.exclude = np.concatenate([st.exclude, b])
            st.need = st.query.k - st.got
            st.rounds += 1
            if st.got >= st.query.k:
                st.done = True
    return True, requested


def _device_plan_loop(
    engine: "NeedleTailEngine",
    states: list[_QueryState],
    algo: str,
    planner,
    touched: list[int],
    touched_set: set[int],
    active_counts: list[int],
    round_seconds: list[float],
) -> tuple[int, int, int]:
    """The device-resident refill loop: one :class:`DeviceWave` slot per
    query, each leaving the round it is satisfied.  Returns ``(waves,
    blocks_requested_total, device_transfers)``."""
    wave = DeviceWave(engine, len(states), default_algo=algo, planner=planner)
    for i, st in enumerate(states):
        if not st.done:
            wave.join(i, st)
    requested_total = waves = 0
    while waves < engine.max_refills:
        t0 = time.perf_counter()
        active, wave_blocks = wave.plan_round()
        if not active:
            break
        progressed, req = _execute_wave(engine, active, wave_blocks, touched, touched_set)
        round_seconds.append(time.perf_counter() - t0)
        requested_total += req
        for s in wave.busy_slots():
            if wave.slots[s].done:
                wave.leave(s)
        if not progressed:
            break
        waves += 1
        active_counts.append(len(active))
    return waves, requested_total, wave.transfers


# --------------------------------------------------------------------------
# The host-mirror loop: the reference's default path and byte-identity oracle.
# --------------------------------------------------------------------------

def _wave_rows(engine: "NeedleTailEngine", queries: list[BatchQuery], exclude=None,
               planner=None) -> torch.Tensor:
    """``[n, λ]`` combined rows of ``queries`` on the engine's device
    (``[n, λ_local]``, this rank's λ-shard, with a sharded ``planner``).
    The pair lists take one ⊕-combine, each under its own op, with each
    query's ``exclude`` blocks zeroed in it (one #2 launch; #3 on the
    rank's slab with a planner, which takes no exclusions); each Predicate
    tree is compiled on the same index (or slab), then its excluded blocks
    set to +0.0."""
    index = engine.store.index
    trees = [j for j, q in enumerate(queries) if isinstance(q.predicates, Predicate)]
    pairs = [j for j, q in enumerate(queries) if not isinstance(q.predicates, Predicate)]

    def combine(js):
        rm = pack_row_matrix(index.vocab, [queries[j].predicates for j in js])
        ops = [queries[j].op for j in js]
        if planner is not None:
            return planner.combine_wave(index.densities, rm, ops)
        return combine_densities_wave(index.densities, rm, ops,
                                      None if exclude is None else [exclude[j] for j in js])

    if not trees:
        return combine(pairs)
    width = index.num_blocks if planner is None else planner.local_width(index.num_blocks)
    out = torch.empty((len(queries), width), dtype=torch.float32, device=engine.device)
    if pairs:
        out[torch.as_tensor(pairs, device=engine.device)] = combine(pairs)
    for j in trees:
        pred = queries[j].predicates
        row = pred.density(index) if planner is None else planner.predicate_row(index, pred)
        if exclude is not None and len(exclude[j]):
            ids = exclusion_ids(exclude[j], width)
            row[torch.from_numpy(ids).to(engine.device).long()] = 0.0
        out[j] = row
    return out


def _combined_matrix(engine: "NeedleTailEngine", states: list[_QueryState]) -> torch.Tensor:
    """``[Qa, λ]`` combined densities on the engine's device, exclusions
    applied: one ``density_combine_batch`` launch for the pair lists,
    whatever their ⊕ ops, with each query's excluded blocks zeroed in it,
    and each Predicate tree compiled beside it (:func:`_wave_rows`)."""
    return _wave_rows(engine, [st.query for st in states], [st.exclude for st in states])


def _plan_wave(
    engine: "NeedleTailEngine", states: list[_QueryState], algo: str, planner=None,
) -> list[np.ndarray]:
    """One round's plans for ``states`` (all under ``algo``), each
    bit-identical to ``engine.plan`` run per query.

    THRESHOLD plans for any k over one combined row are prefixes of one
    density-sorted order, so the device sorts and scans each *unique* row of
    the round once (unless the plan-order memo holds it) and each query cuts
    its own prefix on the host; TWO-PRONG dedups on (row, need) pairs.

    ``forward_optimal`` runs the host DP on each row of the host mirror
    (sequential by nature), with or without a planner.

    With a sharded ``planner`` the (row, need) pairs the memo misses are
    planned by its wave methods, one collective per planner: THRESHOLD ids
    come back ascending (the same set; the §4.1 fetch sort and the ``auto``
    cost ignore the order) and go to the sharded memo; ``group=1`` windows
    equal the host's and share its memo, while group-aligned windows
    (``two_prong_group > 1``) bypass it so they cannot poison it.
    """
    combined_dev = _combined_matrix(engine, states)
    combined = combined_dev.cpu().numpy()  # the host mirror: row bytes key the memo
    rpb = engine.store.records_per_block
    if algo == "forward_optimal":  # the host DP of Algorithm 3, as the reference
        plans = []
        for st, comb in zip(states, combined):
            sel, _ = forward_optimal_faithful(comb, st.need, rpb, engine.cost)
            plans.append(np.asarray(sel, dtype=np.int64))
            st.used_algo = algo
        return plans
    needs = np.asarray([float(st.need) for st in states], dtype=np.float32)
    qa = len(states)
    row_key = [c.tobytes() for c in combined]
    row_of: dict[bytes, int] = {}
    uniq_rows: list[int] = []
    for i, key in enumerate(row_key):
        if key not in row_of:
            row_of[key] = len(uniq_rows)
            uniq_rows.append(i)
    u_idx = np.asarray([row_of[key] for key in row_key])
    plan_cache = engine.plan_cache

    def rows_on_device(idx: list[int]) -> torch.Tensor:
        return combined_dev[torch.as_tensor(idx, device=engine.device)]

    def threshold_plans() -> list[np.ndarray]:
        entries: list = [None] * len(uniq_rows)
        miss: list[int] = []  # positions in uniq_rows needing a fresh sort
        for j, i in enumerate(uniq_rows):
            hit = plan_cache.get_threshold(row_key[i])
            if hit is not None:
                entries[j] = hit
            else:
                miss.append(j)
        if miss:
            si, sd, cum = threshold_sort_batch(rows_on_device([uniq_rows[j] for j in miss]))
            si, sd, cum = si.cpu().numpy(), sd.cpu().numpy(), cum.cpu().numpy()
            for off, j in enumerate(miss):
                entries[j] = (si[off], sd[off], cum[off])
                plan_cache.put_threshold(row_key[uniq_rows[j]], *entries[j])
        plans = []
        for i in range(qa):
            si_u, sd_u, cum_u = entries[u_idx[i]]
            n = threshold_cut(sd_u, cum_u, needs[i], rpb)
            plans.append(si_u[:n].astype(np.int64))
        return plans

    def plan_unique_pairs(get, plan_misses, put) -> list:
        """Per-query values deduplicated on (unique row, need): memo hits
        from ``get(i)``, one ``plan_misses(miss)`` call for every missed
        pair (one representative query each), stored with ``put(i, v)``."""
        val: dict[tuple[int, float], object] = {}
        miss: list[int] = []
        pending: set[tuple[int, float]] = set()
        for i in range(qa):
            key = (int(u_idx[i]), float(needs[i]))
            if key in val or key in pending:
                continue
            hit = get(i)
            if hit is not None:
                val[key] = hit
            else:
                miss.append(i)
                pending.add(key)
        if miss:
            for i, v in zip(miss, plan_misses(miss)):
                val[(int(u_idx[i]), float(needs[i]))] = v
                put(i, v)
        return [val[(int(u_idx[i]), float(needs[i]))] for i in range(qa)]

    def windows(miss: list[int]) -> list[tuple[int, int]]:
        if planner is not None:
            return planner.two_prong_plan_wave(rows_on_device(miss), needs[miss])
        r = two_prong_select_batch(
            rows_on_device(miss), torch.from_numpy(needs[miss]).to(engine.device), rpb)
        return list(zip(r.start.cpu().tolist(), r.end.cpu().tolist()))

    def two_prong_plans() -> list[np.ndarray]:
        exact = planner is None or planner.two_prong_group == 1
        wins = plan_unique_pairs(
            (lambda i: plan_cache.get_two_prong(row_key[i], float(needs[i])))
            if exact else (lambda i: None),
            windows,
            (lambda i, w: plan_cache.put_two_prong(row_key[i], float(needs[i]), *w))
            if exact else (lambda i, w: None),
        )
        return [np.arange(int(s), int(e), dtype=np.int64) for s, e in wins]

    def threshold_plans_sharded() -> list[np.ndarray]:
        return plan_unique_pairs(
            lambda i: plan_cache.get_sharded_threshold(row_key[i], float(needs[i])),
            lambda miss: planner.threshold_plan_wave(rows_on_device(miss), needs[miss]),
            lambda i, ids: plan_cache.put_sharded_threshold(row_key[i], float(needs[i]), ids),
        )

    if planner is not None:
        threshold_plans = threshold_plans_sharded

    if algo == "threshold":
        plans = threshold_plans()
    elif algo == "two_prong":
        plans = two_prong_plans()
    else:  # auto — §7.2: plan with both, cost both, take the cheaper, per query
        plans = []
        for st, bt, b2 in zip(states, threshold_plans(), two_prong_plans()):
            if engine.plan_cost(bt) <= engine.plan_cost(b2):
                plans.append(bt)
                st.used_algo = "threshold"
            else:
                plans.append(b2)
                st.used_algo = "two_prong"
        return plans
    for st in states:
        st.used_algo = algo
    return plans


def plan_round_host(
    engine: "NeedleTailEngine", active: list[_QueryState], algo: str, planner=None,
) -> list[np.ndarray]:
    """Plan ONE refill round for ``active`` (not-done) states on host
    mirrors: one :func:`_plan_wave` per algorithm group, then each plan
    diffed against the state's exclusions (``setdiff1d``: ascending fetch
    order).  A state whose diff comes up empty is marked done.  Returns the
    per-state block sets, aligned with ``active``."""
    obs = engine.obs
    if obs is None:
        return _plan_round_host_body(engine, active, algo, planner)
    with obs.span("plan.round", site="sharded" if planner is not None else "host",
                  n_active=len(active)) as sp:
        wave_blocks = _plan_round_host_body(engine, active, algo, planner)
        union = _union(wave_blocks)
        sp.set(n_blocks=int(union.size), choices=_choices(active),
               predicted_io_s=float(engine.cost.io_time(union)))
    return wave_blocks


def _plan_round_host_body(
    engine: "NeedleTailEngine", active: list[_QueryState], algo: str, planner=None,
) -> list[np.ndarray]:
    by_algo: dict[str, list[_QueryState]] = {}
    for st in active:
        by_algo.setdefault(st.query.algo or algo, []).append(st)
    plan_of: dict[int, np.ndarray] = {}
    for a, group in by_algo.items():
        for st, plan in zip(group, _plan_wave(engine, group, a, planner)):
            plan_of[id(st)] = plan
    wave_blocks: list[np.ndarray] = []
    for st in active:
        blocks = np.setdiff1d(plan_of[id(st)], st.exclude)
        if blocks.size == 0:
            st.done = True  # plan exhausted: nothing new to read
        wave_blocks.append(blocks)
    return wave_blocks


def _host_plan_loop(
    engine: "NeedleTailEngine",
    states: list[_QueryState],
    algo: str,
    planner,
    touched: list[int],
    touched_set: set[int],
    active_counts: list[int],
    round_seconds: list[float],
) -> tuple[int, int]:
    """The host-mirror refill loop: :func:`plan_round_host`, then one shared
    union read per round.  Returns ``(waves, blocks_requested_total)``."""
    requested_total = waves = 0
    while waves < engine.max_refills:
        active = [st for st in states if not st.done]
        if not active:
            break
        t0 = time.perf_counter()
        wave_blocks = plan_round_host(engine, active, algo, planner)
        progressed, req = _execute_wave(engine, active, wave_blocks, touched, touched_set)
        round_seconds.append(time.perf_counter() - t0)
        requested_total += req
        if not progressed:
            break
        waves += 1
        active_counts.append(len(active))
    return waves, requested_total


def finalize_query_result(
    engine: "NeedleTailEngine",
    st: _QueryState,
    default_algo: str = "auto",
    cpu_time_s: float = 0.0,
):
    """The public :class:`~repro_torch.core.engine.QueryResult` of a
    finished refill state.  A state's record parts are nothing else's (no
    staging buffer lies under them), so one part is the result as it is;
    more are concatenated."""
    from repro_torch.core.engine import QueryResult

    def joined(parts: list[np.ndarray], empty: np.ndarray) -> np.ndarray:
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts) if parts else empty

    all_blocks = (
        np.concatenate(st.planned) if st.planned else np.asarray([], dtype=np.int64)
    )
    return QueryResult(
        record_block=joined(st.rec_blocks, np.asarray([], np.int64)),
        record_row=joined(st.rec_rows, np.asarray([], np.int64)),
        measures=joined(st.meas, np.zeros((0, 0), np.float32)),
        blocks_fetched=all_blocks,
        algo=st.used_algo or (st.query.algo or default_algo),
        cpu_time_s=cpu_time_s,  # the wave's time; a per-query share is not meaningful
        modeled_io_s=engine.cost.io_time(all_blocks),
        plan_rounds=st.rounds,
    )


def run_batch(
    engine: "NeedleTailEngine",
    queries: Sequence[BatchQuery | tuple],
    algo: str = "auto",
    plan_on_host: bool = False,
    planner=None,
) -> BatchQueryResult:
    """Evaluate Q any-k queries as one wave: the device-resident loop, or
    with ``plan_on_host=True`` the host-mirror loop; with a sharded
    ``planner`` (:class:`repro_torch.core.sharded.DistributedAnyK`) each
    round plans over the λ-sharded wave, on every rank of its group.

    Each query's records are byte-identical to ``engine.any_k(q.predicates,
    q.k, q.op, q.algo or algo)`` and to the reference's ``run_batch`` on the
    same data: same blocks planned, same refill rounds, same record order.
    Reads go through the engine-lifetime block cache; the batch's
    ``store_blocks_fetched``, ``cache_hits`` and ``modeled_store_io_s`` are
    its counters' deltas.  With ``engine.obs`` the batch is a ``batch.run``
    span carrying those counts.
    """
    check_algo(algo)
    obs = engine.obs
    sp = None
    if obs is not None:
        sp = obs.span("batch.run", n_queries=len(queries),
                      site="host" if plan_on_host else "device")
        sp.__enter__()
    t0 = time.perf_counter()
    states = [new_query_state(q) for q in queries]
    cache = engine.block_cache
    hits0, store0 = cache.stats.hits, cache.stats.store_blocks_fetched
    tier_fn = getattr(cache, "tier_counters", None)
    tier0 = tier_fn() if tier_fn is not None else None
    touched: list[int] = []  # unique block ids, first-touch order
    touched_set: set[int] = set()
    missed: list[np.ndarray] = []  # id arrays read from the store
    active_counts: list[int] = []
    round_seconds: list[float] = []
    waves = requested_total = device_transfers = 0
    prev_log, cache.fetch_log = cache.fetch_log, missed
    try:
        if engine.store.num_blocks == 0 or all(st.done for st in states):
            pass  # a λ=0 store or an all-satisfied wave: nothing to plan or read
        elif plan_on_host:
            waves, requested_total = _host_plan_loop(
                engine, states, algo, planner, touched, touched_set, active_counts,
                round_seconds)
        else:
            waves, requested_total, device_transfers = _device_plan_loop(
                engine, states, algo, planner, touched, touched_set, active_counts,
                round_seconds)
    finally:
        cache.fetch_log = prev_log
    cpu = time.perf_counter() - t0
    touched_ids = np.asarray(touched, dtype=np.int64)
    if sp is not None:
        sp.set(waves=waves, requested=requested_total, unique_blocks=int(touched_ids.size),
               device_transfers=device_transfers,
               store_blocks_fetched=int(cache.stats.store_blocks_fetched - store0),
               cache_hits=int(cache.stats.hits - hits0))
        sp.__exit__(None, None, None)
    return BatchQueryResult(
        results=[finalize_query_result(engine, st, default_algo=algo, cpu_time_s=cpu)
                 for st in states],
        unique_blocks_fetched=touched_ids,
        blocks_requested_total=requested_total,
        rounds=waves,
        cpu_time_s=cpu,
        modeled_io_s=engine.cost.io_time(touched_ids),
        store_blocks_fetched=int(cache.stats.store_blocks_fetched - store0),
        modeled_store_io_s=sum(engine.cost.io_time(m) for m in missed),
        cache_hits=int(cache.stats.hits - hits0),
        device_transfers=device_transfers,
        active_per_round=active_counts,
        tier_stats=({k: v - tier0[k] for k, v in tier_fn().items()}
                    if tier0 is not None else None),
        round_seconds=round_seconds,
    )
