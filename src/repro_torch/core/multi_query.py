"""Batched any-k evaluation as a device-resident wave.

Counterpart of the device pipeline of ``repro/core/multi_query.py``
(``run_batch(plan_on_host=False)``).  Q concurrent ``(predicates, k)``
queries are evaluated as one unit:

1. **One combine** — the wave's predicate rows are ⊕-combined into a
   ``[Q, λ]`` matrix once, on the device (:func:`repro_torch.kernels.
   plan_wave.combine_wave`).
2. **Device plan rounds** — a :class:`DevicePlanState` (base combined
   matrix, exclusion masks, last round's prefix cursors) stays on the device
   across refill rounds; each round replays the host's choices onto the
   exclusion masks, re-plans every query (sort → cut → θ-stats → window)
   and ships ONE packed ``[Q, λ+3]`` plan to the host
   (``BatchQueryResult.device_transfers``).  The host decodes the plans and
   makes the §7.2 ``auto`` cost comparison (the cost model is float64 host
   code).
3. **Union fetch** — each round's deduplicated ascending union of planned
   blocks is gathered from the store's device slabs (one ``block_gather``
   launch per slab), each query's predicate mask is evaluated there over its
   own blocks, and the matching records come back to the host in the
   reference's order: the query's blocks ascending, then rows.

Per-query results (records, blocks, rounds, algorithm) are byte-identical
to the reference's ``run_batch`` on the same data: the planners compute in
the reference's f32 order (:mod:`repro_torch.core.scan`) and every other
step is exact.  Left for later slices of the port: the host-mirror loop
(``plan_on_host=True``) with its block LRU and plan-order memo,
``Predicate`` trees and ``forward_optimal``, tiers, the sharded planner and
the obs hooks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.density_map import AND, OR, pack_row_matrix
from repro_torch.kernels.plan_wave import (
    apply_chosen, combine_wave, join_wave_slots, pack_plan,
    plan_wave_from_combined, unpack_plan,
)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.engine import NeedleTailEngine, QueryResult

_DEVICE_ALGOS = ("threshold", "two_prong", "auto")
# (query, block) pairs whose predicate masks are evaluated per launch group;
# bounds the [pairs, R] temporaries (4096 × 8192 rows × 4 B = 128 MiB)
_PAIR_CHUNK = 4096


def _check_algo(algo: str) -> None:
    if algo == "forward_optimal":
        raise NotImplementedError(
            "forward_optimal arrives with the slice that ports core/predicates.py "
            "and core/forward_optimal.py (ROADMAP Queue 1)"
        )
    if algo not in _DEVICE_ALGOS:
        raise ValueError(f"unknown algo {algo!r}")


def _check_query(q: "BatchQuery") -> None:
    """Raise for what this slice of the port does not carry."""
    if q.algo is not None:
        _check_algo(q.algo)
    if q.op not in (AND, OR):
        raise ValueError(f"unknown op {q.op!r}")
    preds = q.predicates
    pairs = isinstance(preds, (list, tuple)) and len(preds) > 0 and all(
        isinstance(p, (list, tuple)) and len(p) == 2 for p in preds
    )
    if not pairs:
        raise NotImplementedError(
            "only lists of (attr, value) pairs are supported; Predicate trees "
            "arrive with the slice that ports core/predicates.py (ROADMAP Queue 1)"
        )


@dataclasses.dataclass(frozen=True)
class BatchQuery:
    """One wave member: a LIMIT-k query over ⊕-combined (attr, value) pairs.

    ``algo`` overrides the batch-level algorithm for this query; ``None``
    inherits the ``algo`` argument of the ``any_k_batch`` call.
    """

    predicates: Sequence[tuple[int, int]]
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
    # blocks gathered from the store's device slabs, Σ over rounds of the
    # round's union size (a block planned again in a later round is gathered
    # again: the block cache arrives with a later slice)
    store_blocks_fetched: int = 0
    # device→host plan transfers: one packed plan per planning round, so
    # rounds <= device_transfers <= rounds + 1 (a last round whose plans
    # come up empty ends the loop)
    device_transfers: int = 0
    active_per_round: list = dataclasses.field(default_factory=list)
    # host wall seconds of each planning round (plan + fetch), synchronised
    round_seconds: list = dataclasses.field(default_factory=list)


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

    ``combined0`` is the base ⊕-combined wave matrix (exclusion-free);
    ``excl`` the per-query exclusion mask the device updates itself from the
    host's choice codes (:func:`repro_torch.kernels.plan_wave.apply_chosen`);
    ``th_mask`` / ``tp_win`` the previous round's THRESHOLD prefix and
    TWO-PRONG window.  ``transfers`` counts the device→host plan transfers.
    """

    combined0: torch.Tensor  # [Qb, λ] f32
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


class DeviceWave:
    """A slot-pooled device-resident wave planner.

    Owns a fixed ``[Qb, λ]`` :class:`DevicePlanState` whose rows are slots:
    queries :meth:`join` a slot between rounds and :meth:`leave` when they
    are satisfied.  Departures are host-side only (the row's choice code
    goes to -1 and its outputs are never decoded); joins are combined and
    seated in one batch at the top of the next :meth:`plan_round`.  Rows are
    planned independently, so an occupant's plans do not depend on what the
    other slots hold, and each round ships exactly one packed transfer.
    """

    def __init__(self, engine: "NeedleTailEngine", n_slots: int,
                 default_algo: str = "auto"):
        _check_algo(default_algo)
        self.engine = engine
        self.default_algo = default_algo
        self.n_slots = n_slots
        self.lam = engine.store.num_blocks
        self.rpb = engine.store.records_per_block
        self.qb = _bucket(max(n_slots, 1))
        dev = engine.device
        self.state = DevicePlanState(
            combined0=torch.zeros((self.qb, self.lam), dtype=torch.float32, device=dev),
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
        """One ⊕-combine per op group for the queued joiners, then one
        scatter seats them all."""
        if not self._joining:
            return
        joining, self._joining = self._joining, []
        dev = self.engine.device
        dens = self.engine.store.index.densities
        vocab = self.engine.store.index.vocab
        rows = torch.empty((len(joining), self.lam), dtype=torch.float32, device=dev)
        groups: dict[str, list[int]] = {}
        for j, slot in enumerate(joining):
            groups.setdefault(self.slots[slot].query.op, []).append(j)
        for op, js in groups.items():
            rm = pack_row_matrix(vocab, [self.slots[joining[j]].query.predicates for j in js])
            rows[torch.as_tensor(js, device=dev)] = combine_wave(dens, rm, op)
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
        no slot is occupied.
        """
        self._flush_joins()
        active_slots = self.busy_slots()
        active = [self.slots[s] for s in active_slots]
        if not active:
            return [], []
        engine = self.engine
        dev = engine.device
        ds = self.state
        needs_np = np.ones((self.qb,), np.float32)
        for s, st in zip(active_slots, active):
            needs_np[s] = float(st.need)
        ds.excl = apply_chosen(ds.excl, ds.th_mask, ds.tp_win,
                               torch.from_numpy(self.chosen).to(dev))
        res = plan_wave_from_combined(
            ds.combined0, ds.excl, torch.from_numpy(needs_np).to(dev), self.rpb
        )
        ds.th_mask = res.th_mask
        ds.tp_win = torch.stack([res.tp_start, res.tp_end], dim=1)
        # the round's single device→host transfer: the packed [Qb, λ+3] plan
        packed_np = pack_plan(res.th_mask, res.n_sel, res.tp_start, res.tp_end).cpu().numpy()
        ds.transfers += 1
        th_mask, _, tps, tpe = unpack_plan(packed_np, self.lam)
        self.chosen = np.full((self.qb,), -1, np.int8)
        wave_blocks: list[np.ndarray] = []
        for s, st in zip(active_slots, active):
            a = st.query.algo or self.default_algo
            if a == "threshold":
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
                ct, c2 = engine.cost.io_time(bt), engine.cost.io_time(b2)
                if ct <= c2:
                    plan, self.chosen[s], st.used_algo = bt, 0, "threshold"
                else:
                    plan, self.chosen[s], st.used_algo = b2, 1, "two_prong"
            blocks = np.setdiff1d(plan, st.exclude)
            if blocks.size == 0:
                st.done = True  # plan exhausted: nothing new to read
            wave_blocks.append(blocks)
        return active, wave_blocks


def _predicate_table(states: list[_QueryState]):
    """Per-query ``(attrs [J, γ_max], values [J, γ_max], is_or [J])``, with
    attr -1 marking a padded slot."""
    gmax = max(len(st.query.predicates) for st in states)
    attrs = np.full((len(states), gmax), -1, np.int64)
    vals = np.zeros((len(states), gmax), np.int64)
    for j, st in enumerate(states):
        for g, (a, v) in enumerate(st.query.predicates):
            attrs[j, g], vals[j, g] = a, v
    is_or = np.asarray([st.query.op == OR for st in states])
    return attrs, vals, is_or


def _wave_records(
    store, union: np.ndarray, states: list[_QueryState], blocks: list[np.ndarray]
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Fetch the round's union from the device slabs and extract each
    query's matching records over its own blocks.

    Returns, per query, ``(record_block, record_row, measures)`` in the
    reference's order (the query's blocks ascending, then rows).  Each
    (query, block) pair's mask is the reference's ``predicate_mask`` fold
    (AND over the pairs from ``True``, OR from ``False``; padded slots are
    the identity) ANDed with the valid rows.
    """
    dev = store.device
    dims_u, meas_u, valid_u = store.fetch_device(union)
    r = dims_u.shape[1]
    sizes = np.asarray([b.size for b in blocks])
    pos = np.concatenate([np.searchsorted(union, b) for b in blocks])
    owner = np.repeat(np.arange(len(states)), sizes)
    attrs, vals, is_or = _predicate_table(states)
    rows_idx = torch.arange(r, device=dev)[None, :]
    pair_hits, rec_rows, rec_meas = [], [], []
    for lo in range(0, pos.size, _PAIR_CHUNK):
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
        mask = torch.where(or_p, acc_or, acc_and) & valid_u[p]
        hit = torch.nonzero(mask)  # [n, 2] (pair, row), row-major order
        rec_meas.append(meas_u[p[hit[:, 0]], hit[:, 1]].cpu().numpy())
        hit = hit.cpu().numpy()
        pair_hits.append(hit[:, 0] + lo)
        rec_rows.append(hit[:, 1])
    pair = np.concatenate(pair_hits)
    row = np.concatenate(rec_rows)
    meas = np.concatenate(rec_meas)
    block_of_pair = np.concatenate(blocks)
    bounds = np.searchsorted(pair, np.concatenate([[0], np.cumsum(sizes)]))
    return [
        (block_of_pair[pair[b0:b1]], row[b0:b1], meas[b0:b1])
        for b0, b1 in zip(bounds[:-1], bounds[1:])
    ]


def _execute_wave(
    engine: "NeedleTailEngine",
    active: list[_QueryState],
    wave_blocks: list[np.ndarray],
    touched: list[int],
    touched_set: set[int],
) -> tuple[bool, int, int]:
    """Fetch one round's deduplicated union and apply each query's §4.1
    post-fetch bookkeeping (records, exclusion growth, refill accounting).
    Returns ``(progressed, blocks_requested_delta, blocks_gathered)``."""
    union = np.unique(np.concatenate(wave_blocks)) if wave_blocks else np.asarray([], np.int64)
    for b in union:
        if int(b) not in touched_set:
            touched_set.add(int(b))
            touched.append(int(b))
    members = [(st, b) for st, b in zip(active, wave_blocks) if b.size]
    if not members:
        return False, 0, 0
    recs = _wave_records(engine.store, union, [m[0] for m in members],
                         [m[1] for m in members])
    requested = 0
    for (st, blocks), (rb, rr, rm) in zip(members, recs):
        st.rec_blocks.append(rb)
        st.rec_rows.append(rr)
        st.meas.append(rm)
        st.planned.append(blocks)
        requested += int(blocks.size)
        st.got += int(rb.size)
        st.exclude = np.concatenate([st.exclude, blocks])
        st.need = st.query.k - st.got
        st.rounds += 1
        if st.got >= st.query.k:
            st.done = True
    return True, requested, int(union.size)


def _device_plan_loop(
    engine: "NeedleTailEngine",
    states: list[_QueryState],
    algo: str,
    touched: list[int],
    touched_set: set[int],
    active_counts: list[int],
    round_seconds: list[float],
) -> tuple[int, int, int, int]:
    """The device-resident refill loop: one :class:`DeviceWave` slot per
    query, each leaving the round it is satisfied.  Returns ``(waves,
    blocks_requested_total, device_transfers, blocks_gathered)``."""
    wave = DeviceWave(engine, len(states), default_algo=algo)
    for i, st in enumerate(states):
        if not st.done:
            wave.join(i, st)
    requested_total = gathered = waves = 0
    while waves < engine.max_refills:
        t0 = time.perf_counter()
        active, wave_blocks = wave.plan_round()
        if not active:
            break
        progressed, req, n_gathered = _execute_wave(
            engine, active, wave_blocks, touched, touched_set
        )
        round_seconds.append(time.perf_counter() - t0)
        requested_total += req
        gathered += n_gathered
        for s in wave.busy_slots():
            if wave.slots[s].done:
                wave.leave(s)
        if not progressed:
            break
        waves += 1
        active_counts.append(len(active))
    return waves, requested_total, wave.transfers, gathered


def finalize_query_result(
    engine: "NeedleTailEngine",
    st: _QueryState,
    default_algo: str = "auto",
    cpu_time_s: float = 0.0,
):
    """The public :class:`~repro_torch.core.engine.QueryResult` of a
    finished refill state."""
    from repro_torch.core.engine import QueryResult

    all_blocks = (
        np.concatenate(st.planned) if st.planned else np.asarray([], dtype=np.int64)
    )
    return QueryResult(
        record_block=np.concatenate(st.rec_blocks) if st.rec_blocks else np.asarray([], np.int64),
        record_row=np.concatenate(st.rec_rows) if st.rec_rows else np.asarray([], np.int64),
        measures=np.concatenate(st.meas) if st.meas else np.zeros((0, 0), np.float32),
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
) -> BatchQueryResult:
    """Evaluate Q any-k queries as one device wave.

    Each query's records are byte-identical to the reference's
    ``run_batch`` on the same data: same blocks planned, same refill
    rounds, same record order.  ``plan_on_host=True`` (the reference's
    host-mirror loop) arrives with a later slice of the port.
    """
    if plan_on_host:
        raise NotImplementedError(
            "the host-mirror loop (plan_on_host=True) with its block LRU and "
            "plan-order memo arrives with a later slice of the port (ROADMAP Queue 1)"
        )
    _check_algo(algo)
    t0 = time.perf_counter()
    states = [new_query_state(q) for q in queries]
    touched: list[int] = []  # unique block ids, first-touch order
    touched_set: set[int] = set()
    active_counts: list[int] = []
    round_seconds: list[float] = []
    waves = requested_total = device_transfers = gathered = 0
    if engine.store.num_blocks > 0 and any(not st.done for st in states):
        waves, requested_total, device_transfers, gathered = _device_plan_loop(
            engine, states, algo, touched, touched_set, active_counts, round_seconds
        )
    cpu = time.perf_counter() - t0
    touched_ids = np.asarray(touched, dtype=np.int64)
    return BatchQueryResult(
        results=[finalize_query_result(engine, st, default_algo=algo, cpu_time_s=cpu)
                 for st in states],
        unique_blocks_fetched=touched_ids,
        blocks_requested_total=requested_total,
        rounds=waves,
        cpu_time_s=cpu,
        modeled_io_s=engine.cost.io_time(touched_ids),
        store_blocks_fetched=gathered,
        device_transfers=device_transfers,
        active_per_round=active_counts,
        round_seconds=round_seconds,
    )
