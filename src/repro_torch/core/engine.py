"""The NeedleTail engine (paper §6) over a device-resident :class:`BlockStore`.

Counterpart of ``repro/core/engine.py``.  The engine returns *all valid
records in the fetched blocks* (paper §4.1) and re-plans over unexamined
blocks when a fetch under-delivers; I/O is charged through a
:class:`~repro_torch.core.cost_model.CostModel` with the §4.1 ascending
fetch order.

:meth:`NeedleTailEngine.any_k` is the reference's sequential loop: per round
the query's combined density with the blocks already read set to +0.0 (one
launch of the ``density_combine`` kernel), a THRESHOLD
or TWO-PRONG plan (the ``prefix_sum`` kernel) or the §7.2 ``auto`` choice
between them, ``setdiff1d`` against the blocks already read, an ascending
read through the engine-lifetime :class:`~repro_torch.core.block_cache.
BlockLRUCache` (``block_gather``), then the predicate mask on the card.
Each plan crosses to the host once, as one packed int32 vector.  A query's
predicates are ``(attr, value)`` pairs under AND or OR, or a
:class:`~repro_torch.core.predicates.Predicate` tree compiled on the card;
``algo="forward_optimal"`` plans with the host DP of Algorithm 3
(:mod:`repro_torch.core.forward_optimal`) on one host copy of the row.

:meth:`NeedleTailEngine.any_k_batch` evaluates a wave of queries
(:mod:`repro_torch.core.multi_query`), on the device or through the
host-mirror loop; per query it returns what ``any_k`` returns.  After
:meth:`NeedleTailEngine.attach_mesh` every rank of the mesh runs the same
engine on the same store and queries, and the waves plan over the
λ-sharded density wave (:mod:`repro_torch.core.sharded`), with equal
results.

With ``tiers=`` (a :class:`~repro_torch.storage.tiers.TierStack`) every
read goes through byte-budgeted tiers, a slot pool on the card over pinned
host memory, instead of the flat cache; ``append``, ``compact``,
``replace_store`` and ``recalibrate`` maintain the store and the cost
models (:mod:`repro_torch.data.append`, :mod:`repro_torch.storage.compact`,
:mod:`repro_torch.storage.calibration`), and a
:class:`~repro_torch.core.plan_ledger.PlanLedger` records predicted against
observed I/O.

:meth:`NeedleTailEngine.aggregate` is the §5 hybrid-sampled estimate: the
design is drawn on the host (:mod:`repro_torch.core.hybrid`), its blocks
are read and their per-block sums taken on the card
(:func:`block_partials`), and the estimators run on the host
(:mod:`repro_torch.core.estimators`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import estimators as est
from repro_torch.core.block_cache import BlockLRUCache, PlanOrderCache
from repro_torch.core.cost_model import CostModel, make_cost_model
from repro_torch.core.density_map import AND, combine_densities
from repro_torch.core.forward_optimal import forward_optimal_faithful
from repro_torch.core.hybrid import HybridPlan, plan_hybrid
from repro_torch.core.predicates import Predicate
from repro_torch.core.threshold import threshold_select
from repro_torch.core.two_prong import two_prong_select
from repro_torch.device import resolve_device
from repro_torch.kernels.density_combine import exclusion_ids

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.multi_query import BatchQueryResult
    from repro_torch.data.block_store import BlockStore

# what later slices of the port carry, by constructor argument
_LATER = {"obs": "serving and observability slice"}


@dataclasses.dataclass
class QueryResult:
    record_block: np.ndarray  # [n] block id per returned record
    record_row: np.ndarray  # [n] row-in-block per returned record
    measures: np.ndarray  # [n, s] measures of returned records
    blocks_fetched: np.ndarray  # ids actually read
    algo: str
    cpu_time_s: float
    modeled_io_s: float
    plan_rounds: int

    @property
    def num_records(self) -> int:
        return int(self.record_block.shape[0])


class NeedleTailEngine:
    """Any-k LIMIT queries over ``store`` on ``device``.

    ``device`` defaults to ``"cuda"`` and must be where the store lives;
    without CUDA the default raises, and ``device="cpu"`` (with a CPU store)
    runs the plain PyTorch versions of the kernels.  ``cache_bytes`` sizes
    the engine-lifetime block cache (``None`` unbounded, ``0`` off; its
    slabs live on ``device``) and ``plan_cache_entries`` the plan-order
    memo of the host-mirror loop.  ``tiers`` (a :class:`~repro_torch.
    storage.tiers.TierStack` on ``device``) replaces the flat cache with
    byte-budgeted tiers; ``residency_aware`` prices ``auto``'s candidates by
    where their blocks are resident; ``ledger`` (a :class:`~repro_torch.
    core.plan_ledger.PlanLedger`) records predicted against observed I/O
    and corrects prices; ``timing_backend`` answers what a read costs, and
    ``calibrated_cost`` refits the cost models from it at start
    (a :class:`~repro_torch.storage.calibration.StoreTimingBackend` over
    the store when none is given).
    """

    def __init__(
        self,
        store: "BlockStore",
        cost_model: CostModel | None = None,
        max_refills: int = 8,
        cache_bytes: int | None = None,
        plan_cache_entries: int = 4096,
        tiers=None,
        residency_aware: bool = False,
        calibrated_cost: bool = False,
        timing_backend=None,
        ledger=None,
        device: str | torch.device = "cuda",
        **later,
    ):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"unexpected argument {name!r}")
            if value not in (None, False):
                raise NotImplementedError(f"{name} arrives with the {_LATER[name]} of the port")
        self.device = resolve_device(device)
        self._check_device(store)
        self.store = store
        self.cost = cost_model or make_cost_model("hdd")
        self.max_refills = max_refills
        # tiers: a repro_torch.storage.TierStack replaces the flat cache (same
        # surface; budgets live on its tiers, cache_bytes is then ignored)
        if tiers is not None and tiers.device != self.device:
            raise ValueError(f"tier stack on {tiers.device}, engine on {self.device}")
        self.block_cache = tiers if tiers is not None else BlockLRUCache(cache_bytes)
        # residency_aware: the §7.2 auto arbitration prices candidate plans by
        # effective tier cost; opt-in, since it changes the physical plan
        self.residency_aware = bool(residency_aware)
        self.plan_cache = PlanOrderCache(plan_cache_entries)
        self.distributed = None  # the sharded planner, once a mesh is attached
        store.register_invalidation_listener(self.block_cache.invalidate)
        # measured-cost feedback (storage.calibration, core.plan_ledger),
        # shared with a tier stack so every pricing site agrees
        self.ledger = ledger
        self.timing_backend = timing_backend
        if hasattr(self.block_cache, "effective_io_time"):
            if ledger is not None:
                self.block_cache.ledger = ledger
            if timing_backend is not None:
                self.block_cache.timing_backend = timing_backend
        if calibrated_cost:
            # calibrate at engine start against real store reads unless a
            # backend was given
            if self.timing_backend is None:
                from repro_torch.storage.calibration import StoreTimingBackend

                self.timing_backend = StoreTimingBackend(store, levels={self.cost.name})
                if hasattr(self.block_cache, "effective_io_time"):
                    self.block_cache.timing_backend = self.timing_backend
            self.recalibrate()

    def _check_device(self, store: "BlockStore") -> None:
        if store.device != self.device:
            raise ValueError(
                f"store lives on {store.device}, engine asked for {self.device}; "
                "move it with store.to(device)"
            )

    # ------------------------------------------------------------------ store
    def _adopt(self, store: "BlockStore") -> None:
        """Move the block cache's listener to ``store`` and read from it; the
        old store's slabs are freed once nothing else holds them."""
        self.store.unregister_invalidation_listener(self.block_cache.invalidate)
        self.store = store
        store.register_invalidation_listener(self.block_cache.invalidate)
        if self.distributed is not None:  # the sharded planner's geometry
            self.distributed.rpb = store.records_per_block

    def replace_store(self, store: "BlockStore") -> None:
        """Swap in an unrelated store: full cache flush (no shared lineage)."""
        self._check_device(store)
        self._adopt(store)
        self.block_cache.clear()
        self.plan_cache.clear()

    def append(self, new) -> "BlockStore":
        """Append the rows of the :class:`~repro_torch.data.block_store.Table`
        ``new`` on the store's device (:func:`repro_torch.data.append.
        append_records`) and adopt the grown store.  The block cache is
        notified with exactly the dirtied tail block ids, so untouched cached
        blocks survive; plan-memo entries are keyed on density bytes, which
        change for every dirtied row, so stale ones can never be hit."""
        from repro_torch.data.append import append_records

        grown = append_records(self.store, new)  # notifies block_cache
        self._adopt(grown)
        return grown

    def compact(self, tail_start: int) -> "BlockStore":
        """Re-sort the tail from block ``tail_start`` on by dimension values
        (:func:`repro_torch.storage.compact.compact_tail`) and adopt the
        compacted store, with :meth:`append`'s invalidation contract.  The
        compacted store is a new store version: results match the
        sequential oracle per version."""
        from repro_torch.storage.compact import compact_tail

        fresh = compact_tail(self.store, tail_start)  # notifies block_cache
        self._adopt(fresh)
        return fresh

    # ------------------------------------------------------------ calibration
    def recalibrate(self, **fit_kw) -> dict:
        """Refit cost models from the timing backend.  With a tier stack,
        every measurable tier and the backing model are refit in place and
        the engine adopts the stack's fitted backing model; otherwise the
        engine's model is refit.  Returns ``{level: fitted CostModel}``
        (empty without a backend)."""
        be = self.timing_backend
        if be is None:
            return {}
        from repro_torch.storage.calibration import calibrate_model, measurable

        fitted: dict = {}
        cal = getattr(self.block_cache, "calibrate", None)
        if cal is not None:
            fitted = cal(be, **fit_kw)
            if self.block_cache.backing.name == self.cost.name and self.cost.name in fitted:
                self.cost = fitted[self.cost.name]
        if self.cost.name not in fitted and measurable(be, self.cost.name):
            self.cost = calibrate_model(be, self.cost.name, base=self.cost, **fit_kw)
            fitted[self.cost.name] = self.cost
        if self.ledger is not None:
            for level in fitted:  # refit models subsume the old corrections
                self.ledger.reset_correction(level)
        return fitted

    # ------------------------------------------------------------------ plans
    def plan_cost(self, block_ids) -> float:
        """Modeled I/O cost of a candidate plan (the §7.2 ``auto``
        comparison).  With ``residency_aware`` and a tier stack, residents
        are priced by their tier's model and only misses by the backing
        model (``TierStack.effective_io_time``); otherwise the engine's
        model prices every block, scaled by the plan ledger's correction for
        its level (uniform across a comparison, so it never flips the
        argmin)."""
        if self.residency_aware:
            eff = getattr(self.block_cache, "effective_io_time", None)
            if eff is not None:
                return eff(block_ids, backing=self.cost)
        t = self.cost.io_time(block_ids)
        return t * self.ledger.correction(self.cost.name) if self.ledger is not None else t

    def _record_arbitration(self, blocks: np.ndarray, predicted: float) -> None:
        """Ledger the §7.2 ``auto`` decision: the quoted cost of the chosen
        blocks vs the timing backend's measurement.  Only on the flat
        pricing path, for a backend that can measure the planning model's
        level and does not wrap this store (observing would re-read it)."""
        lg, be = self.ledger, self.timing_backend
        if lg is None or be is None or blocks.size == 0:
            return
        if self.residency_aware and hasattr(self.block_cache, "effective_io_time"):
            return
        if getattr(be, "store", None) is self.store:
            return
        from repro_torch.storage.calibration import measurable

        if measurable(be, self.cost.name):
            lg.record("arbitration", self.cost.name, predicted,
                      be.io_seconds(self.cost.name, blocks))

    def combined_density(self, predicates, op: str = AND,
                         exclude: np.ndarray | None = None) -> torch.Tensor:
        """``[λ]`` f32 combined density on the engine's device, with the
        blocks in ``exclude`` set to +0.0: a ``Predicate`` tree compiled by
        :mod:`repro_torch.core.predicates`, or the ⊕-combine of ``(attr,
        value)`` pairs under ``op`` (the exclusion in the combine's own
        launch on CUDA)."""
        from repro_torch.core.multi_query import check_predicates

        check_predicates(predicates, op)
        if isinstance(predicates, Predicate):
            out = predicates.density(self.store.index)
            if exclude is not None and len(exclude):
                ids = exclusion_ids(exclude, out.shape[0])
                out[torch.from_numpy(ids).to(out.device).long()] = 0.0
            return out
        rows = self.store.index.vocab.rows(predicates)
        return combine_densities(self.store.index.densities, rows, op, exclude)

    def _mask(self, block_dims: torch.Tensor, predicates, op: str = AND):
        if isinstance(predicates, Predicate):
            return predicates.mask(block_dims)
        return self.store.predicate_mask(block_dims, predicates, op)

    def plan(
        self,
        predicates,
        k: int,
        op: str = AND,
        algo: str = "auto",
        exclude: np.ndarray | None = None,
    ) -> tuple[np.ndarray, str]:
        """Choose blocks.  Returns ``(block ids int64, algorithm used)``.

        The planners run on the engine's device; their results cross to the
        host as one packed int32 vector (THRESHOLD ids, -1 past the cut,
        then ``num_selected``, then the TWO-PRONG window), so a plan costs
        one device→host copy whichever algorithm it takes.
        ``forward_optimal`` runs the host DP of Algorithm 3 on one host copy
        of the combined row, as the reference does.
        """
        from repro_torch.core.multi_query import check_algo

        check_algo(algo)
        combined = self.combined_density(predicates, op, exclude)
        rpb = self.store.records_per_block
        if algo == "forward_optimal":
            sel, _ = forward_optimal_faithful(combined, k, rpb, self.cost)
            return np.asarray(sel, dtype=np.int64), algo
        parts = []
        if algo in ("threshold", "auto"):
            r = threshold_select(combined, float(k), rpb)
            parts += [r.block_ids, r.num_selected[None]]
        if algo in ("two_prong", "auto"):
            w = two_prong_select(combined, float(k), rpb)
            parts.append(torch.stack([w.start, w.end]).to(torch.int32))
        packed = torch.cat(parts).cpu().numpy()  # the plan's one device→host copy
        bt = b2 = None
        if algo in ("threshold", "auto"):
            lam = combined.shape[0]
            bt = packed[: int(packed[lam])].astype(np.int64)
        if algo in ("two_prong", "auto"):
            b2 = np.arange(int(packed[-2]), int(packed[-1]), dtype=np.int64)
        if algo == "threshold":
            return bt, algo
        if algo == "two_prong":
            return b2, algo
        # §7.2 Discussion: plan with both, cost both, take the cheaper
        ct, c2 = self.plan_cost(bt), self.plan_cost(b2)
        blocks, used, cost = (bt, "threshold", ct) if ct <= c2 else (b2, "two_prong", c2)
        self._record_arbitration(blocks, cost)
        return blocks, used

    # ------------------------------------------------------------------ query
    def _records(
        self, predicates, op: str, blocks: np.ndarray, slabs
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(record_block, record_row, measures)`` of the valid records
        matching the query in ``blocks`` (ascending), in block-then-row
        order: the mask is evaluated on the slabs' device."""
        bd, bm, bv = slabs
        hit = torch.nonzero(self._mask(bd, predicates, op) & bv)
        meas = bm[hit[:, 0], hit[:, 1]].cpu().numpy()
        hit = hit.cpu().numpy()
        return blocks[hit[:, 0]], hit[:, 1], meas

    def any_k(
        self,
        predicates,
        k: int,
        op: str = AND,
        algo: str = "auto",
    ) -> QueryResult:
        """One LIMIT-k query: plan, read, mask, refill (the reference's
        sequential loop)."""
        t0 = time.perf_counter()
        fetched: list[np.ndarray] = []
        rec_blocks: list[np.ndarray] = []
        rec_rows: list[np.ndarray] = []
        meas: list[np.ndarray] = []
        got = rounds = 0
        used_algo = algo
        exclude = np.asarray([], dtype=np.int64)
        need = k
        while got < k and rounds < self.max_refills:
            blocks, used_algo = self.plan(predicates, need, op, algo, exclude)
            blocks = np.setdiff1d(blocks, exclude)
            if blocks.size == 0:
                break
            blocks = np.sort(blocks)  # §4.1 fetch optimization
            rb, rr, rm = self._records(
                predicates, op, blocks, self.block_cache.get_many(self.store, blocks))
            rec_blocks.append(rb)
            rec_rows.append(rr)
            meas.append(rm)
            fetched.append(blocks)
            got += int(rb.size)
            exclude = np.concatenate([exclude, blocks])
            need = k - got
            rounds += 1
        cpu = time.perf_counter() - t0
        all_blocks = np.concatenate(fetched) if fetched else np.asarray([], dtype=np.int64)
        return QueryResult(
            record_block=np.concatenate(rec_blocks) if rec_blocks else np.asarray([], np.int64),
            record_row=np.concatenate(rec_rows) if rec_rows else np.asarray([], np.int64),
            measures=np.concatenate(meas) if meas else np.zeros((0, 0), np.float32),
            blocks_fetched=all_blocks,
            algo=used_algo,
            cpu_time_s=cpu,
            modeled_io_s=self.cost.io_time(all_blocks),
            plan_rounds=rounds,
        )

    # ------------------------------------------------------------------- mesh
    def attach_mesh(self, mesh, axis: str = "data", **kwargs):
        """Make :meth:`any_k_batch` plan over a λ-sharded wave.

        ``mesh`` is a ``DeviceMesh`` (:func:`repro_torch.launch.mesh.
        make_host_mesh`) whose ``axis`` group shards λ, or a bare process
        group.  Every rank of it calls this, and then runs the same
        ``any_k_batch`` calls (SPMD).  Builds a :class:`repro_torch.core.
        sharded.DistributedAnyK` on this engine's device sharing its block
        cache; ``kwargs`` (``candidates``, ``two_prong_group``,
        ``remote_cost``, ...) go to it.  Returns it (also
        ``self.distributed``)."""
        from repro_torch.core.sharded import DistributedAnyK

        self.distributed = DistributedAnyK(
            mesh, axis=axis, records_per_block=self.store.records_per_block,
            block_cache=self.block_cache, device=self.device, **kwargs,
        )
        return self.distributed

    def detach_mesh(self) -> None:
        """Back to unsharded planning."""
        self.distributed = None

    # ------------------------------------------------------------------ batch
    def any_k_batch(
        self,
        queries,
        algo: str = "auto",
        sharded: bool | None = None,
        device: bool = True,
    ) -> "BatchQueryResult":
        """Evaluate Q concurrent any-k queries as one wave.

        ``queries`` is a sequence of :class:`~repro_torch.core.multi_query.
        BatchQuery` or ``(predicates, k[, op])`` tuples.  Per-query results
        equal Q separate :meth:`any_k` calls.  ``device=True`` runs the
        device-resident wave on the engine's device (one packed device→host
        plan transfer per round); ``False`` the reference's host-mirror loop
        (plans cut on the host from sorted orders and windows computed on the
        device, memoized across batches in ``plan_cache``).  The port
        defaults to the device wave, the reference to the host-mirror loop;
        both read through ``block_cache``.

        ``sharded``: ``None`` plans over the sharded wave iff a mesh is
        attached, ``True`` requires one, ``False`` plans unsharded even with
        one attached.
        """
        from repro_torch.core.multi_query import run_batch

        planner = self.distributed if sharded is None or sharded else None
        if sharded and planner is None:
            raise ValueError("sharded=True but no mesh attached; call attach_mesh")
        return run_batch(self, queries, algo=algo, plan_on_host=not device, planner=planner)

    # -------------------------------------------------------------- aggregate
    def aggregate(
        self,
        predicates,
        measure: int,
        k: int,
        alpha: float = 0.1,
        op: str = AND,
        estimator: str = "ratio",
        algo: str = "threshold",
        seed: int = 0,
    ) -> tuple[est.Estimate, QueryResult, HybridPlan]:
        """Hybrid-sampled aggregate estimation (paper §5): the combine and
        the any-k plan on the card, the hybrid design drawn on the host
        from one copy of the combined row, one ascending read of the
        design's blocks through the block cache, the mask and the per-block
        partials (:func:`block_partials`) on the card, then the estimator's
        scalar sums on the host."""
        t0 = time.perf_counter()
        combined = self.combined_density(predicates, op).cpu().numpy()
        rpb = self.store.records_per_block
        anyk_blocks, _ = self.plan(predicates, k, op, algo)
        rng = np.random.default_rng(seed)
        plan = plan_hybrid(anyk_blocks, combined, k, alpha, rpb, rng)
        blocks = np.sort(plan.blocks)
        bd, bm, bv = self.block_cache.get_many(self.store, blocks)
        mask = self._mask(bd, predicates, op) & bv
        tau_i, n_i = block_partials(mask, bm[..., measure])
        in_sc = np.isin(blocks, plan.sc)
        L = float(np.sum(combined) * rpb)  # estimated population size
        fn = est.horvitz_thompson if estimator == "ht" else est.ratio_estimator
        e = fn(tau_i[in_sc], tau_i[~in_sc], n_i[in_sc], n_i[~in_sc], plan, L)
        hit = torch.nonzero(mask)
        meas = bm[hit[:, 0], hit[:, 1]].cpu().numpy()
        hit = hit.cpu().numpy()
        qr = QueryResult(
            record_block=blocks[hit[:, 0]],
            record_row=hit[:, 1],
            measures=meas,
            blocks_fetched=blocks,
            algo=f"hybrid-{algo}",
            cpu_time_s=time.perf_counter() - t0,
            modeled_io_s=self.cost.io_time(blocks),
            plan_rounds=1,
        )
        return e, qr, plan


_NP_BUFSIZE = 8192  # numpy reduces a long axis in chunks of its buffer size
_NP_BLOCKSIZE = 128  # numpy's pairwise-sum leaf


def _np_pairwise(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``pairwise_sum`` over the last axis, vectorised over the
    leading ones: below 8 elements a left fold; up to 128, eight strided
    accumulators folded left to right, combined as ((0+1)+(2+3))+((4+5)+(6+7)),
    then the rest; above, the two halves at a multiple of 8.  Equal halves
    are stacked on a new axis and summed as one."""
    n = x.shape[-1]
    if n < 8:
        acc = x[..., 0] if n else x.new_zeros(x.shape[:-1])
        for i in range(1, n):
            acc = acc + x[..., i]
        return acc
    if n <= _NP_BLOCKSIZE:
        m = n - n % 8
        lanes = x[..., :m].reshape(*x.shape[:-1], m // 8, 8)
        r = lanes[..., 0, :]
        for i in range(1, m // 8):
            r = r + lanes[..., i, :]
        acc = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + \
            ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(m, n):
            acc = acc + x[..., i]
        return acc
    half = n // 2 - (n // 2) % 8
    if 2 * half == n:
        both = _np_pairwise(x.reshape(*x.shape[:-1], 2, half))
        return both[..., 0] + both[..., 1]
    return _np_pairwise(x[..., :half]) + _np_pairwise(x[..., half:])


def _np_sum(x: torch.Tensor) -> torch.Tensor:
    """``np.sum(x, axis=-1)`` of a float32 array, bit for bit: the axis in
    chunks of numpy's buffer size, each chunk's pairwise sum added left to
    right.  Every element's sum is the same tree of single f32 adds whatever
    the leading shape, so a block's sum does not depend on the blocks beside
    it (a reduction kernel picks its order by shape)."""
    acc = None
    for lo in range(0, max(x.shape[-1], 1), _NP_BUFSIZE):
        part = _np_pairwise(x[..., lo:lo + _NP_BUFSIZE])
        acc = part if acc is None else acc + part
    return acc


def block_partials(mask: torch.Tensor, vals: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Per-block §5 statistics of fetched blocks, on their device:
    ``τ_i``, the f32 sum of ``vals`` over the rows ``mask`` keeps, and
    ``n_i``, the count of those rows (``mask`` and ``vals`` ``[..., R]``).
    Returned as host arrays, f32 and f64 as the reference's extraction
    gives them.  ``τ_i`` adds in numpy's order (:func:`_np_sum`), so it
    equals the reference's bit for bit, and ``aggregate`` and the online
    fold, which both use this, agree under ``==`` however the blocks are
    batched."""
    tau = _np_sum(torch.where(mask, vals, 0.0))
    n = mask.sum(dim=-1)
    return tau.cpu().numpy(), n.cpu().numpy().astype(np.float64)
