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
Each plan crosses to the host once, as one packed int32 vector.

:meth:`NeedleTailEngine.any_k_batch` evaluates a wave of queries
(:mod:`repro_torch.core.multi_query`), on the device or through the
host-mirror loop; per query it returns what ``any_k`` returns.  After
:meth:`NeedleTailEngine.attach_mesh` every rank of the mesh runs the same
engine on the same store and queries, and the waves plan over the
λ-sharded density wave (:mod:`repro_torch.core.sharded`), with equal
results.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.block_cache import BlockLRUCache, PlanOrderCache
from repro_torch.core.cost_model import CostModel, make_cost_model
from repro_torch.core.density_map import AND, combine_densities
from repro_torch.core.threshold import threshold_select
from repro_torch.core.two_prong import two_prong_select
from repro_torch.device import resolve_device

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.multi_query import BatchQueryResult
    from repro_torch.data.block_store import BlockStore

Predicates = Sequence[tuple[int, int]]

# what later slices of the port carry, by constructor argument
_LATER = {
    "tiers": "tiered-storage slice",
    "residency_aware": "tiered-storage slice",
    "calibrated_cost": "tiered-storage slice",
    "timing_backend": "tiered-storage slice",
    "ledger": "tiered-storage slice",
    "obs": "serving and observability slice",
}


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
    memo of the host-mirror loop.
    """

    def __init__(
        self,
        store: "BlockStore",
        cost_model: CostModel | None = None,
        max_refills: int = 8,
        cache_bytes: int | None = None,
        plan_cache_entries: int = 4096,
        device: str | torch.device = "cuda",
        **later,
    ):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"unexpected argument {name!r}")
            if value not in (None, False):
                raise NotImplementedError(f"{name} arrives with the {_LATER[name]} of the port")
        self.device = resolve_device(device)
        if store.device != self.device:
            raise ValueError(
                f"store lives on {store.device}, engine asked for {self.device}; "
                "move it with store.to(device)"
            )
        self.store = store
        self.cost = cost_model or make_cost_model("hdd")
        self.max_refills = max_refills
        self.block_cache = BlockLRUCache(cache_bytes)
        self.plan_cache = PlanOrderCache(plan_cache_entries)
        self.distributed = None  # the sharded planner, once a mesh is attached
        store.register_invalidation_listener(self.block_cache.invalidate)

    # ------------------------------------------------------------------ plans
    def plan_cost(self, block_ids) -> float:
        """Modeled I/O cost of a candidate plan (the §7.2 ``auto``
        comparison): the engine's cost model over the ascending ids."""
        return self.cost.io_time(block_ids)

    def combined_density(self, predicates: Predicates, op: str = AND,
                         exclude: np.ndarray | None = None) -> torch.Tensor:
        """``[λ]`` f32 ⊕-combined density on the engine's device, with the
        blocks in ``exclude`` set to +0.0 (in the combine's own launch on
        CUDA)."""
        from repro_torch.core.multi_query import check_predicates

        check_predicates(predicates, op)
        rows = self.store.index.vocab.rows(predicates)
        return combine_densities(self.store.index.densities, rows, op, exclude)

    def _mask(self, block_dims: torch.Tensor, predicates: Predicates, op: str = AND):
        return self.store.predicate_mask(block_dims, predicates, op)

    def plan(
        self,
        predicates: Predicates,
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
        """
        from repro_torch.core.multi_query import check_algo

        check_algo(algo)
        combined = self.combined_density(predicates, op, exclude)
        rpb = self.store.records_per_block
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
        return (bt, "threshold") if self.plan_cost(bt) <= self.plan_cost(b2) else (b2, "two_prong")

    # ------------------------------------------------------------------ query
    def _records(
        self, predicates: Predicates, op: str, blocks: np.ndarray, slabs
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
        predicates: Predicates,
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
