"""The NeedleTail engine (paper §6) over a device-resident :class:`BlockStore`.

Counterpart of ``repro/core/engine.py`` for the device wave.  The engine
returns *all valid records in the fetched blocks* (paper §4.1) and re-plans
over unexamined blocks when a fetch under-delivers; I/O is charged through a
:class:`~repro_torch.core.cost_model.CostModel` with the §4.1 ascending
fetch order.

:meth:`NeedleTailEngine.any_k_batch` evaluates a wave of queries through the
device pipeline of :mod:`repro_torch.core.multi_query`; :meth:`any_k` is a
one-query wave, whose result the reference guarantees is byte-identical to
its sequential ``any_k``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel, make_cost_model
from repro_torch.core.density_map import AND
from repro_torch.device import resolve_device

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.multi_query import BatchQueryResult
    from repro_torch.data.block_store import BlockStore

Predicates = Sequence[tuple[int, int]]


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
    runs the plain PyTorch versions of the kernels.
    """

    def __init__(
        self,
        store: "BlockStore",
        cost_model: CostModel | None = None,
        max_refills: int = 8,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if store.device != self.device:
            raise ValueError(
                f"store lives on {store.device}, engine asked for {self.device}; "
                "move it with store.to(device)"
            )
        self.store = store
        self.cost = cost_model or make_cost_model("hdd")
        self.max_refills = max_refills

    def any_k(
        self,
        predicates: Predicates,
        k: int,
        op: str = AND,
        algo: str = "auto",
    ) -> QueryResult:
        """One LIMIT-k query, run as a one-query device wave."""
        from repro_torch.core.multi_query import BatchQuery, run_batch

        return run_batch(self, [BatchQuery(predicates, k, op)], algo=algo).results[0]

    def any_k_batch(
        self,
        queries,
        algo: str = "auto",
        device: bool = True,
    ) -> "BatchQueryResult":
        """Evaluate Q concurrent any-k queries as one device wave.

        ``queries`` is a sequence of :class:`~repro_torch.core.multi_query.
        BatchQuery` or ``(predicates, k[, op])`` tuples.  ``device`` keeps
        the reference's meaning — ``True`` runs the device-resident wave on
        the engine's device, with one packed device→host plan transfer per
        round; ``False`` (the reference's host-mirror loop) arrives with a
        later slice of the port.
        """
        from repro_torch.core.multi_query import run_batch

        return run_batch(self, queries, algo=algo, plan_on_host=not device)
