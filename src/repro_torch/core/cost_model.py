"""Storage cost model (paper §4.3.1).

Counterpart of ``repro/core/cost_model.py``, reduced to what the device wave
needs: ``CostModel`` (``RandIO(i, j)``, the §4.1 ascending-fetch
``io_time`` the §7.2 ``auto`` arbitration compares and the ``rand_io_table``
the FORWARD-OPTIMAL DP reads) and the paper's two measured presets,
``"hdd"`` and ``"ssd"``.  The reference's ``"hbm"`` preset
carries TPU figures; it, ``"dram"``, ``"ici"`` and the trend-line fitting
arrive with the tiered-storage slice, with presets measured on the H100.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    """``RandIO(i, j)``: cost of fetching block j immediately after block i."""

    name: str
    seq_cost: float  # cost of |j - i| == 1 (streamed next block), seconds
    max_dist: int  # t: beyond this the cost is `far_cost`
    far_cost: float  # constant full-seek cost, seconds
    curve: Callable[[np.ndarray], np.ndarray]  # cost(dist) for 1 <= dist <= t
    first_block_cost: float  # κ: cost to fetch the first block

    def rand_io(self, i: np.ndarray | int, j: np.ndarray | int) -> np.ndarray:
        d = np.maximum(np.abs(np.asarray(j) - np.asarray(i)), 1)
        near = np.asarray(self.curve(d), dtype=np.float64)
        return np.where(d <= self.max_dist, near, self.far_cost)

    def io_time(self, block_ids: Sequence[int]) -> float:
        """Modeled I/O time of fetching the deduplicated ids in ascending
        order (the §4.1 fetch optimization)."""
        ids = np.unique(np.asarray(list(block_ids), dtype=np.int64))
        if ids.size == 0:
            return 0.0
        t = self.first_block_cost
        if ids.size > 1:
            t += float(np.sum(self.rand_io(ids[:-1], ids[1:])))
        return t

    def rand_io_table(self, t: int | None = None) -> np.ndarray:
        """cost[d] for d = 0..t (cost[0] = 0), used by the FORWARD-OPTIMAL DP."""
        t = self.max_dist if t is None else t
        d = np.arange(0, t + 1)
        return np.where(d == 0, 0.0, self.rand_io(0, d)).astype(np.float64)


def _linear_curve(seq: float, far: float, t: int) -> Callable[[np.ndarray], np.ndarray]:
    # linear ramp from seq at d=1 to far at d=t (the shape the paper observed)
    def curve(d: np.ndarray) -> np.ndarray:
        d = np.asarray(d, dtype=np.float64)
        return seq + (far - seq) * (d - 1) / max(t - 1, 1)

    return curve


def make_cost_model(kind: str) -> CostModel:
    if kind == "hdd":
        # paper: sequential <1ms, far seek ~7ms, plateau at distance t
        t = 64
        return CostModel("hdd", 0.8e-3, t, 7e-3, _linear_curve(0.8e-3, 7e-3, t), 7e-3)
    if kind == "ssd":
        t = 4
        return CostModel("ssd", 5e-5, t, 7e-5, _linear_curve(5e-5, 7e-5, t), 7e-5)
    if kind in ("hbm", "dram", "ici"):
        raise NotImplementedError(
            f"cost model {kind!r} arrives with the tiered-storage slice of the "
            "port (ROADMAP Queue 1), with presets measured on the H100"
        )
    raise ValueError(f"unknown cost model kind {kind!r}")
