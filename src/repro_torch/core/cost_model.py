"""Storage cost model (paper §4.3.1).

Counterpart of ``repro/core/cost_model.py``: ``CostModel`` (``RandIO(i,
j)``, the §4.1 ascending-fetch ``io_time`` the §7.2 ``auto`` arbitration
compares and the ``rand_io_table`` the FORWARD-OPTIMAL DP reads), the
paper's trend-line fitting (:func:`fit_cost_curve`, :func:`profile_and_fit`)
and the presets:

* ``hdd`` — the paper's device: sequential <1 ms, full seek ≈7 ms.
* ``ssd`` — near-flat random access (paper §7.2 SSD experiment).
* ``hbm`` — a read of the tier-0 slot pool on the card (one
  ``block_gather`` launch per tensor over the slots).
* ``dram`` — host memory as the card sees it: a copy from the pinned
  host pool of tier 1 to the card over PCIe, one copy per contiguous run
  of blocks.
* ``ici`` — the peer hop of :mod:`repro_torch.storage.peer` on one node:
  another shard's pinned host slot copied out, staged with the call's other
  peer-served rows and copied to the card.

The ``hbm`` and ``dram`` constants were measured on one NVIDIA H100 80GB
HBM3 at a 700.00 W power limit by the ``calibration`` phase of
``chip_smoke.py``, the ``ici`` constants by its ``peer`` phase (CUDA-event
timing adapters fitted with :func:`repro_torch.storage.calibration.
calibrate_model`), and keep the reference's form: ``seq = block_bytes /
BW``, ``far = seq + latency``, ``first = far``.  The reference's ``ici``
figure is a TPU interconnect's; this one prices no link between cards.

The presets form a strict ladder on ``far_cost`` and on the modeled
``io_time`` of a scattered fetch, ``hbm < dram < ssd < hdd``, with ``ici``
above ``dram`` (the reference puts it below ``ssd``; the host copies of the
hop on one node cost about as much as the paper's SSD seek): the gradient
the tiered block-storage placement policy (:mod:`repro_torch.storage.
policy`) arbitrates over.
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


# ----------------------------------------------------------------------------
# Trend-line fitting (§4.3.1): max-R² among linear/log/poly2/power/exponential.
# ----------------------------------------------------------------------------

def _r2(y: np.ndarray, yhat: np.ndarray) -> float:
    ss_res = float(np.sum((y - yhat) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    return 1.0 - ss_res / ss_tot if ss_tot > 0 else (1.0 if ss_res == 0 else 0.0)


def fit_cost_curve(
    dists: np.ndarray, times: np.ndarray
) -> tuple[str, Callable[[np.ndarray], np.ndarray], float]:
    """Fit cost(dist) with the best-R² model family, as Google-Charts trendlines
    do (the paper's reference [5]).  Returns ``(family_name, curve_fn, r2)``."""
    x = np.asarray(dists, dtype=np.float64)
    y = np.asarray(times, dtype=np.float64)
    fits: list[tuple[str, Callable, float]] = []
    a, b = np.polyfit(x, y, 1)  # linear: y = a x + b
    fits.append(("linear", lambda d, a=a, b=b: a * d + b, _r2(y, a * x + b)))
    a, b = np.polyfit(np.log(x), y, 1)  # logarithmic: y = a ln x + b
    fits.append(
        ("logarithmic", lambda d, a=a, b=b: a * np.log(d) + b, _r2(y, a * np.log(x) + b))
    )
    c2, c1, c0 = np.polyfit(x, y, 2)  # polynomial (degree 2)
    fits.append((
        "polynomial",
        lambda d, c2=c2, c1=c1, c0=c0: c2 * d * d + c1 * d + c0,
        _r2(y, c2 * x * x + c1 * x + c0),
    ))
    if np.all(y > 0):
        a, lb = np.polyfit(np.log(x), np.log(y), 1)  # power: y = b x^a
        b = np.exp(lb)
        fits.append(
            ("power", lambda d, a=a, b=b: b * np.power(d, a), _r2(y, b * np.power(x, a)))
        )
        a, lb = np.polyfit(x, np.log(y), 1)  # exponential: y = b e^(a x)
        b = np.exp(lb)
        fits.append(
            ("exponential", lambda d, a=a, b=b: b * np.exp(a * d), _r2(y, b * np.exp(a * x)))
        )
    return max(fits, key=lambda f: f[2])


def profile_and_fit(
    sample_times: Callable[[np.ndarray], np.ndarray],
    max_dist: int,
    far_cost: float,
    seq_cost: float,
    first_block_cost: float,
    name: str = "profiled",
    num_points: int = 32,
    seed: int = 0,
) -> CostModel:
    """Paper §4.3.1: randomly probe distances ≤ t, fit the trend line."""
    rng = np.random.default_rng(seed)
    dists = np.unique(rng.integers(1, max_dist + 1, size=num_points))
    times = np.asarray(sample_times(dists), dtype=np.float64)
    _, curve, _ = fit_cost_curve(dists, times)
    return CostModel(
        name=name,
        seq_cost=seq_cost,
        max_dist=max_dist,
        far_cost=far_cost,
        curve=curve,
        first_block_cost=first_block_cost,
    )


# ----------------------------------------------------------------------------
# Presets
# ----------------------------------------------------------------------------

def _linear_curve(seq: float, far: float, t: int) -> Callable[[np.ndarray], np.ndarray]:
    # linear ramp from seq at d=1 to far at d=t (the shape the paper observed)
    def curve(d: np.ndarray) -> np.ndarray:
        d = np.asarray(d, dtype=np.float64)
        return seq + (far - seq) * (d - 1) / max(t - 1, 1)

    return curve


# Fitted by chip_smoke.py's calibration phase on one NVIDIA H100 80GB HBM3,
# 700.00 W power limit (bytes per second, seconds): BW = block_bytes / seq,
# latency = far - seq, at blocks of 270,336 B.  The tier-0 read of one more
# block costs no more scattered than adjacent (one gather launch serves
# both), so its latency is 0; its first-block cost, ~20 µs of launches, is
# not in the reference's form (first = far).
HBM_BYTES_PER_S = 603428994363.9644
HBM_LATENCY_S = 0.0
DRAM_BYTES_PER_S = 36810457308.40473
DRAM_LATENCY_S = 9.080000221729278e-06
# Fitted by chip_smoke.py's peer phase (PeerTimer) on one NVIDIA H100 80GB
# HBM3, 700.00 W power limit, at blocks of 270,336 B: the in-process peer hop
# on one node, each block's rows copied out of another shard's pinned host
# slot, staged with the call's other rows in one pinned buffer and copied to
# the card; not NVLink and not a network.  The hop is host work, so the fit
# follows the host's load (three runs: 57-272 µs a block); its latency is 0,
# since a block costs the same at any distance (the fitted far cost came out
# below the near one).
ICI_BYTES_PER_S = 993758226.2242911
ICI_LATENCY_S = 0.0


def _bandwidth_model(name: str, block_bytes: int, bw: float, latency: float,
                     t: int) -> CostModel:
    xfer = block_bytes / bw
    far = xfer + latency
    return CostModel(name, xfer, t, far, _linear_curve(xfer, far, t), far)


def make_cost_model(kind: str, block_bytes: int = 256 * 1024) -> CostModel:
    if kind == "hdd":
        # paper: sequential <1ms, far seek ~7ms, plateau at distance t
        t = 64
        return CostModel("hdd", 0.8e-3, t, 7e-3, _linear_curve(0.8e-3, 7e-3, t), 7e-3)
    if kind == "ssd":
        t = 4
        return CostModel("ssd", 5e-5, t, 7e-5, _linear_curve(5e-5, 7e-5, t), 7e-5)
    if kind == "hbm":
        return _bandwidth_model("hbm", block_bytes, HBM_BYTES_PER_S, HBM_LATENCY_S, 8)
    if kind == "dram":
        return _bandwidth_model("dram", block_bytes, DRAM_BYTES_PER_S, DRAM_LATENCY_S, 8)
    if kind == "ici":
        return _bandwidth_model("ici", block_bytes, ICI_BYTES_PER_S, ICI_LATENCY_S, 2)
    raise ValueError(f"unknown cost model kind {kind!r}")
