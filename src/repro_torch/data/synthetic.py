"""Synthetic workloads (paper §7.1), copied from ``repro/data/synthetic.py``.

The generators are numpy only and give the same bytes as the reference for
the same seed; the port keeps its own copy because the reference module
imports JAX through ``repro.data.block_store``.

* :func:`make_clustered_table` — the Anh & Moffat clustered-bitvector model the
  paper uses: each binary attribute's 1-bits arrive in random clusters until the
  target overall density is met.  Measures ~ Normal, independent of dims (and an
  optional layout-correlated measure to exercise the §5 debiasing).
* :func:`make_real_like_table` — layout proxies for the airline / taxi datasets:
  records sorted by a time-like column (airline) or by type-then-time (taxi), with
  low-cardinality categorical attributes; reproduces the locality structure that
  drives Figs. 4-6.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.block_store import Table


def _clustered_bits(
    n: int, density: float, rng: np.random.Generator, mean_cluster: int = 64
) -> np.ndarray:
    """Anh-Moffat clustered generation: place geometric-length runs of 1s at random
    offsets until ~density*n bits are set."""
    bits = np.zeros(n, dtype=bool)
    target = int(density * n)
    set_count = 0
    while set_count < target:
        length = 1 + rng.geometric(1.0 / mean_cluster)
        length = min(length, target - set_count)
        start = int(rng.integers(0, max(n - length, 1)))
        seg = bits[start : start + length]
        newly = int(length - seg.sum())
        seg[:] = True
        set_count += newly
    return bits


def make_clustered_table(
    num_records: int = 100_000,
    num_dims: int = 8,
    num_measures: int = 2,
    density: float = 0.1,
    seed: int = 0,
    correlated_measure: bool = False,
    mean_cluster: int = 64,
) -> Table:
    """Binary dimensions at 10% density, clustered layout (paper synthetic data)."""
    rng = np.random.default_rng(seed)
    dims = np.zeros((num_records, num_dims), dtype=np.int32)
    for a in range(num_dims):
        dims[:, a] = _clustered_bits(num_records, density, rng, mean_cluster).astype(np.int32)
    measures = rng.normal(100.0, 20.0, size=(num_records, num_measures)).astype(
        np.float32
    )
    if correlated_measure:
        # measure 0 drifts with record position -> layout-correlated aggregate,
        # the adversarial case for biased any-k estimation (§5 motivation)
        drift = np.linspace(-30.0, 30.0, num_records, dtype=np.float32)
        measures[:, 0] += drift
    cards = np.full(num_dims, 2, dtype=np.int64)
    return Table(dims=dims, measures=measures, cards=cards)


def make_real_like_table(
    kind: str = "airline",
    num_records: int = 200_000,
    seed: int = 0,
) -> Table:
    """Layout proxies for the paper's real datasets.

    airline: sorted by time; attrs = (month[12], day_of_week[7], carrier[12],
             origin[30], dest[30]); measures = (arr_delay, dep_delay, elapsed).
    taxi:    sorted by (taxi_type, time); attrs = (taxi_type[3], month[12],
             hour_slot[8], pickup_zone[40], passenger_count[6], vendor[2]);
             measures = (fare, distance).  Predicates not based on taxi type are
             spread ~uniformly (the paper's "adversarial" case for THRESHOLD).
    """
    rng = np.random.default_rng(seed)
    n = num_records
    if kind == "airline":
        time = np.sort(rng.uniform(0.0, 1.0, n))  # sorted by time
        month = np.floor(time * 12).astype(np.int32) % 12
        dow = (np.floor(time * 365) % 7).astype(np.int32)
        carrier = rng.integers(0, 12, n).astype(np.int32)
        origin = np.minimum(rng.geometric(0.12, n) - 1, 29).astype(np.int32)
        dest = np.minimum(rng.geometric(0.12, n) - 1, 29).astype(np.int32)
        dims = np.stack([month, dow, carrier, origin, dest], axis=1)
        cards = np.asarray([12, 7, 12, 30, 30], dtype=np.int64)
        arr_delay = rng.gamma(2.0, 12.0, n) - 10.0 + 6.0 * month  # month-correlated
        dep_delay = rng.gamma(2.0, 10.0, n) - 8.0
        elapsed = rng.normal(140.0, 45.0, n)
        meas = np.stack([arr_delay, dep_delay, elapsed], axis=1).astype(np.float32)
    elif kind == "taxi":
        ttype = np.sort(rng.choice(3, n, p=[0.55, 0.3, 0.15])).astype(np.int32)
        time = np.zeros(n)
        for t in range(3):  # time-sorted within each type partition
            m = ttype == t
            time[m] = np.sort(rng.uniform(0.0, 1.0, int(m.sum())))
        month = np.floor(time * 12).astype(np.int32) % 12
        hour = rng.integers(0, 8, n).astype(np.int32)
        zone = np.minimum(rng.geometric(0.08, n) - 1, 39).astype(np.int32)
        pax = np.minimum(rng.geometric(0.5, n) - 1, 5).astype(np.int32)
        vendor = rng.integers(0, 2, n).astype(np.int32)
        dims = np.stack([ttype, month, hour, zone, pax, vendor], axis=1)
        cards = np.asarray([3, 12, 8, 40, 6, 2], dtype=np.int64)
        fare = (rng.gamma(2.5, 6.0, n) + 3.0 + 2.0 * ttype).astype(np.float32)
        dist = (rng.gamma(2.0, 1.6, n)).astype(np.float32)
        meas = np.stack([fare, dist], axis=1).astype(np.float32)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return Table(dims=dims.astype(np.int32), measures=meas, cards=cards)
