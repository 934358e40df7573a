"""The one traffic generator: queries and arrivals from a mix's parameters.

A mix (``traffic/<name>.json``) says how queries arrive: an open loop of
Poisson arrivals at the cell's rate, or a closed loop of clients.  Its
queries are the configuration's: a template (its dimensions) with values
from ``values``, AND, and k a sampling rate (the configuration's
``sample_rates``) of the query's matches, which set-up counts; the pool
takes every (template, rate) pair in turn, so each is equally common.

Every seed gets the same work in another order: the queries (and an open
loop's gaps between arrivals) are a pool of ``pool`` draws from one fixed
seed, and a run's ``--seed`` deals them out in a fresh permutation each
time the pool is used up.  Work drawn afresh per seed made the heavy
queries' share, and with it the rate and the tails, differ from seed to
seed far more than between two runs of one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

STREAM_WINDOW = 1
STREAM_WARMUP = 2
STREAM_CHECK = 3
STREAM_ARRIVALS = 4


@dataclasses.dataclass(frozen=True)
class Query:
    predicates: tuple  # ((attr, value), ...)
    k: int
    op: str


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), stream])


POOL_SEED = 0  # the pool every seed shares


class QueryStream:
    """An endless stream of the mix's queries: the pool, dealt out by the
    seed.  ``count`` answers how many rows match a predicate tuple (set-up
    work, memoised here)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, stream: int,
                 count: Callable[[tuple], int]):
        self.cfg, self.mix = cfg, mix
        self.count = count
        self._matches: dict = {}
        if mix["queries"] != "templates":
            raise ValueError(f"unknown query kind {mix['queries']!r}")
        draw = rng(POOL_SEED, stream)
        self.pool = [self._draw(draw, i) for i in range(int(mix["pool"]))]
        self.order = rng(seed, stream)
        self._deck: list[int] = []

    def _draw(self, r: np.random.Generator, i: int) -> Query:
        values = self.cfg["values"]
        templates, rates = self.cfg["templates"], self.cfg["sample_rates"]
        stratum = i % (len(templates) * len(rates))
        attrs = templates[stratum // len(rates)]
        preds = tuple((int(a), int(values[a][r.integers(len(values[a]))])) for a in attrs)
        if preds not in self._matches:
            self._matches[preds] = int(self.count(preds))
        rate = rates[stratum % len(rates)]
        return Query(preds, max(int(rate * self._matches[preds]), 1), "and")

    def next(self) -> Query:
        if not self._deck:
            self._deck = self.order.permutation(len(self.pool)).tolist()
        return self.pool[self._deck.pop()]

    def take(self, n: int) -> list[Query]:
        return [self.next() for _ in range(n)]


def poisson_arrivals(rate_per_s: float, seconds: float, seed: int, pool: int) -> np.ndarray:
    """Arrival times in ``[0, seconds)`` of a Poisson process: a fixed pool of
    exponential gaps, dealt out by the seed as :class:`QueryStream` deals
    queries."""
    gaps = rng(POOL_SEED, STREAM_ARRIVALS).exponential(1.0 / rate_per_s, size=pool)
    order = rng(seed, STREAM_ARRIVALS)
    out: list[np.ndarray] = []
    t = 0.0
    while True:
        times = t + np.cumsum(gaps[order.permutation(pool)])
        out.append(times[times < seconds])
        if times[-1] >= seconds:
            return np.concatenate(out)
        t = float(times[-1])
