"""Measured-cost calibration: fit each tier's `CostModel` to real timings.

Counterpart of ``repro/storage/calibration.py``.  The presets in
:mod:`repro_torch.core.cost_model` describe the hardware they were measured
on; this module makes the engine converge on the hardware it
*actually* runs on.  A **timing backend** answers "how long does fetching
these block ids at this tier level take, in seconds":

* :class:`StoreTimingBackend` times real ``BlockStore.fetch`` calls with
  an injectable clock (``time.perf_counter`` by default) — the production
  path `NeedleTailEngine(calibrated_cost=True)` installs at engine start.
  On a card the fetch is asynchronous, so the backend synchronises the
  store's device before each clock read: the window then holds the read
  itself, not its launch.
* :class:`SyntheticTimingBackend` answers from ground-truth `CostModel`s
  — fully deterministic, what the tests drive so "measured" timings are reproducible.

:func:`calibrate_model` reuses the paper's §4.3.1 fitting procedure
(`profile_and_fit`, max-R² trend line over probed distances) against the
backend: it measures κ (first-block cost), finds the seek plateau onset
with a coarse geometric ladder (→ ``max_dist``), then fits the near-field
curve.  The fitted model keeps ``name == level`` so every consumer that
keys on the model name (the plan ledger, placement corrections, the
timing backend itself) is stable across recalibrations.

:func:`calibrate_stack` refits every *measurable* level of a `TierStack`
(tiers by tier name, the backing store by its model name) in place —
exposed as ``TierStack.calibrate()``.  Levels the backend cannot measure
(e.g. a peer tier when only the local store is instrumented) keep their
presets; the plan ledger's multiplicative corrections still cover them.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

import torch

from repro_torch.core.cost_model import CostModel, _linear_curve, profile_and_fit

__all__ = [
    "SyntheticTimingBackend",
    "StoreTimingBackend",
    "calibrate_model",
    "calibrate_stack",
    "measurable",
]


class SyntheticTimingBackend:
    """Deterministic timing backend: answers from ground-truth cost models.

    ``models`` maps a tier level name (``"dram"``, ``"ssd"``, the backing
    model's name, a peer tier's name, ...) to the `CostModel` that is the
    *actual* behaviour of that level.  Used by tests and benches to make a
    store whose "real" timings deliberately deviate from its presets.
    """

    def __init__(self, models: Mapping[str, CostModel]):
        self.models = dict(models)
        self.calls = 0

    def levels(self) -> set[str]:
        return set(self.models)

    def io_seconds(self, level: str, block_ids: Sequence[int]) -> float:
        self.calls += 1
        return float(self.models[level].io_time(block_ids))


class StoreTimingBackend:
    """Times real ``BlockStore.fetch`` calls (best-of-``repeats``).

    Only measures the backing-store level (``levels`` defaults to ``None``
    = "any level asked for is served by this store"); pass an explicit set
    to restrict.  The clock is injectable so tests can drive it with a
    simulated timer.
    """

    def __init__(
        self,
        store,
        levels: Iterable[str] | None = None,
        clock: Callable[[], float] = time.perf_counter,
        repeats: int = 3,
    ):
        self.store = store
        self._levels = None if levels is None else set(levels)
        self.clock = clock
        self.repeats = max(int(repeats), 1)
        self.calls = 0

    @property
    def max_block_id(self) -> int:
        return int(self.store.num_blocks) - 1

    def levels(self) -> set[str] | None:
        return self._levels

    def _sync(self) -> None:
        dev = torch.device(self.store.device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def io_seconds(self, level: str, block_ids: Sequence[int]) -> float:
        if self._levels is not None and level not in self._levels:
            raise KeyError(f"backend does not measure level {level!r}")
        ids = np.asarray(list(block_ids), dtype=np.int64)
        ids = np.clip(ids, 0, self.max_block_id)
        best = float("inf")
        for _ in range(self.repeats):
            self._sync()
            t0 = self.clock()
            self.store.fetch(ids)
            self._sync()
            best = min(best, self.clock() - t0)
        self.calls += 1
        return best


def measurable(backend, level: str) -> bool:
    """True when `backend` can time fetches at tier level `level`."""
    if backend is None:
        return False
    lv = backend.levels() if hasattr(backend, "levels") else None
    return lv is None or level in lv


def calibrate_model(
    backend,
    level: str,
    *,
    base: CostModel,
    num_points: int = 24,
    probe_block: int = 0,
    seed: int = 0,
) -> CostModel:
    """Fit a `CostModel` for tier `level` from backend timings (§4.3.1).

    Measurement protocol: κ is the time to fetch a single block; the cost
    of distance d is ``time([b, b+d]) - κ`` (the §4.1 ascending fetch pays
    κ once plus one rand_io per adjacent pair).  A coarse geometric ladder
    up to ``4 * base.max_dist`` locates the seek plateau (first distance
    whose cost reaches 98% of the far cost → ``max_dist``); the near field
    is then fitted with `profile_and_fit`'s max-R² trend line.  The probe
    span is clamped to the backend's ``max_block_id`` when it exposes one,
    and `base` supplies the prior search range — a mis-preset base only
    costs probe efficiency, not correctness.
    """
    probe = int(probe_block)
    kappa = max(float(backend.io_seconds(level, [probe])), 1e-12)

    span = max(int(base.max_dist) * 4, 64)
    limit = getattr(backend, "max_block_id", None)
    if limit is not None:
        span = max(min(span, int(limit) - probe), 2)

    def pair_cost(d: int) -> float:
        return max(float(backend.io_seconds(level, [probe, probe + int(d)])) - kappa, 1e-12)

    far = pair_cost(span)
    ladder = sorted({min(max(int(round(span ** (i / 16.0))), 1), span) for i in range(17)})
    max_dist = span
    for d in ladder:
        if pair_cost(d) >= 0.98 * far:
            max_dist = max(int(d), 1)
            break
    seq = pair_cost(1)

    if max_dist < 4:
        # too few distinct near-field distances to fit a trend line
        return CostModel(level, seq, max_dist, far, _linear_curve(seq, far, max_dist), kappa)
    return profile_and_fit(
        sample_times=lambda ds: np.asarray([pair_cost(int(d)) for d in np.asarray(ds).ravel()]),
        max_dist=int(max_dist),
        far_cost=far,
        seq_cost=seq,
        first_block_cost=kappa,
        name=level,
        num_points=num_points,
        seed=seed,
    )


def calibrate_stack(stack, backend, *, levels: Iterable[str] | None = None, **fit_kw) -> dict[str, CostModel]:
    """Refit every measurable level of `stack` in place; returns {level: model}.

    Tiers are keyed by ``tier.name``, the backing store by its model name.
    The backend is retained on the stack (``stack.timing_backend``) so the
    demand path can keep recording placement observations into the plan
    ledger after calibration.
    """
    want = None if levels is None else set(levels)
    fitted: dict[str, CostModel] = {}
    for tier in stack.tiers:
        lv = tier.name
        if (want is None or lv in want) and measurable(backend, lv):
            tier.cost = fitted[lv] = calibrate_model(backend, lv, base=tier.cost, **fit_kw)
    lv = stack.backing.name
    if (want is None or lv in want) and measurable(backend, lv):
        stack.backing = fitted[lv] = calibrate_model(backend, lv, base=stack.backing, **fit_kw)
    stack.timing_backend = backend
    ledger = getattr(stack, "ledger", None)
    if ledger is not None:
        # the refit models embody the observed costs: stale multiplicative
        # corrections for those levels would double-apply the same error
        for lv in fitted:
            ledger.reset_correction(lv)
    return fitted
