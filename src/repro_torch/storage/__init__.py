"""Tiered block storage (counterpart of ``repro/storage``): a slot pool on
the card → pinned host memory → backing store.

* :class:`~repro_torch.storage.tiers.TierStack` / :class:`~repro_torch.
  storage.tiers.Tier` / :func:`~repro_torch.storage.tiers.make_tier_stack`
  — the byte-budgeted hierarchy, drop-in for ``NeedleTailEngine.
  block_cache`` (``NeedleTailEngine(tiers=...)``).
* :class:`~repro_torch.storage.policy.CostAwarePolicy` /
  :class:`~repro_torch.storage.policy.RecencyPolicy` — placement arbiters.
* :func:`~repro_torch.storage.residency.wave_is_resident` /
  :func:`~repro_torch.storage.residency.make_residency_probe` — the
  stat-free residency peek.
* :class:`~repro_torch.storage.prefetch.TierPrefetcher` /
  :func:`~repro_torch.storage.prefetch.predicted_wave_blocks` /
  :func:`~repro_torch.storage.prefetch.make_missed_cost_probe` — memo-driven
  next-wave prefetch and the cost-fed admission probe.
* :func:`~repro_torch.storage.calibration.calibrate_model` /
  :func:`~repro_torch.storage.calibration.calibrate_stack` /
  :class:`~repro_torch.storage.calibration.StoreTimingBackend` /
  :class:`~repro_torch.storage.calibration.SyntheticTimingBackend` — fit
  each level's ``CostModel`` to measured read times.
* :func:`~repro_torch.storage.compact.compact_tail` /
  :class:`~repro_torch.storage.compact.TailCompactor` — density-restoring
  compaction of the appended tail.

The reference's peer tier and ownership rebalancer arrive with the
multi-GPU slice of the port.
"""
from repro_torch.storage.calibration import (
    StoreTimingBackend, SyntheticTimingBackend, calibrate_model, calibrate_stack, measurable,
)
from repro_torch.storage.compact import TailCompactor, compact_tail
from repro_torch.storage.policy import CostAwarePolicy, PlacementPolicy, RecencyPolicy
from repro_torch.storage.prefetch import (
    PrefetchStats, TierPrefetcher, make_missed_cost_probe, predicted_wave_blocks,
)
from repro_torch.storage.residency import make_residency_probe, wave_is_resident
from repro_torch.storage.tiers import Tier, TierStack, TierStats, make_tier_stack

__all__ = [
    "CostAwarePolicy",
    "PlacementPolicy",
    "PrefetchStats",
    "RecencyPolicy",
    "StoreTimingBackend",
    "SyntheticTimingBackend",
    "TailCompactor",
    "Tier",
    "TierPrefetcher",
    "TierStack",
    "TierStats",
    "calibrate_model",
    "calibrate_stack",
    "compact_tail",
    "make_missed_cost_probe",
    "make_residency_probe",
    "make_tier_stack",
    "measurable",
    "predicted_wave_blocks",
    "wave_is_resident",
]
