"""Unequal-probability estimators (paper §5.2): Horvitz-Thompson and ratio.

Counterpart of ``repro/core/estimators.py``, on the host: the inputs are
per-block statistics of size O(blocks), which the engine computes on the
card (:func:`repro_torch.core.engine.block_partials`), and the estimates
are numpy scalar sums with the reference's dtypes.

Inputs are block-level statistics of the *fetched* blocks:
  tau_i = per-block sum of the measure over valid records,
  L_i   = per-block count of valid records,
  pi_i  = per-block inclusion probabilities from the HybridPlan.

Estimates (Eqs. 1-8):
  HT:    tau_hat = Σ tau_i / pi_i          mu_hat = tau_hat / L
  ratio: mu_hat  = tau_hat / Σ (L_i/pi_i)  tau_hat = mu_hat * L
plus the corresponding variance estimators.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hybrid import HybridPlan

# two-sided 95% normal quantile: the CI the online aggregation
# (repro_torch.core.online_agg) closes error-SLO requests against
Z95 = 1.959963984540054


@dataclasses.dataclass(frozen=True)
class Estimate:
    total: float  # tau_hat
    mean: float  # mu_hat
    var_total: float
    var_mean: float
    num_samples: int

    @property
    def se_mean(self) -> float:
        return float(np.sqrt(max(self.var_mean, 0.0)))

    def ci_halfwidth(self, z: float = Z95) -> float:
        """Normal-approximation CI half-width on the mean (default 95%)."""
        return z * self.se_mean


def _guarded_pi_r(plan: HybridPlan, nr: int) -> float:
    """π_r with the degenerate corners pinned to defined values.

    * empty random arm (``nr == 0``): π_r never scales a real term — return
      1.0 so the ``/ pi_r`` divisions are exact no-ops on empty sums;
    * ``π_r → 0`` with a non-empty arm (an inconsistent or stale plan):
      floor at the SRSWOR-consistent ``nr / rem`` — a realized sample of
      ``nr`` blocks implies π_r ≥ nr/rem — instead of the old 1e-12 floor
      that inflated totals by ~1e12.
    """
    if nr == 0:
        return 1.0
    if plan.pi_r > 0.0:
        return float(plan.pi_r)
    rem = plan.num_valid_blocks - len(plan.sc)
    return nr / max(rem, nr)


def _pairwise_terms(
    tau_c: np.ndarray, tau_r: np.ndarray, plan: HybridPlan, center: float = 0.0
) -> float:
    """Σ_i Σ_{j≠i} ((π_ij − π_i π_j)/π_ij) (τ_i−c)(τ_j−c)/(π_i π_j) over
    sampled blocks — the Horvitz-Thompson variance *estimator's* pairwise
    term (each pair inverse-weighted by its own π_ij, so the sample sum is
    unbiased for the population sum; the coverage tests lock this
    calibration).

    For the hybrid design the (S_c, S_c) and (S_c, S_r) terms vanish
    (π_ij = π_i π_j); only (S_r, S_r) pairs contribute.  A single sampled
    random block (or remaining set) has no pairs: the early-out below is the
    degenerate-input guard, not a NaN.
    """
    tr = tau_r - center
    nr, rem = len(tau_r), plan.num_valid_blocks - len(plan.sc)
    if nr < 2 or rem < 2:
        return 0.0
    p1 = nr / rem
    p2 = p1 * (nr - 1) / (rem - 1)
    w = (p2 - p1 * p1) / (p2 * p1 * p1)
    s = float(np.sum(tr)) ** 2 - float(np.sum(tr * tr))
    return w * s


def horvitz_thompson(
    tau_c: np.ndarray,
    tau_r: np.ndarray,
    n_c: np.ndarray,
    n_r: np.ndarray,
    plan: HybridPlan,
    population_size: float,
) -> Estimate:
    """Eqs. 1-4. ``tau_c``/``tau_r``: block sums for S_c / S_r blocks."""
    pi_r = _guarded_pi_r(plan, len(tau_r))
    tau_hat = float(np.sum(tau_c) + np.sum(tau_r) / pi_r)
    # Var (Eq. 3, estimator form): the (1-π)/π² leading term is zero for
    # S_c blocks (π=1).  A single sampled S_r block keeps only that leading
    # term — _pairwise_terms' nr<2 early-out is the guard, not a NaN.
    var = float(np.sum((1.0 - pi_r) / pi_r**2 * tau_r**2)) + _pairwise_terms(
        tau_c, tau_r, plan
    )
    var = max(var, 0.0)
    n = int(np.sum(n_c) + np.sum(n_r))
    L = float(population_size)
    if L <= 0.0:
        # empty population: the mean of nothing is defined as 0, not τ/1e-12
        return Estimate(tau_hat, 0.0, var, 0.0, n)
    return Estimate(tau_hat, tau_hat / L, var, var / (L * L), n)


def ratio_estimator(
    tau_c: np.ndarray,
    tau_r: np.ndarray,
    n_c: np.ndarray,
    n_r: np.ndarray,
    plan: HybridPlan,
    population_size: float,
) -> Estimate:
    """Eqs. 5-8: mu_hat_R = tau_hat_HT / L_hat_HT."""
    pi_r = _guarded_pi_r(plan, len(tau_r))
    tau_hat_ht = float(np.sum(tau_c) + np.sum(tau_r) / pi_r)
    L_hat = float(np.sum(n_c) + np.sum(n_r) / pi_r)
    # zero valid rows in the sample: no observed support, so the ratio mean
    # is defined as 0 rather than the 1e-12-floored division blow-up
    mu_hat = tau_hat_ht / L_hat if L_hat > 0.0 else 0.0
    L = float(population_size)
    if L <= 0.0:
        n = int(np.sum(n_c) + np.sum(n_r))
        return Estimate(0.0, mu_hat, 0.0, 0.0, n)
    tau_hat = mu_hat * L
    # Var (Eq. 7) with τ_i − μ·L_i residuals (mean-centered block totals)
    res_c = tau_c - mu_hat * n_c
    res_r = tau_r - mu_hat * n_r
    var_mu = (
        float(np.sum((1.0 - pi_r) / pi_r**2 * res_r**2))
        + _pairwise_terms(res_c, res_r, plan)
    ) / (L * L)
    var_mu = max(var_mu, 0.0)
    n = int(np.sum(n_c) + np.sum(n_r))
    return Estimate(tau_hat, mu_hat, var_mu * L * L, var_mu, n)
