"""Plan ledger: per-wave, per-tier predicted-vs-observed io_time q-error.

Counterpart of ``repro/core/plan_ledger.py`` (host bookkeeping, unchanged).
Every pricing decision in the engine — `CostAwarePolicy` placement, the
§7.2 THRESHOLD/TWO-PRONG arbitration, `cheap_cost_s` admission, and
`TierPrefetcher` pricing — trusts a `CostModel`.  The ledger closes the
loop: each decision site records the price it quoted next to the fetch
time actually observed (wall clock or a deterministic timing backend),
and the ledger maintains the running **q-error**

    qerror = max(pred / obs, obs / pred)   (>= 1, 1 = perfect)

per (site, tier) as an EWMA in log space.  From the signed log-ratio it
derives a bounded multiplicative **correction** per tier that the pricing
sites multiply into their model costs, so repeated misprediction shifts
placement/admission/prefetch decisions toward observed costs even between
full recalibrations.

Two properties the rest of the system relies on:

- **Hysteresis, no oscillation.**  The applied correction only moves when
  the freshly proposed value deviates from it by more than the hysteresis
  band; on commit the residual EWMA resets to zero (the accumulated
  residual was measured against the *old* correction, re-applying it
  would double-count).  Between two `record()` calls `correction()` is
  idempotent, so pricing two plan candidates in one arbitration sees one
  consistent scale.
- **Byte-identity.**  Corrections are uniform per tier, so scaling both
  §7.2 candidates of a flat-cache plan by the same factor preserves the
  argmin — plans, placement, and prices may change, result bytes do not
  (the opt-in residency-aware arm is the documented exception, as ever).

`PlanLedger(feedback=False)` keeps the bookkeeping (q-error audit trail,
per-wave series) but pins every correction at 1.0 — the "static presets"
control arm benchmarks compare against.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

__all__ = ["PlanLedger", "SiteStats", "SITES"]

# Decision sites that record into the ledger.  Free-form strings are
# accepted (record() creates stats lazily) but the engine uses these.
SITES = ("placement", "arbitration", "admission", "prefetch")

_EPS = 1e-12


@dataclass
class SiteStats:
    """Running error statistics for one (decision site, tier) pair.

    ``ewma_log_ratio`` is the signed EWMA of log(obs/pred) — the bias the
    correction chases.  ``ewma_abs_log`` is the EWMA of |log(obs/pred)|;
    ``exp(ewma_abs_log)`` is the running q-error.  ``max_qerror`` keeps the
    worst single observation for audit (it is *not* decayed).
    """

    count: int = 0
    ewma_log_ratio: float = 0.0
    ewma_abs_log: float = 0.0
    last_qerror: float = 1.0
    max_qerror: float = 1.0

    @property
    def qerror(self) -> float:
        return math.exp(self.ewma_abs_log)


@dataclass
class PlanLedger:
    """Records predicted vs observed io_time and serves corrections.

    Parameters
    ----------
    alpha:
        EWMA weight of the newest observation (0.5 = fast adaptation; the
        calibration pass, not the ledger, carries the long-term model).
    hysteresis:
        Relative dead-band for correction updates: the applied correction
        moves only when the proposal deviates from it by more than this
        fraction (compared in log space via ``log1p``).
    correction_bounds:
        Hard clamp on the multiplicative correction — a runaway ledger can
        bias pricing by at most this factor either way.
    feedback:
        When False, ``correction()`` always returns 1.0 (audit-only mode).
    """

    alpha: float = 0.5
    hysteresis: float = 0.15
    correction_bounds: tuple[float, float] = (0.125, 8.0)
    feedback: bool = True
    sites: dict[tuple[str, str], SiteStats] = field(default_factory=dict)
    waves: list[dict] = field(default_factory=list)
    _applied: dict[str, float] = field(default_factory=dict)
    _wave_pred: dict[str, float] = field(default_factory=dict)
    _wave_obs: dict[str, float] = field(default_factory=dict)

    # ---------------------------------------------------------------- record
    def record(self, site: str, tier: str, predicted: float, observed: float) -> float:
        """Log one priced decision; returns the instantaneous q-error."""
        pred = max(float(predicted), _EPS)
        obs = max(float(observed), _EPS)
        lr = math.log(obs / pred)
        st = self.sites.get((site, tier))
        if st is None:
            st = self.sites[(site, tier)] = SiteStats()
        if st.count == 0:
            st.ewma_log_ratio = lr
            st.ewma_abs_log = abs(lr)
        else:
            a = self.alpha
            st.ewma_log_ratio = (1.0 - a) * st.ewma_log_ratio + a * lr
            st.ewma_abs_log = (1.0 - a) * st.ewma_abs_log + a * abs(lr)
        st.count += 1
        st.last_qerror = math.exp(abs(lr))
        st.max_qerror = max(st.max_qerror, st.last_qerror)
        if site == "placement":
            self._wave_pred[tier] = self._wave_pred.get(tier, 0.0) + pred
            self._wave_obs[tier] = self._wave_obs.get(tier, 0.0) + obs
        return st.last_qerror

    # ------------------------------------------------------------ correction
    def correction(self, tier: str) -> float:
        """Multiplicative factor pricing sites apply to `tier`'s model cost.

        Chases the placement-site bias for that tier with hysteresis; the
        committed value only changes when the proposal leaves the dead
        band, and committing resets the residual EWMA (see module doc).
        Idempotent between ``record()`` calls.
        """
        if not self.feedback:
            return 1.0
        applied = self._applied.get(tier, 1.0)
        st = self.sites.get(("placement", tier))
        if st is None or st.count == 0:
            return applied
        lo, hi = self.correction_bounds
        proposal = min(max(applied * math.exp(st.ewma_log_ratio), lo), hi)
        if abs(math.log(proposal / applied)) > math.log1p(self.hysteresis):
            self._applied[tier] = proposal
            st.ewma_log_ratio = 0.0
            return proposal
        return applied

    def corrections(self) -> dict[str, float]:
        """Currently applied correction per tier (committed values only)."""
        return dict(self._applied)

    def reset_correction(self, tier: str | None = None) -> None:
        """Drop applied corrections (one tier, or all) and their residuals.

        Called by the calibration pass after refitting a level's model: the
        fitted model now *embodies* the observed costs, so keeping the old
        multiplicative correction (and the residual EWMA measured against
        the old model) would double-apply the same error.  The q-error audit
        trail (``ewma_abs_log`` / ``max_qerror``) is untouched — it decays
        naturally as post-calibration residuals come in small.
        """
        if tier is None:
            self._applied.clear()
        else:
            self._applied.pop(tier, None)
        for (s, t), st in self.sites.items():
            if tier is None or t == tier:
                st.ewma_log_ratio = 0.0

    # --------------------------------------------------------------- queries
    def qerror(self, site: str | None = None, tier: str | None = None) -> float:
        """Running q-error: max over matching (site, tier) stats, 1.0 if none."""
        vals = [
            st.qerror
            for (s, t), st in self.sites.items()
            if (site is None or s == site) and (tier is None or t == tier)
        ]
        return max(vals) if vals else 1.0

    def max_qerror(self, site: str | None = None, tier: str | None = None) -> float:
        """Worst single observation ever seen by matching sites (audit)."""
        vals = [
            st.max_qerror
            for (s, t), st in self.sites.items()
            if (site is None or s == site) and (tier is None or t == tier)
        ]
        return max(vals) if vals else 1.0

    # ----------------------------------------------------------------- waves
    def note_wave(self) -> dict:
        """Close the current wave: snapshot per-tier and running q-error.

        Appends (and returns) a row with the wave's aggregate placement
        q-error per tier (sum-pred vs sum-obs over the wave), ``qerror`` =
        the worst of those (1.0 for a wave with no placement observations
        — e.g. fully warm with no measurable hits), ``running`` = the EWMA
        placement q-error across all history, and the committed corrections
        — the audit trail a calibration run asserts shrinks
        monotonically.
        """
        per_tier = {
            t: max(self._wave_pred[t] / max(self._wave_obs.get(t, 0.0), _EPS),
                   self._wave_obs.get(t, 0.0) / max(self._wave_pred[t], _EPS))
            for t in self._wave_pred
        }
        row = {
            "wave": len(self.waves),
            "qerror": max(per_tier.values()) if per_tier else 1.0,
            "running": self.qerror(site="placement"),
            "per_tier": per_tier,
            "corrections": self.corrections(),
        }
        self.waves.append(row)
        self._wave_pred.clear()
        self._wave_obs.clear()
        return row

    def wave_qerrors(self) -> list[float]:
        """Running placement q-error at each `note_wave()` boundary."""
        return [w["qerror"] for w in self.waves]
