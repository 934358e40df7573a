"""Admission arbitration for the serving path.

Counterpart of ``repro/serving/admission.py``, reduced to the pure function
the online aggregation imports: :func:`arbitrate_aggregate`, the third
arbitration arm (fetch more blocks vs answer now within the CI).  The
queue-driven ``AdmissionController`` and its launch arms arrive with the
serving slice of the port.
"""
from __future__ import annotations


def arbitrate_aggregate(
    *,
    halfwidth: float,
    error_slo: float | None = None,
    deadline_s: float | None = None,
    spent_s: float = 0.0,
    next_cost_s: float = 0.0,
    predicted_halfwidth: float | None = None,
    max_s_per_width: float | None = None,
) -> str | None:
    """Decide after every fold whether a seated aggregate stops, priced in
    the modeled seconds of :func:`repro_torch.storage.prefetch.
    effective_block_cost`.  Returns the leave reason, or ``None`` to keep
    fetching:

    * ``"ci"`` — the error SLO is met: the 95% CI half-width closed;
    * ``"deadline"`` — spent + the next chunk's modeled I/O would overrun
      ``deadline_s``: answer now with the best estimate (never start a
      chunk you cannot afford);
    * ``"diminishing"`` — optional marginal-value cutoff: the next chunk's
      modeled seconds per expected unit of CI-width reduction exceed
      ``max_s_per_width``.
    """
    if error_slo is not None and halfwidth <= error_slo:
        return "ci"
    if deadline_s is not None and spent_s + next_cost_s > deadline_s:
        return "deadline"
    if (
        max_s_per_width is not None
        and predicted_halfwidth is not None
        and halfwidth != float("inf")
    ):
        gain = halfwidth - predicted_halfwidth
        if gain <= 0.0 or next_cost_s / gain > max_s_per_width:
            return "diminishing"
    return None
