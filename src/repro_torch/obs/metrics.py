"""MetricsRegistry: counters, gauges, and bounded histograms (p50/p99).

Counterpart of ``repro/obs/metrics.py``: one registry takes the engine's
per-subsystem ledgers (``CacheStats``, per-tier counters,
``AdmissionStats``, ``PrefetchStats``, per-wave deltas) under one naming
contract:

* names are dotted lowercase paths, ``<component>.<metric>`` (e.g.
  ``admission.wait_s``, ``wave.exemplar.rounds``);
* counters are monotonic sums; :meth:`MetricsRegistry.absorb` *sets* the
  absolute value of a subsystem's snapshot (the subsystem stays the source
  of truth);
* histogram names carry their unit as a suffix (``_s``, ``_ms``);
  quantiles are nearest-rank over a bounded window of samples;
* :meth:`MetricsRegistry.render_prometheus` replaces ``.`` with ``_`` and
  gives a histogram as ``<name>_count`` / ``_p50`` / ``_p99``.

The registry allocates nothing until the first write.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Mapping


class MetricsRegistry:
    """Counters, gauges and histograms with deterministic snapshots.

    ``max_samples`` bounds each histogram's window (the oldest samples fall
    off first), so a long serving run stays O(1) in memory while p50/p99
    follow recent behaviour.
    """

    def __init__(self, max_samples: int = 4096):
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self._hists: dict[str, deque] = {}
        self._max_samples = int(max_samples)

    # ------------------------------------------------------------------ write
    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = deque(maxlen=self._max_samples)
        h.append(float(value))

    def absorb(self, prefix: str, counters: Mapping) -> None:
        """Mirror a subsystem's counter snapshot under ``<prefix>.<key>``:
        values are set absolutely, non-numeric entries skipped."""
        for k, v in counters.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.counters[f"{prefix}.{k}"] = float(v)

    # ------------------------------------------------------------------- read
    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def quantile(self, name: str, q: float) -> float:
        """Nearest-rank quantile of histogram ``name`` (0.0 when empty)."""
        h = self._hists.get(name)
        if not h:
            return 0.0
        vs = sorted(h)
        idx = max(0, min(len(vs) - 1, math.ceil(q * len(vs)) - 1))
        return vs[idx]

    def hist_stats(self, name: str) -> dict:
        h = self._hists.get(name)
        if not h:
            return {"count": 0, "p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
        return {
            "count": len(h),
            "p50": self.quantile(name, 0.50),
            "p99": self.quantile(name, 0.99),
            "mean": sum(h) / len(h),
            "max": max(h),
        }

    def snapshot(self) -> dict:
        """Deterministic (sorted-key) snapshot of the whole registry."""
        return {
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
            "histograms": {k: self.hist_stats(k) for k in sorted(self._hists)},
        }

    def render_prometheus(self) -> str:
        """Prometheus-style text exposition of the registry."""
        lines: list[str] = []

        def _name(n: str) -> str:
            return n.replace(".", "_").replace("-", "_")

        for k in sorted(self.counters):
            n = _name(k)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {self.counters[k]:g}")
        for k in sorted(self.gauges):
            n = _name(k)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {self.gauges[k]:g}")
        for k in sorted(self._hists):
            n = _name(k)
            st = self.hist_stats(k)
            lines.append(f"# TYPE {n} summary")
            lines.append(f"{n}_count {st['count']}")
            lines.append(f"{n}_p50 {st['p50']:g}")
            lines.append(f"{n}_p99 {st['p99']:g}")
        return "\n".join(lines) + "\n"
