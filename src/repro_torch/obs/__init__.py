"""Unified observability: trace spans, metrics, and the wave-stats schema.

Counterpart of ``repro/obs``.  One :class:`TraceRecorder` (the ``obs=``
object the engine, the wave loops, the tier stack, the prefetcher,
admission and the serving loops accept) carries both the structured
span/event stream and a :class:`MetricsRegistry`; :func:`make_wave_stats`
is the one schema every serving pool's ``last_wave_stats`` conforms to.
Everything is opt-in: ``obs=None`` keeps every traced site at one attribute
test, and a disabled recorder makes zero clock reads and buffers nothing.

The plane is host code: it reads the host clock only and never synchronises
the card, so a span around device work measures what the host waits for.
"""
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import HOST_STEP_SPANS, NULL_SPAN, TraceRecorder, span_or_null
from repro_torch.obs.wave_stats import WAVE_STATS_KEYS, make_wave_stats, record_wave_metrics

__all__ = [
    "HOST_STEP_SPANS",
    "MetricsRegistry",
    "NULL_SPAN",
    "TraceRecorder",
    "WAVE_STATS_KEYS",
    "make_wave_stats",
    "record_wave_metrics",
    "span_or_null",
]
