"""TraceRecorder: nestable spans and point events for a request's lifecycle.

Counterpart of ``repro/obs/trace.py``.  One recorder is threaded through
the serving stack (serving loop → admission → engine → wave loops → tier
stack → prefetcher) and emits one structured stream: queue wait →
admission decision (launch reason) → per-round plan (site, THRESHOLD or
TWO-PRONG, predicted against observed I/O) → fetch outcomes → device
transfer → completion.  ``tools/trace_report.py`` rebuilds per-request
critical paths from the exported JSONL.

Contract:

* **Injectable clock** — ``clock()`` is read twice per span (enter, exit)
  and once per event.  It is the host's clock: no hook synchronises the
  card, so a span around device work measures what the host waits for.
* **Deterministic ids** — span and event ids come from one counter, so
  identical runs give identical streams up to the timestamps.
* **Ring buffer** — ``max_events`` bounds the buffer; overflow evicts the
  oldest events and counts them in ``dropped``.
* **Disabled is free** — with ``enabled=False``, :meth:`TraceRecorder.span`
  returns the shared :data:`NULL_SPAN` and :meth:`TraceRecorder.event`
  returns before the clock: zero clock reads, zero buffered events.
  Tracing observes and never steers: results are identical on and off.
* **One thread** — the recorder lives on the serving thread; the
  prefetcher's side-stream reads are traced when they are drained.

A span opened inside another records it as its parent, so one serving tick
is a tree (``serve.exemplar_tick`` → ``plan.round`` / ``wave.execute`` →
fetch events).  The port adds :data:`HOST_STEP_SPANS` inside the device
wave's tick; the reference has none of them.
"""
from __future__ import annotations

import itertools
import json
import time
from collections import deque

from repro_torch.obs.metrics import MetricsRegistry


# Spans only the port records: they tile the served device-wave tick into the
# host steps around the card (claim, the plan round's join / device / choice,
# the union read, the record chunks' select and copy, the split, the
# bookkeeping, the retire), so an idle gap of the card is named by the host
# step it waited on.  The reference plans and gathers inside XLA and has no
# such steps; a comparison of the two streams drops these names.  Listed
# innermost first, so a reader that names a moment by the first span over it
# finds the innermost.
HOST_STEP_SPANS = (
    "records.select", "records.copy", "records.split",
    "wave.read", "wave.records", "wave.bookkeep",
    "plan.join", "plan.device", "plan.choose", "plan.device_round",
    "tick.claim", "tick.retire",
)


class _NullSpan:
    """The shared no-op span: one instance, no state, no clock."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


def span_or_null(obs, name: str):
    """``obs.span(name)``, or :data:`NULL_SPAN` when ``obs`` is ``None``: a
    traced site's one line, one attribute test when untraced."""
    return NULL_SPAN if obs is None else obs.span(name)


class _Span:
    """A live span: times itself on enter and exit and emits one record."""

    __slots__ = ("rec", "name", "attrs", "sid", "parent", "t0")

    def __init__(self, rec: "TraceRecorder", name: str, attrs: dict):
        self.rec = rec
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        rec = self.rec
        self.sid = next(rec._ids)
        self.parent = rec._stack[-1] if rec._stack else 0
        rec._stack.append(self.sid)
        self.t0 = rec.clock()
        return self

    def set(self, **attrs) -> "_Span":
        """Attach attributes learnt inside the span (e.g. a round's blocks)."""
        self.attrs.update(attrs)
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        t1 = rec.clock()
        rec._stack.pop()
        e = {"kind": "span", "name": self.name, "id": self.sid,
             "parent": self.parent, "t0": self.t0, "t1": t1}
        if self.attrs:
            e["attrs"] = self.attrs
        rec._emit(e)
        return False


class TraceRecorder:
    """A bounded structured trace and its :class:`MetricsRegistry`
    (``rec.metrics``): the one ``obs`` object every subsystem accepts."""

    def __init__(self, clock=time.perf_counter, max_events: int = 65536,
                 metrics: MetricsRegistry | None = None, enabled: bool = True):
        if max_events < 1:
            raise ValueError("max_events must be >= 1")
        self.clock = clock
        self.enabled = bool(enabled)
        self.events: deque = deque(maxlen=int(max_events))
        self.dropped = 0
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._ids = itertools.count(1)
        self._stack: list[int] = []

    # ------------------------------------------------------------------ emit
    def _emit(self, e: dict) -> None:
        ev = self.events
        if len(ev) == ev.maxlen:
            self.dropped += 1
        ev.append(e)

    def span(self, name: str, **attrs):
        """Context manager timing a nested span; a disabled recorder returns
        the shared :data:`NULL_SPAN` (no allocation, no clock read)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """One point-in-time record, parented under the active span."""
        if not self.enabled:
            return
        t = self.clock()
        e = {"kind": "event", "name": name, "id": next(self._ids),
             "parent": self._stack[-1] if self._stack else 0, "t": t}
        if attrs:
            e["attrs"] = attrs
        self._emit(e)

    # ---------------------------------------------------------------- export
    def to_events(self) -> list[dict]:
        """The buffered events, oldest first (a copy)."""
        return list(self.events)

    def export_jsonl(self, path: str) -> str:
        """Write the buffer as JSONL, one event a line with sorted keys
        (identical runs give identical bytes up to the timestamps)."""
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e, sort_keys=True) + "\n")
        return str(path)
