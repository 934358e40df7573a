"""Readers of the program's host-step spans inside the served device-wave
tick (``repro_torch.obs.trace.HOST_STEP_SPANS``), for the per-layer metric
files.  Each returns ``None`` when the run holds no such span, as a program
without them gives, and the metric is then left out of the result line."""
from __future__ import annotations


def program_spans(run, name: str) -> list[dict]:
    """The run's ``obs`` spans named ``name``."""
    return [e for e in run.spans if e.get("kind") == "span" and e.get("name") == name]


def span_ms(run, name: str) -> float | None:
    """Mean milliseconds of the ``name`` spans before the profiled stretch."""
    spans = [e["t1"] - e["t0"] for e in program_spans(run, name) if e["t1"] <= run.host_until]
    return 1e3 * sum(spans) / len(spans) if spans else None


def record_ms(run) -> float | None:
    """Mean milliseconds of a round's record extraction (``wave.records``:
    masks, ``nonzero``, the copies to the host, the split by query)."""
    return span_ms(run, "wave.records")


def plan_host_ms(run) -> float | None:
    """Mean milliseconds of a device plan round's host choice
    (``plan.choose``: unpacking, the ``auto`` costs, the exclusions' diff,
    and the ``plan.round`` event, which only a traced run computes)."""
    return span_ms(run, "plan.choose")


def d2h_bytes_per_record(run) -> float | None:
    """Bytes the record extraction copied to the host per record, over every
    ``wave.records`` span of the window (a count: the profiler cannot move it)."""
    spans = [e.get("attrs", {}) for e in program_spans(run, "wave.records")]
    records = sum(a.get("records", 0) for a in spans)
    return sum(a.get("d2h_bytes", 0) for a in spans) / records if records else None
