"""Device-to-host copies a round's record extraction makes (``wave.records``'
``d2h_copies``), in the sample mix: Σ ``d2h_copies`` ÷ the window's
``wave.records`` spans.  ``None`` where no span carries the counter, as a
program without it gives."""
from bench.host_steps import program_spans


def read(run) -> float | None:
    spans = [e.get("attrs", {}) for e in program_spans(run, "wave.records")]
    if not any("d2h_copies" in a for a in spans):
        return None
    return sum(a.get("d2h_copies", 0) for a in spans) / len(spans)
