"""MB a round's union gather writes (``wave.read``'s ``gather_bytes``: the
union's dims, measures and valid rows, copied out of the block cache's pool),
in the sample mix: Σ ``gather_bytes`` ÷ the window's ``wave.read`` spans, in
10⁶ bytes.  ``None`` where no span carries the counter, as a program without
it gives."""
from bench.host_steps import program_spans


def read(run) -> float | None:
    spans = [e.get("attrs", {}) for e in program_spans(run, "wave.read")]
    if not any("gather_bytes" in a for a in spans):
        return None
    return sum(a.get("gather_bytes", 0) for a in spans) / len(spans) / 1e6
