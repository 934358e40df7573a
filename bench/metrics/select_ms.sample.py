"""Ms a round's masks take (the ``records.select`` spans inside ``wave.records``:
the pairs' uploads, the predicate masks, ``nonzero``), in the sample mix: Σ
``records.select`` ms ÷ the ``wave.records`` spans, both before the profiled
stretch.  ``None`` where the run holds no ``records.select`` span."""
from bench.host_steps import program_spans


def read(run) -> float | None:
    def before(name):
        return [e for e in program_spans(run, name) if e["t1"] <= run.host_until]

    select, rounds = before("records.select"), before("wave.records")
    if not select or not rounds:
        return None
    return 1e3 * sum(e["t1"] - e["t0"] for e in select) / len(rounds)
