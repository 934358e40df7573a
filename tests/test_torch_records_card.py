"""The benchmark's sample cell, traced, on the card at a tiny size.

A round's records cross to the host in one packed copy
(``multi_query._wave_records``).  The traced run must still read the
device's trace (busy seconds within the profiled window), stay correct, and
count one copy a round of 16 + 4·s bytes a record: its (pair, row) int64
and its s float32 measures.  The device trace needs a card, so the
case carries the ``cuda`` marker and skips where there is none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_records_card.py
"""
import json
import time

import pytest
import torch

from bench import harness
from bench.tests.conftest import ROOT, TINY

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the traced run reads the card's device trace")
    return torch.device("cuda")


def test_a_traced_sample_cell_reads_the_device_and_one_packed_copy(cuda, monkeypatch):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    runs = []
    make_run = harness.Run
    monkeypatch.setattr(harness, "Run", lambda *a, **kw: runs.append(make_run(*a, **kw))
                        or runs[-1])
    res = harness.run_cell(bench, "synth-sample-closed", 2**31 + 11, 2.0, True, cuda,
                           time.monotonic(), TINY)
    assert res["correct"] and res["failed"] == 0
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    cfg = json.loads((ROOT / "bench/configs/synth-fig3.json").read_text())
    per_record = 16 + 4 * len(cfg["measures"])
    spans = [e["attrs"] for e in runs[0].spans
             if e.get("kind") == "span" and e["name"] == "wave.records"]
    assert spans and all(a["d2h_copies"] == 1 for a in spans)
    assert all(a["d2h_bytes"] == per_record * a["records"] for a in spans)
    metrics = res["metrics"]
    assert metrics["d2h_bytes_per_record.sample"]["value"] == per_record
    assert metrics["d2h_copies_per_round.sample"]["value"] == 1.0
