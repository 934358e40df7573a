"""Shared set-up of the benchmark's tests: tiny configurations on the CPU."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny tables: 48 blocks of 256 rows (the last one padded); runs of 2 blocks
TINY = {"num_records": 256 * 48 - 100, "records_per_block": 256,
        "layout_params": {"num_dims": 8, "num_measures": 2, "density": 0.1, "mean_run": 512}}


@pytest.fixture(scope="session")
def bench() -> dict:
    """``BENCHMARK.json`` with an open-loop cell added (``open_cell.json``):
    the benchmark has none yet, and the tests drive its loop and readers."""
    out = json.loads((ROOT / "BENCHMARK.json").read_text())
    extra = json.loads((Path(__file__).parent / "open_cell.json").read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        out[key] = out[key] + extra[key]
    return out


@pytest.fixture
def card():
    """Skips a card-only test where there is no CUDA card (decided here, not
    at import, so every worker collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
