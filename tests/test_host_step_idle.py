"""``tools/host_step_idle.py``: the card's idle gaps of a traced benchmark
run named by the port's host-step spans, at each gap's middle and split at
every span boundary, on made-up traces."""
import json
import sys
import types

import pytest

import bench
from bench import devtrace
from repro_torch.obs import HOST_STEP_SPANS
from tools import host_step_idle as tool

LABELS = HOST_STEP_SPANS + devtrace.LABELS
# busy [0, 1) and [4.8, 10): one gap (1, 4.8) inside a wave.execute whose
# records' copy and split take (2, 3) and (3, 4.5)
DEVICE = [("block_gather_kernel", 0.0, 1.0), ("Memcpy DtoH", 4.8, 10.0)]
HOST = [("wave.execute", 0.5, 5.0), ("records.copy", 2.0, 3.0), ("records.split", 3.0, 4.5)]


def test_host_step_spans_name_gaps_innermost_first():
    """Listed as labels in their own order, a step names a gap inside it
    rather than the step or harness range around it."""
    host = [("bench.plan_round", 0.9, 4.9), ("plan.device_round", 1.2, 4.8),
            ("plan.choose", 1.5, 4.7), ("tick.retire", 5.0, 6.0)]
    out = tool.idle_by_step(DEVICE, 0.0, 10.0, host, LABELS)
    assert out["idle_mid"] == pytest.approx({"plan.choose": 3.8})
    assert out["idle_split"] == pytest.approx({"bench.plan_round": 0.2, "plan.device_round": 0.4,
                                               "plan.choose": 3.2})


def test_a_gap_named_at_its_middle_and_split_at_span_boundaries():
    out = tool.idle_by_step(DEVICE, 0.0, 10.0, HOST, LABELS)
    assert out["idle_mid"] == pytest.approx({"records.copy": 3.8})
    assert out["idle_split"] == pytest.approx({"wave.execute": 1.3, "records.copy": 1.0,
                                               "records.split": 1.5})
    assert out["ms"] == pytest.approx({"records.copy": 1000.0, "records.split": 1500.0,
                                       "wave.execute": 4500.0})
    assert out["n"] == {"records.copy": 1, "records.split": 1, "wave.execute": 1}
    assert (out["window_s"], out["busy_s"]) == (10.0, pytest.approx(6.2))


@pytest.mark.parametrize("host", [HOST, HOST[:1], []], ids=["steps", "parent_only", "none"])
def test_named_idle_sums_to_devtrace_idle(host, monkeypatch):
    """Both namings share out the same idle seconds as ``devtrace.summarize``,
    and the midpoint naming is devtrace's own with the steps as labels."""
    monkeypatch.setattr(devtrace, "LABELS", LABELS)
    ref = devtrace.summarize(DEVICE, 0.0, 10.0, host)
    out = tool.idle_by_step(DEVICE, 0.0, 10.0, host, LABELS)
    assert out["idle_mid"] == pytest.approx(ref.idle_by_host)
    assert sum(out["idle_split"].values()) == pytest.approx(sum(ref.idle_by_host.values()))
    assert out["busy_s"] == pytest.approx(ref.busy_s)


def test_no_device_activity_gives_none():
    assert tool.idle_by_step([], 0.0, 10.0, HOST, LABELS) is None
    assert tool.idle_by_step(DEVICE, 20.0, 30.0, HOST, LABELS) is None


@pytest.mark.parametrize("rc", [0, 3])
def test_main_runs_the_traced_benchmark_and_prints_its_line(rc, monkeypatch, capsys):
    """``main`` runs ``bench/run.py``'s main with ``--trace 1``, reads the
    stretch ``devtrace.summarize`` is given, puts ``summarize`` back, and
    prints its line after the run's only when the run succeeded."""
    argv_seen = []

    def fake_main(argv):
        argv_seen.append(argv)
        devtrace.summarize(DEVICE, 0.0, 10.0, HOST)
        print(json.dumps({"result": 1}))
        return rc

    fake = types.SimpleNamespace(main=fake_main)
    monkeypatch.setitem(sys.modules, "bench.run", fake)
    monkeypatch.setattr(bench, "run", fake, raising=False)
    summarize = devtrace.summarize
    assert tool.main(["--workload", "cell", "--seed", "7", "--seconds", "2"]) == rc
    assert devtrace.summarize is summarize
    assert argv_seen == [["--workload", "cell", "--seed", "7", "--seconds", "2.0",
                          "--trace", "1"]]
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == {"result": 1}
    if rc:
        assert len(lines) == 1
    else:
        assert json.loads(lines[-1])["host_step_idle"]["idle_mid"] == \
            pytest.approx({"records.copy": 3.8})
