"""The readers of the program's host-step spans, on made-up runs and on a
traced run of the sample cell on the CPU; the clock the program's spans and
the harness's anchors share."""
import time

import pytest

from bench import devtrace, harness, host_steps, readers
from bench.harness import PlanCall
from bench.tests.conftest import TINY
from bench.tests.test_bench_devtrace import _events, _run
from repro_torch.obs import HOST_STEP_SPANS, TraceRecorder


def _span(name, t0, t1, **attrs):
    return {"kind": "span", "name": name, "t0": t0, "t1": t1, "attrs": attrs}


def _host_step_spans():
    """Two rounds' ``plan.choose`` and ``wave.records`` (with its copy
    counts, and a ``records.copy`` inside), the second after the profiler's
    start (5.0)."""
    return [_span("plan.choose", 1.0, 1.002),
            _span("wave.records", 1.01, 1.05, records=10, d2h_bytes=240),
            _span("records.copy", 1.02, 1.03),
            _span("plan.choose", 6.0, 6.1),
            _span("wave.records", 6.2, 6.5, records=30, d2h_bytes=720)]


def test_host_step_readers():
    run = _run(spans=_host_step_spans())
    assert host_steps.record_ms(run) == pytest.approx(40.0)  # before the profiler only
    assert host_steps.plan_host_ms(run) == pytest.approx(2.0)
    assert host_steps.d2h_bytes_per_record(run) == pytest.approx(24.0)  # every round


@pytest.mark.parametrize("spans", [[], [_span("wave.execute", 1.0, 1.1)],
                                   [_span("wave.records", 1.0, 1.1, records=0, d2h_bytes=0)]],
                         ids=["none", "a_parent_without_host_steps", "no_records"])
def test_host_step_readers_find_nothing(spans):
    run = _run(spans=spans)
    assert host_steps.d2h_bytes_per_record(run) is None
    if not any(e["name"] == "wave.records" for e in spans):
        assert host_steps.record_ms(run) is None and host_steps.plan_host_ms(run) is None


@pytest.mark.parametrize("reader", [readers.device_idle_pct, readers.plan_ms, readers.fetch_ms,
                                    readers.plan_kernels_roofline,
                                    readers.block_gather_roofline])
def test_existing_readers_ignore_the_host_step_spans(reader):
    d = devtrace.DeviceTrace(2.0, 0.5, {"prefix_sum_rows_kernel": 0.01,
                                        "block_gather_kernel<uint4>": 0.02}, {}, {})
    calls = [PlanCall(0.004, 1, 64, 1000, [2], 10), PlanCall(0.006, 0, 64, 1000, [], 5)]
    spans = [_span("wave.execute", 1.0, 1.06)]
    assert reader(_run(d, calls, spans + _host_step_spans())) == reader(_run(d, calls, spans))


def test_labels_move_no_total(monkeypatch):
    """With the host-step names listed as gap labels ahead of the others, a
    ``records.copy`` inside ``wave.execute`` names the gap at its middle,
    and the busy time, the window and the idle total stay as they are."""
    dev, host = _events()
    plain = devtrace.summarize(dev, 0.0, 10.0, host)
    monkeypatch.setattr(devtrace, "LABELS", HOST_STEP_SPANS + devtrace.LABELS)
    named = devtrace.summarize(dev, 0.0, 10.0, host + [("records.copy", 7.0, 8.0)])
    assert named.idle_by_host == pytest.approx({"bench.plan_round": 1.0, "bench.submit": 2.0,
                                                "records.copy": 4.0})
    assert (named.busy_s, named.window_s) == (plain.busy_s, plain.window_s)
    assert sum(named.idle_by_host.values()) == pytest.approx(sum(plain.idle_by_host.values()))


def test_the_program_and_the_anchors_share_one_clock(monkeypatch):
    """The program's spans and the anchors that map the device's clock onto
    the host's both read ``time.perf_counter``: an idle gap is named by
    comparing the two."""
    assert TraceRecorder().clock is time.perf_counter
    monkeypatch.setattr(time, "perf_counter", lambda: 1234.5)
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    assert harness._anchor() == 1234.5


def test_a_traced_sample_run_reads_the_host_steps(bench):
    res = harness.run_cell(bench, "synth-sample-closed", 2**31 + 11, 0.5, True, "cpu",
                           time.monotonic(), TINY, cell_params={"rate_per_s": 200})
    assert res["correct"]
    m = res["metrics"]
    assert m["record_ms.sample"]["value"] > 0 and m["plan_host_ms.sample"]["value"] > 0
    # 16 B of (pair, row) int64 and two float32 measures a record
    assert m["d2h_bytes_per_record.sample"] == {"value": 24.0, "unit": "B/record"}
