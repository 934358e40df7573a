"""The trace and roofline arithmetic and the readers, on made-up runs."""
import types

import numpy as np
import pytest

from bench import devtrace, readers, roofline
from bench.harness import Cell, PlanCall, Rec, Run, end_to_end
from bench.traffic import Query


def _events():
    host = [("bench.tick", 0.0, 3.8), ("bench.plan_round", 0.4, 3.5), ("bench.submit", 3.9, 4.5),
            ("wave.execute", 6.5, 8.0), ("bench.tick", 6.0, 9.0)]
    dev = [("kernelA", 1.0, 2.0), ("kernelB", 1.5, 3.0), ("kernelA", 5.0, 6.0),
           ("kernelB", 10.5, 11.0)]  # the last one after the window
    return dev, host


def test_union_counts_overlap_once():
    total, merged = devtrace.union_length([(1, 2), (1.5, 3), (5, 6), (2.5, 2.7)])
    assert total == pytest.approx(3.0) and merged == [[1, 3], [5, 6]]


def test_summarize_busy_idle_and_gap_names():
    dev, host = _events()
    d = devtrace.summarize(dev, 0.0, 10.0, host)
    assert d.window_s == 10.0 and d.busy_s == pytest.approx(3.0)
    assert d.kernel_s == pytest.approx({"kernelA": 2.0, "kernelB": 1.5})
    assert d.kernel_n == {"kernelA": 2, "kernelB": 1}
    # gaps [0, 1) and [3, 5) and [6, 10): named at their middles
    assert d.idle_by_host == pytest.approx({"bench.plan_round": 1.0, "bench.submit": 2.0,
                                            "wave.execute": 4.0})
    b = d.breakdown()
    assert b["device_ops"][0] == ["kernelA", 2.0] and len(b["idle_gaps"]) == 3
    assert d.seconds_matching("nelB", "zzz") == pytest.approx(1.5)


def test_summarize_without_device_work():
    assert devtrace.summarize([("x", 11.0, 12.0)], 0.0, 10.0, []) is None
    assert devtrace.summarize([], 0.0, 10.0, [("bench.tick", 0.0, 1.0)]) is None


def test_anchors_map_the_device_clock_onto_the_hosts():
    # the device's clock runs from 1e9 ns at the first anchor, a hair fast
    raw = [("at::cuda::spin_kernel(long)", 1_000_000_000, 500), ("k", 1_000_100_000, 2_000),
           ("k", 999_000_000, 10), ("memcpy", 1_500_000_000, 1_000_000),
           ("at::cuda::spin_kernel(long)", 2_000_000_100, 500), ("k", 2_100_000_000, 1)]
    out = devtrace.to_host_clock(raw, 5.0, 6.0)
    scale = 1.0 / 1_000_000_100
    assert [n for n, _, _ in out] == ["k", "memcpy"]  # the anchors and what lies outside go
    assert out[0][1] == pytest.approx(5.0 + 100_000 * scale)
    assert out[1][2] - out[1][1] == pytest.approx(1_000_000 * scale)
    assert devtrace.to_host_clock(raw[1:4], 5.0, 6.0) is None  # no anchors: no mapping


def test_roofline_counts_from_shapes():
    assert roofline.prefix_sum(64, 1000) == (2 * 64 * 1000 * 4, 64 * 1000)
    nbytes, ops = roofline.density_combine_wave([1, 3], 1000)
    assert nbytes == 4 * 1000 * 4 + 4 * 4 + 2 * 1000 * 4 and ops == 2 * 1000
    t = roofline.plan_round(64, 1000, [])
    assert t == pytest.approx(2 * 2 * 64e3 * 4 / roofline.HBM_BYTES_PER_S
                              + (64e3 * 4 + 64 * 8 + 64 * 12) / roofline.HBM_BYTES_PER_S)
    assert roofline.plan_round(64, 1000, [2]) > t
    assert roofline.block_gather(10, 1000) == pytest.approx(2e4 / roofline.HBM_BYTES_PER_S)


def _run(device=None, calls=(), spans=(), recs=()):
    cell = Cell("c", {"records_per_block": 100}, {"loop": "open"}, {}, [], [])
    return Run(cell, 1.0, list(recs), {"served": 4, "total_wait_s": 0.2}, list(calls),
               list(spans), device, 1000, 5.0)


def test_readers():
    d = devtrace.DeviceTrace(2.0, 0.5, {"prefix_sum_rows_kernel": 0.01,
                                        "block_gather_kernel<uint4>": 0.02}, {}, {})
    calls = [PlanCall(0.004, 1, 64, 1000, [2], 10), PlanCall(0.006, 0, 64, 1000, [], 5),
             PlanCall(0.008, 0, 64, 1000, [], 5), PlanCall(0.1, 2, 64, 1000, [], 5)]
    spans = [{"kind": "span", "name": "wave.execute", "t0": 1.0, "t1": 1.003},
             {"kind": "span", "name": "wave.execute", "t0": 6.0, "t1": 6.5}]
    run = _run(d, calls, spans)
    assert readers.device_idle_pct(run) == pytest.approx(75.0)
    assert readers.plan_ms(run) == pytest.approx(7.0)  # before the profiler only
    assert readers.fetch_ms(run) == pytest.approx(3.0)
    assert readers.plan_kernels_roofline(run) == pytest.approx(
        100 * roofline.plan_round(64, 1000, [2]) / 0.01)
    assert readers.block_gather_roofline(run) == pytest.approx(
        100 * roofline.block_gather(10, 1000) / 0.02)
    res = types.SimpleNamespace(num_records=50, blocks_fetched=np.arange(3))
    rec = Rec(Query(((0, 1),), 5, "and"), 0.0, completions=1, req=types.SimpleNamespace(result=res))
    assert readers.rows_read_per_record(_run(recs=[rec])) == pytest.approx(6.0)
    nothing = _run()
    assert all(f(nothing) is None for f in (readers.device_idle_pct, readers.plan_ms,
                                            readers.fetch_ms, readers.plan_kernels_roofline,
                                            readers.block_gather_roofline,
                                            readers.rows_read_per_record))


def test_end_to_end_tails_count_lost_requests():
    cell = Cell("c", {}, {"loop": "open"}, {},
                [{"name": n} for n in ("setup_s", "query_p50_ms", "query_p95_ms")], [])
    recs = [Rec(None, float(i), done=float(i) + 0.01 * (i + 1), completions=1) for i in range(19)]
    out = end_to_end(cell, recs + [Rec(None, 0.0)], 1.0, 3.0)
    assert out["setup_s"]["value"] == 3.0
    assert out["query_p50_ms"]["value"] == pytest.approx(np.percentile(
        [10.0 * (i + 1) for i in range(19)] + [np.inf], 50))
    assert out["query_p95_ms"]["value"] == float("inf")
    closed = Cell("c", {}, {"loop": "closed"}, {}, [{"name": "queries_per_s"}], [])
    recs = [Rec(None, 0.0, done=t, completions=1) for t in (0.5, 1.5, 2.0, 2.5)]
    assert end_to_end(closed, recs, 2.0, 1.0) == {"queries_per_s": {"value": 1.5,
                                                                    "unit": "queries/s"}}
