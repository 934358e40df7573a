"""What the per-layer metric files (``metrics/<name>.py``) read from a
:class:`bench.harness.Run`.  Each returns ``None`` when the run holds nothing
to read, and the metric is then left out of the result line."""
from __future__ import annotations

from bench import roofline


def plan_ms(run) -> float | None:
    """Mean host milliseconds of ``DeviceWave.plan_round`` before the profiled
    stretch; the round ends in its one device-to-host copy, so the host's
    clock sees the device work too."""
    calls = [c for c in run.plan_calls if c.phase == 0]
    return 1e3 * sum(c.seconds for c in calls) / len(calls) if calls else None


def fetch_ms(run) -> float | None:
    """Mean milliseconds of the ``wave.execute`` spans (union fetch, masks,
    ``nonzero`` and the records' copy to the host) before the profiled
    stretch."""
    spans = [e["t1"] - e["t0"] for e in run.spans
             if e.get("kind") == "span" and e.get("name") == "wave.execute"
             and e["t1"] <= run.host_until]
    return 1e3 * sum(spans) / len(spans) if spans else None


def rows_read_per_record(run) -> float | None:
    """Rows of the blocks read per record returned, over the answered
    requests of the window."""
    rpb = int(run.cell.cfg["records_per_block"])
    done = [r.req.result for r in run.recs if r.completions == 1]
    records = sum(res.num_records for res in done)
    return sum(res.blocks_fetched.size for res in done) * rpb / records if records else None


def device_idle_pct(run) -> float | None:
    """The share of the profiled stretch in which no kernel, copy or set ran."""
    d = run.device
    return 100.0 * (1.0 - d.busy_s / d.window_s) if d is not None and d.window_s > 0 else None


def roofline_pct(least_s: float, device_s: float) -> float | None:
    return 100.0 * least_s / device_s if least_s > 0 and device_s > 0 else None


def plan_kernels_roofline(run) -> float | None:
    """#2, #5 and #6 in the profiled stretch: least time from their shapes
    over their device time."""
    if run.device is None:
        return None
    least = sum(roofline.plan_round(c.rows, c.lam, c.joiner_gammas)
                for c in run.plan_calls if c.phase == 1)
    dev = run.device.seconds_matching("density_combine_wave", "theta_batch", "prefix_sum")
    return roofline_pct(least, dev)


def block_gather_roofline(run) -> float | None:
    """#7 in the profiled stretch: each round's union gathered from the block
    cache's pool, three slabs a block."""
    if run.device is None:
        return None
    least = sum(roofline.block_gather(c.union_blocks, run.block_bytes)
                for c in run.plan_calls if c.phase == 1)
    return roofline_pct(least, run.device.seconds_matching("block_gather"))
