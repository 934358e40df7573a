"""Reading a ``torch.profiler`` trace of part of the window.

The profiler records device activity only (kernels, copies, sets): with no
host-side events it leaves the host's speed nearly as it is.  The harness
keeps its own host ranges on ``time.perf_counter`` and brackets the traced
stretch with two anchor kernels, each launched right after a synchronise at
a host time it notes; the anchors map the device's clock onto the host's.
Device activity between them is merged into a union of intervals, so
overlapping work is counted once (``busy_s``); the device is idle outside
that union.  Each idle gap is named by what the host was doing at its
middle: the innermost of the host ranges there.
"""
from __future__ import annotations

import bisect
import dataclasses
import sys

ANCHOR = "spin_kernel"  # the kernel of ``torch.cuda._sleep``, which nothing else launches
# innermost first: a gap inside a plan round is named by the plan round
LABELS = ("bench.plan_round", "wave.execute", "bench.tick", "bench.submit", "bench.sleep")


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernel_s: dict  # device seconds by op name, within the window
    kernel_n: dict  # launches by op name, within the window
    idle_by_host: dict  # idle seconds by what the host was doing

    def seconds_matching(self, *parts: str) -> float:
        """Device seconds of the ops whose name holds any of ``parts``."""
        return sum(s for name, s in self.kernel_s.items() if any(p in name for p in parts))

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:120], v] for k, v in top],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


def union_length(intervals: list[tuple[float, float]]) -> tuple[float, list]:
    """Total length of the union of ``(start, end)`` intervals, and the
    merged intervals in order."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _outermost(intervals: list[tuple[float, float, str]]) -> list[tuple[float, float, str]]:
    """The intervals not nested in an earlier one, in order (disjoint)."""
    out: list[tuple[float, float, str]] = []
    for s, e, name in sorted(intervals):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def _find(disjoint: list[tuple[float, float, str]], starts: list[float], t: float) -> str | None:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and disjoint[i][1] >= t:
        return disjoint[i][2]
    return None


def summarize(device: list[tuple[str, float, float]], w0: float, w1: float,
              host: list[tuple[str, float, float]]) -> DeviceTrace | None:
    """``device``: ``(name, start_s, end_s)`` on the host's clock; the window
    ``[w0, w1)``; ``host``: the host's ``(name, start_s, end_s)`` ranges.
    Returns ``None`` when the window holds no device activity."""
    dev = [(max(s, w0), min(e, w1), name) for name, s, e in device if e > w0 and s < w1]
    if not dev or w1 <= w0:
        return None
    busy, merged = union_length([(s, e) for s, e, _ in dev])
    kernel_s: dict = {}
    kernel_n: dict = {}
    for s, e, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s)
        kernel_n[name] = kernel_n.get(name, 0) + 1
    labels = {lab: _outermost([(s, e, n) for n, s, e in host if n == lab and e > w0 and s < w1])
              for lab in LABELS}
    label_starts = {lab: [x[0] for x in v] for lab, v in labels.items()}
    idle: dict = {}
    edges = [w0] + [v for iv in merged for v in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        lab = next((lab for lab in LABELS if _find(labels[lab], label_starts[lab], mid)), "host")
        idle[lab] = idle.get(lab, 0.0) + (g1 - g0)
    return DeviceTrace(window_s=w1 - w0, busy_s=busy, kernel_s=kernel_s, kernel_n=kernel_n,
                       idle_by_host=idle)


def to_host_clock(device: list[tuple[str, int, int]], h0: float, h1: float
                  ) -> list[tuple[str, float, float]] | None:
    """Device events ``(name, start_ns, duration_ns)`` between the first and
    the last anchor, mapped onto the host's clock by the anchors' starts
    (launched at host times ``h0`` and ``h1``); ``None`` without two anchors."""
    anchors = sorted(s for name, s, _ in device if ANCHOR in name)
    if len(anchors) < 2 or anchors[-1] <= anchors[0]:
        return None
    d0, d1 = anchors[0], anchors[-1]
    scale = (h1 - h0) / (d1 - d0)
    return [(name, h0 + (s - d0) * scale, h0 + (s + d - d0) * scale)
            for name, s, d in device if ANCHOR not in name and d0 < s < d1]


def from_profiler(prof, h0: float, h1: float, host: list[tuple[str, float, float]]
                  ) -> DeviceTrace | None:
    """:func:`summarize` over a finished ``torch.profiler.profile`` whose
    stretch the anchors launched at host times ``h0`` and ``h1`` bracket."""
    from torch.autograd import DeviceType

    raw = [(ev.name(), ev.start_ns(), ev.duration_ns())
           for ev in prof.profiler.kineto_results.events() if ev.device_type() == DeviceType.CUDA]
    device = to_host_clock(raw, h0, h1)
    if not device:
        names = sorted({name for name, _, _ in raw})[:8]
        print(f"trace: no two anchors among {len(raw)} device events ({names})", file=sys.stderr)
        return None
    return summarize(device, h0, h1, host)
