#!/usr/bin/env python3
"""The card's idle seconds named by the port's host-step spans, from one
traced run of the benchmark.

    python3 tools/host_step_idle.py --workload synth-sample-closed --seed <n> --seconds 20

Runs ``bench/run.py`` with ``--trace 1`` in this process and reads its
profiled stretch once more, over the host ranges the harness already holds
(its own, and every span of the program's ``TraceRecorder``), with
``repro_torch.obs.HOST_STEP_SPANS`` (innermost first) listed ahead of
``bench/devtrace.py``'s ``LABELS``:

* ``idle_mid``: each idle gap named whole by the innermost range at its
  middle, as ``bench/devtrace.py`` names it;
* ``idle_split``: each gap cut at every boundary of those ranges, each piece
  named by the innermost range at its middle, so a gap that runs from one
  host step through the next few is shared among them;
* ``ms`` and ``n``: the mean milliseconds and the count of each listed range
  that lies inside the stretch.

The benchmark's result line is printed as it is; this tool's JSON object,
``{"host_step_idle": ...}``, follows it as the last line of standard output.
"""
from __future__ import annotations

import bisect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def idle_by_step(device: list[tuple[str, float, float]], w0: float, w1: float,
                 host: list[tuple[str, float, float]], labels: tuple[str, ...]) -> dict | None:
    """The stretch ``[w0, w1)``'s idle seconds by label (innermost first),
    named at each gap's middle (``idle_mid``) and split at every label
    range's boundary (``idle_split``), with the labels' mean ms (``ms``) and
    counts (``n``); ``device`` and ``host`` as ``bench.devtrace.summarize``
    takes them.  ``None`` when the stretch holds no device activity."""
    from bench import devtrace

    dev = [(max(s, w0), min(e, w1)) for _, s, e in device if e > w0 and s < w1]
    if not dev or w1 <= w0:
        return None
    busy, merged = devtrace.union_length(dev)
    ranges = {lab: devtrace._outermost([(s, e, n) for n, s, e in host
                                        if n == lab and e > w0 and s < w1])
              for lab in labels}
    starts = {lab: [r[0] for r in v] for lab, v in ranges.items()}
    cuts = sorted({t for v in ranges.values() for s, e, _ in v for t in (s, e)})

    def name(t: float) -> str:
        return next((lab for lab in labels if devtrace._find(ranges[lab], starts[lab], t)),
                    "host")

    mid: dict = {}
    split: dict = {}
    edges = [w0] + [v for iv in merged for v in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        lab = name(0.5 * (g0 + g1))
        mid[lab] = mid.get(lab, 0.0) + (g1 - g0)
        pts = [g0] + cuts[bisect.bisect_right(cuts, g0):bisect.bisect_left(cuts, g1)] + [g1]
        for a, b in zip(pts[:-1], pts[1:]):
            lab = name(0.5 * (a + b))
            split[lab] = split.get(lab, 0.0) + (b - a)
    inside = {lab: [e - s for n, s, e in host if n == lab and s >= w0 and e <= w1]
              for lab in labels}
    return {"window_s": w1 - w0, "busy_s": busy, "idle_mid": mid, "idle_split": split,
            "ms": {lab: 1e3 * sum(v) / len(v) for lab, v in inside.items() if v},
            "n": {lab: len(v) for lab, v in inside.items() if v}}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench import devtrace, run  # run first: it sets the build caches before torch loads

    sys.path.insert(1, os.path.join(ROOT, "src"))
    from repro_torch.obs.trace import HOST_STEP_SPANS

    labels = HOST_STEP_SPANS + devtrace.LABELS
    summarize = devtrace.summarize
    found: list = []

    def summarize_and_split(device, w0, w1, host):
        found.append(idle_by_step(device, w0, w1, host, labels))
        return summarize(device, w0, w1, host)

    devtrace.summarize = summarize_and_split
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        devtrace.summarize = summarize
    if rc == 0:
        print(json.dumps({"host_step_idle": found[-1] if found else None}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
