"""Find a browse cell's knee: the highest offered rate whose backlog does not
grow over a window.  One set-up, then each rate's open loop in turn:

    python bench/sweep.py --workload synth-browse-open --seed 7 --seconds 6 \\
        --rates 300,450,600,750

For each rate it prints the queries due, the backlog (due but not answered)
at the window's half and at its end, and the latency quantiles.  The rate a
cell offers is fixed once from such a sweep, in ``cells/<workload>.json``.
"""
import json
import os
import sys
import time

T_START = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)


def backlog(recs, t: float) -> int:
    return sum(1 for r in recs if r.due <= t and not (r.completions and r.done <= t))


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import numpy as np
    import torch

    from bench import harness, traffic
    from repro_torch.serving.engine import ServeEngine

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = harness.load_cell(bench, args.workload)
    if cell.mix["loop"] != "open":
        raise SystemExit("a knee is swept for an open loop")
    dev = torch.device("cuda")
    setup = harness.build(cell.cfg, args.seed, dev)
    slots = int(cell.cfg["slots"])
    serve = ServeEngine(None, None, max_slots=slots, exemplar_device=True, device=dev)
    off = harness.Tracer(False, args.seconds)
    count = harness.match_counter(setup.dims)
    warm = traffic.QueryStream(cell.cfg, cell.mix, args.seed, traffic.STREAM_WARMUP, count)
    harness.closed_loop(serve, setup.engine, warm, slots, None, off,
                        max_ticks=int(cell.mix["warmup_ticks"]))
    print(f"setup {time.monotonic() - T_START:.3f} s on {torch.cuda.get_device_name(dev)}",
          flush=True)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        stream = traffic.QueryStream(cell.cfg, cell.mix, args.seed + i, traffic.STREAM_WINDOW,
                                     count)
        due = traffic.poisson_arrivals(rate, args.seconds, args.seed + i,
                                       int(cell.mix["pool"]))
        recs = harness.open_loop(serve, setup.engine, stream.take(due.size), due, args.seconds,
                                 off)
        lat = np.asarray([r.done - r.due if r.completions else np.inf for r in recs])
        print(json.dumps({
            "rate_per_s": rate, "due": len(recs),
            "backlog_half": backlog(recs, args.seconds / 2),
            "backlog_end": backlog(recs, args.seconds),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "answered_s": float(max(r.done for r in recs if r.completions)),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
