"""The control of the comparison that decides ``correct``: the plain reference
put in the program's place and computed in bfloat16, the step below the
float32 the configurations state (the index stored, the ⊕-combine folded and
the prefix sums kept in bfloat16), judged by the float32 reference exactly as
a run judges the program.  It has to come out as not
correct; its smallest ``plans_off`` over the seeds is the upper reading the
limit is set below.

    python bench/control.py --workload synth-sample-closed --seeds 11,12,13

Runs at the cell's own size (the table of ``--seed``, the first
``check_sample`` queries of the window's stream) on the card, where the
table is generated; the program is not run.  Prints one JSON line a seed.
"""
from __future__ import annotations

import json
import os
import sys


def control(cfg: dict, mix: dict, seed: int, device, n: int | None = None) -> dict:
    import torch

    from bench import harness, traffic
    from bench.check import plan_verdicts
    from bench.reference import anyk

    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    layout = harness.load_module("layouts", cfg["layout"])
    dims, _ = layout.generate(int(cfg["num_records"]), gen, device, **cfg["layout_params"])
    rpb = int(cfg["records_per_block"])
    stream = traffic.QueryStream(cfg, mix, seed, traffic.STREAM_WINDOW,
                                 harness.match_counter(dims))
    queries = stream.take(n or int(mix["check_sample"]))
    cost = anyk.COST_MODELS[cfg["cost_model"]]
    out = {"seed": seed, "queries": len(queries)}
    ref = anyk.density_index(dims, cfg["cards"], rpb)
    # float32 in the program's place is the reference judged by itself: it must pass
    for name, bf16 in (("float32", False), ("bfloat16", True)):
        dens = anyk.density_index(dims, cfg["cards"], rpb,
                                  round_to=torch.bfloat16 if bf16 else None)
        results = []
        for q in queries:
            comb = anyk.combine(dens, anyk.row_ids(cfg["cards"], q.predicates), q.op, bf16)
            matches = anyk.block_matches(dims, q.predicates, q.op, rpb)
            results.append(anyk.run_exact(comb, q.k, matches, rpb, int(cfg["max_refills"]),
                                          cost, bf16))
        v = plan_verdicts(cfg, dims, ref, queries, results)
        out[name] = {"plans_off": v["off"], "plan_ties": v["tie"], "capped": v["capped"]}
    return out


def main() -> int:
    import argparse

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    from bench import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("the control runs at the cell's size on a CUDA card", file=sys.stderr)
        return 3
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cell = harness.load_cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control(cell.cfg, cell.mix, seed, torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
