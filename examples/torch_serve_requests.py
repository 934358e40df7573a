"""Serve exemplar, aggregate and LM requests through one continuous loop.

  PYTHONPATH=src python examples/torch_serve_requests.py             # on the card
  PYTHONPATH=src python examples/torch_serve_requests.py --device cpu

A clustered 200,000-record table in blocks of 1,024 records and a reduced
qwen1.5-4b with random weights, both on ``--device``.  Twelve exemplar
lookups (any-k, k 50-400), four online aggregates (each answered when its
95% CI half-width closes under its error SLO) and six LM prompts go into one
``ServeEngine`` and run through ``run_continuous``: every tick decodes one
token, runs one refill round of the exemplar slots on the device wave and
one fold round of the aggregate slots, each pool refilling freed slots from
its admission queue.  Every exemplar's rows are checked against a solo
``any_k``; the trace's per-request critical paths are printed by
``tools/trace_report.py``.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.data.block_store import build_block_store
from repro_torch.data.synthetic import make_clustered_table
from repro_torch.models import init_params
from repro_torch.obs import TraceRecorder
from repro_torch.serving import AdmissionPolicy, ServeEngine

REPO = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--records", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    table = make_clustered_table(num_records=args.records, num_dims=4, density=0.15,
                                 seed=args.seed, correlated_measure=True)
    store = build_block_store(table, 1024, device=args.device)
    anyk = NeedleTailEngine(store, device=args.device)
    cfg = reduced(get_config("qwen1.5-4b"))
    model = init_params(cfg, args.seed, device=args.device)
    rec = TraceRecorder()
    srv = ServeEngine(cfg, model, max_slots=4, max_seq=64, device=args.device,
                      exemplar_device=True, exemplar_policy=AdmissionPolicy(slo_s=0.05, max_wave=4),
                      obs=rec)
    rng = np.random.default_rng(args.seed)
    ex = [srv.submit_exemplar_request([(int(rng.integers(0, 4)), 1)], int(rng.integers(50, 400)))
          for _ in range(12)]
    agg = [srv.submit_aggregate_request([(a, 1)], 0, 500, error_slo=1.0, seed=a)
           for a in range(4)]
    lm = [srv.submit(rng.integers(0, cfg.vocab, int(rng.integers(4, 12))), max_new_tokens=8)
          for _ in range(6)]
    t0 = time.perf_counter()
    out = srv.run_continuous(anyk)
    wall = time.perf_counter() - t0
    solo = NeedleTailEngine(store, device=args.device)
    for r in ex:
        s = solo.any_k(r.predicates, r.k)
        assert np.array_equal(r.result.record_block, s.record_block) and \
            np.array_equal(r.result.record_row, s.record_row), r.rid
    print(f"[serve] continuous on {srv.device}: {len(out['exemplar'])} exemplar, "
          f"{len(out['aggregate'])} aggregate, {len(out['lm'])} LM requests in {wall:.2f} s; "
          f"exemplar rows == solo any_k")
    for r in agg:
        print(f"  aggregate rid={r.rid} mean={r.result.mean:.4f} ±{r.result.ci_halfwidth():.4f} "
              f"({r.reason} after {r.rounds} rounds)")
    for r in lm[:2]:
        print(f"  lm rid={r.rid} prompt_len={len(r.prompt)} out={r.out_tokens}")
    with tempfile.TemporaryDirectory() as tmp:
        path = rec.export_jsonl(str(pathlib.Path(tmp) / "trace.jsonl"))
        report = subprocess.run([sys.executable, str(REPO / "tools" / "trace_report.py"), path,
                                 "--requests", "6"], check=True, capture_output=True, text=True)
    print(report.stdout)
    return out


if __name__ == "__main__":
    main()
