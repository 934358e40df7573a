"""Serving launcher: wave-batched decode over a model with random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --no-reduced \\
      --requests 8 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --no-reduced

(f32 weights on the card: ~23 GB for zamba2-7b, ~50.5 GB for gemma3-12b.)

Counterpart of ``repro/launch/serve.py``.  The model runs on ``--device``
(``cuda`` by default; ``cpu`` only when asked), initialised in f32 from
``--seed`` with the reference's distributions.  ``--reduced`` is on by
default as in the reference, whose ``store_true`` flag with ``default=True``
can never be turned off; here ``--no-reduced`` serves the full-width
configuration.  ``--continuous`` swaps the wave drain for the continuous
slot loop (``ServeEngine.run_continuous``): a finished request frees its
slot at once and a queued prompt that fits the position counter joins
mid-wave, its cache rows grafted into the live cache.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.models import init_params
from repro_torch.serving import ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b", choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--continuous", action="store_true",
                    help="slot-level continuous batching instead of wave drain")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family in ("encdec",):
        raise SystemExit("serve launcher targets decoder-only archs")
    model = init_params(cfg, args.seed, device=args.device, dtype=torch.float32)
    eng = ServeEngine(cfg, model, max_slots=args.slots, max_seq=args.max_seq,
                      device=args.device)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for _ in range(args.requests):
        plen = int(rng.integers(4, 24))
        eng.submit(rng.integers(0, cfg.vocab, plen), max_new_tokens=args.max_new)
    done = eng.run_continuous()["lm"] if args.continuous else eng.run_until_drained()
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    mode = "continuous" if args.continuous else "waves"
    print(f"[serve] {mode} on {eng.device}: {len(done)} requests, {total_new} tokens in "
          f"{dt:.1f}s ({total_new / dt:.1f} tok/s)")
    for r in done[:4]:
        print(f"  rid={r.rid} prompt_len={len(r.prompt)} out={r.out_tokens[:8]}...")
    return len(done)


if __name__ == "__main__":
    main()
