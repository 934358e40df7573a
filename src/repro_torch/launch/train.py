"""Training launcher: NeedleTail-filtered data pipeline + AdamW + checkpointing.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 24 --batch 8 --seq 2048 --filter "domain=code,quality=hi" --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --reduced \\
      --steps 8 --batch 4 --seq 48 --device cpu

Counterpart of ``repro/launch/train.py``, with its flags and defaults and
``--device`` (``cuda`` by default; ``cpu`` only when asked).  Without
``--reduced`` the configuration trains at its published widths and depth.
The model is initialised in f32 from ``--seed`` with the reference's
distributions and trained on the plain path with autograd
(``launch/steps.py``); the data pipeline's refills run kernels #1, #6 and
#7 on the card.  Auto-resumes from the newest committed checkpoint; the
pipeline state (consumed mask, round, rng counter, buffer) is checkpointed
with the model, so restarts are sample-exact.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.data.pipeline import (
    FilteredBatchStream, PipelineState, make_token_corpus, parse_filter,
)
from repro_torch.launch import steps as S
from repro_torch.models import init_params


def pipeline_extra(stream: FilteredBatchStream) -> dict:
    """The pipeline state as the checkpoint's ``extra`` holds it."""
    return {"pipeline": {
        "consumed": stream.state.consumed.tolist(),
        "round": stream.state.round,
        "rng_counter": stream.state.rng_counter,
        "buffer": list(stream._buffer),
    }}


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", help="CPU-size variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--filter", default="", help='e.g. "domain=code,quality=hi"')
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus-seqs", type=int, default=4096)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"active~{cfg.active_param_count()/1e6:.1f}M device={args.device}")

    store, tokens = make_token_corpus(
        num_seqs=args.corpus_seqs, seq_len=args.seq + 1, vocab=cfg.vocab,
        seed=args.seed, device=args.device,
    )
    preds = parse_filter(args.filter)
    stream = FilteredBatchStream(store, tokens, preds, args.batch, seed=args.seed)

    model = init_params(cfg, args.seed, device=args.device, dtype=torch.float32)
    state = S.make_train_state(model)
    train_step = S.make_train_step(cfg, peak_lr=args.lr, warmup=10, total_steps=args.steps)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and latest_step(args.ckpt_dir) is not None:
        state, start = mgr.restore(state)
        meta_extra = mgr.extra(start)
        if "pipeline" in meta_extra:
            pl = meta_extra["pipeline"]
            stream.state = PipelineState(
                consumed=np.asarray(pl["consumed"], dtype=bool),
                round=pl["round"], rng_counter=pl["rng_counter"],
            )
            stream._buffer = list(pl.get("buffer", []))
        print(f"[train] resumed from step {start}")

    dev = model.device
    metrics = None
    t0 = time.time()
    for step in range(start, args.steps):
        batch = next(stream)
        tb = {"tokens": batch["tokens"], "labels": batch["labels"]}
        if cfg.family == "encdec":
            tb["enc_frames"] = torch.zeros((args.batch, cfg.enc_seq, cfg.d_model), device=dev)
        if cfg.family == "vlm":
            tb["patch_embeds"] = torch.zeros((args.batch, cfg.num_patches, cfg.d_model),
                                             device=dev)
        state, metrics = train_step(state, tb)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time()-t0):.1f}s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, extra=pipeline_extra(stream))
    if mgr:
        mgr.save(args.steps, state, extra=pipeline_extra(stream))
    print(f"[train] done: {args.steps - start} steps in {time.time()-t0:.1f}s")
    # a run resumed at its last step trains no step and has no loss
    return float(metrics["loss"]) if metrics is not None else float("nan")


if __name__ == "__main__":
    main()
