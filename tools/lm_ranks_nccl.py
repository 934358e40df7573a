#!/usr/bin/env python3
"""The sharded LM on four cards: ``chip_smoke.py``'s lm_sharded_ranks ranks
over NCCL, one rank a card, held against the unsharded step and the
unsharded depth-cut zamba2-7b computed on card 0 first.

On one card ``chip_smoke.py`` runs its four ranks over gloo, whose
``all_gather_into_tensor`` crashes on CUDA tensors; NCCL takes one card a
rank, so this needs a machine with (at least) four cards::

    python3 tools/lm_ranks_nccl.py

Each rank: mamba2-130m's train step at ``[8, 2048]`` on ``(2, 2)`` tp_sp
and ``(4,)`` fsdp (loss, grad norm and parameters against the unsharded
step; the step's collectives counted and sized; a second step timed), and
zamba2-7b cut to ``SHARD_ZAMBA_LAYERS`` layers served under ``rules`` on
``(2, 2)`` (its tokens against the unsharded run's, #8 and #9 on its half
of the heads).  On the CPU, ``--device cpu --backend gloo --small``
rehearses it on reduced models.
"""
import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--small", action="store_true", help="reduced models (a CPU rehearsal)")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)

    import torch

    import chip_smoke as cs

    if a.device == "cuda":
        from repro_torch.kernels import _lib

        if torch.cuda.device_count() < cs.SHARD_RANKS:
            print(f"needs {cs.SHARD_RANKS} cards, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip().splitlines()
        cs.log(f"cards: {cards}; torch {torch.__version__} cuda {torch.version.cuda}")
        t0 = time.perf_counter()
        _lib.load()
        cs.log(f"build {time.perf_counter() - t0:.1f} s")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    args = argparse.Namespace(seed=a.seed, profile=False)
    plan = cs.shard_plan(a.device, a.small)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        m0, _, secs = cs.train_reference(plan, a.seed, tmp)
        cs.log(f"unsharded step on one card: loss {float(m0['loss'])}, {secs} s")
        cs.cut_reference(plan, a.seed, tmp)
        if a.device == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        got = cs.launch_lm_ranks(args, plan, tmp, a.backend, ["--backend", a.backend])
        res = cs.check_lm_ranks(got, tmp, plan)
    for r in res["ranks"]:
        cs.log(f"{a.backend} rank {r['rank']}: {json.dumps(r)}")
    cs.log(f"{a.backend} ranks: {time.perf_counter() - t1:.1f} s, every rank equal to the "
           f"unsharded runs; {time.perf_counter() - t0:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
