"""Dry run of the paper-technique cell: the distributed NeedleTail query step
on the production mesh.

Counterpart of ``repro/launch/dryrun_engine.py``: one any-k query over a
fleet-scale corpus, λ = 2²⁰ blocks × 8,192 records a block ≈ 8.6 G records,
64 density rows, sharded over every rank of the 256-rank mesh (the engine
has no tensor axis: the whole mesh is one data plane).  The step runs

  density_combine (γ = 3, ⊕ = ∏)  →  THRESHOLD (local top-C + all-gather +
  cut) or the θ-bisection  →  TWO-PRONG (group sums + all-gather + window)
  →  HT estimator terms (all-reduce)

through ``repro_torch.core.sharded``.  The port's planners take host
decisions on every rank (host row ids for the combine, sorted frontiers
cut on the host's tensors), so they do not run on fake tensors.  The step
runs instead as rank 0 of a ``fake`` process group of 256 (or 512) ranks,
on real tensors of rank 0's shard (λ / P blocks × 64 rows: 4,096 × 64 f32
= 1 MiB at P = 256); the fake group's collectives move nothing, so the
plan it cuts is not the corpus's.  The artifact reports shapes, counts and
bytes only (per-device memory, collective counts and bytes), in the LM dry
run's schema (:mod:`repro_torch.launch.dryrun`).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_engine [--candidates 64]
      [--group 64] [--dtype float32|bfloat16] [--planner sort|bisect]
      [--mesh single|multi] [--lam N] [--suffix _x]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.launch.dryrun import ARTIFACTS, fake_world, measure

LAM = 1 << 20  # 1M blocks x 8192 records a block ~ 8.6G records
NUM_ROWS = 64  # (attr, value) pairs in the density index
RPB = 8192
ROWS = (0, 5, 9)  # the γ = 3 predicates ANDed


def query_step(dens_local: torch.Tensor, k: float, group_pg, planner: str, candidates: int,
               group: int):
    """One query on this rank's ``[rows, λ_local]`` shard of the index."""
    from repro_torch.core import sharded as SH
    from repro_torch.kernels.density_combine import density_combine_batch_sharded

    rm = torch.tensor([ROWS], dtype=torch.int32)
    combined = density_combine_batch_sharded(dens_local.to(torch.float32), rm, None, "and")[0]
    lam_local = combined.shape[0]
    if planner == "bisect":
        bi = SH.sharded_threshold_bisect(combined, k, RPB, group_pg)
        selected = combined >= bi.theta
        num_selected, expected = bi.num_selected, bi.expected_records
    else:
        thr = SH.sharded_threshold(combined, k, RPB, group_pg, candidates=candidates)
        lo = SH.shard_group(group_pg).index * lam_local
        ids = thr.block_ids[thr.block_ids >= 0].long() - lo
        selected = torch.zeros(lam_local, dtype=torch.bool)
        selected[ids[(ids >= 0) & (ids < lam_local)]] = True
        num_selected, expected = thr.num_selected, thr.expected_records
    tp = SH.sharded_two_prong(combined, k, RPB, group_pg, group=group)
    # HT estimator terms over the selected frontier (Eq. 1/5), all-reduced
    est = SH.sharded_ht_terms(selected.to(torch.float32), selected.to(torch.float32), group_pg)
    return num_selected, expected, tp.start_block, tp.end_block, est[0]


def run(lam: int = LAM, mesh_kind: str = "single", planner: str = "sort",
        candidates: int = 64, group: int = 64, dtype: str = "float32", k: float = 1e6,
        seed: int = 0, world: int | None = None) -> dict:
    """The cell's artifact on a fake world of the production mesh's size
    (``world``: a fake world of that many ranks on one ``data`` axis)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh

    shape, _ = PRODUCTION_MESHES[mesh_kind == "multi"]
    n = world or int(torch.tensor(shape).prod())
    with fake_world(n):
        if world is None:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
        else:
            mesh = DeviceMesh("cpu", torch.arange(n), mesh_dim_names=("data",))
        lam_local = -(-lam // n)
        if lam_local % group:
            raise ValueError(f"λ / P = {lam_local} is not a multiple of the group {group}")
        g = torch.Generator().manual_seed(seed)
        dt = torch.float32 if dtype == "float32" else torch.bfloat16
        dens = (torch.rand((NUM_ROWS, lam_local), generator=g) ** 2).to(dt)
        t0 = time.time()
        memory, analyzer, _ = measure(
            lambda: query_step(dens, k, dist.group.WORLD, planner, candidates, group), dens)
        res = {
            "arch": "needletail-engine", "shape": f"anyk_lam{lam}", "mesh": mesh_kind,
            "status": "ok",
            "params": {"candidates": candidates, "group": group, "dtype": dtype,
                       "planner": planner, "lam": lam, "rpb": RPB, "lam_local": lam_local,
                       "rows": NUM_ROWS, "gamma": len(ROWS), "k": k},
            "memory": memory,
            "cost_raw": None,
            "analyzer": analyzer,
            "num_devices": mesh.size(),
            "wall_s": round(time.time() - t0, 1),
            "notes": ("rank 0's shard, real tensors, over a fake process group whose "
                      "collectives move nothing: shapes, counts and bytes only"),
        }
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--candidates", type=int, default=64)
    ap.add_argument("--group", type=int, default=64)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--planner", default="sort", choices=["sort", "bisect"])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--lam", type=int, default=LAM)
    ap.add_argument("--world", type=int, default=None,
                    help="a fake world of this many ranks in place of the production mesh")
    ap.add_argument("--suffix", default="")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    res = run(args.lam, args.mesh, args.planner, args.candidates, args.group, args.dtype,
              world=args.world)
    out = Path(args.out) / f"needletail-engine__anyk__{args.mesh}{args.suffix}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=2))
    print(json.dumps(res["analyzer"], indent=2)[:1200])
    print("memory:", res["memory"])
    print("->", out)


if __name__ == "__main__":
    main()
