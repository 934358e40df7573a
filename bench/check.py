"""Whether the timed path answered right: the comparison that decides ``correct``.

Three numbers are compared, each against a limit of 0 (exact comparisons):

* ``lost`` — requests of the window not answered exactly once (never, or
  twice), each awaited up to a minute past the close;
* ``records_off`` — requests of a seeded sample of the answered ones
  (``check_records`` of them, with the one of most rounds and the one of
  most records in it) whose records differ from every matching row of the
  blocks they read, in read order, with their measures bit for bit;
* ``plans_off`` — requests of the first ``check_sample`` of that sample
  (the two longest again in it) whose blocks, round by round, are no plan
  the reference's refill rounds allow (``reference.anyk.follow``).

Counted beside them and not compared: the plans that took a tie within
float32 rounding (``plan_ties``), how many were sampled, and whether a tie's
enumeration was capped.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from bench import traffic
from bench.reference import anyk

LIMITS = {"lost": 0, "records_off": 0, "plans_off": 0}


def records_off(dims, measures, rec, rpb: int) -> bool:
    res = rec.req.result
    q = rec.query
    blk, row, meas = anyk.records(dims, measures, q.predicates, q.op, res.blocks_fetched, rpb)
    if blk.numel() != res.record_block.size:
        return True
    if blk.numel() == 0:
        return False
    dev = dims.device
    got_meas = torch.as_tensor(np.ascontiguousarray(res.measures, dtype=np.float32), device=dev)
    return not (torch.equal(blk, torch.as_tensor(res.record_block, device=dev).long())
                and torch.equal(row, torch.as_tensor(res.record_row, device=dev).long())
                and torch.equal(meas.view(torch.int32), got_meas.view(torch.int32)))


def sample(recs: list, n: int, seed: int) -> list:
    """``n`` answered requests drawn from the seed, with the one of most
    rounds and the one of most records in it."""
    done = [r for r in recs if r.completions == 1]
    if not done:
        return []
    pick = set(traffic.rng(seed, traffic.STREAM_CHECK).permutation(len(done))[:n].tolist())
    pick.add(max(range(len(done)), key=lambda i: done[i].req.result.plan_rounds))
    pick.add(max(range(len(done)), key=lambda i: done[i].req.result.num_records))
    return [done[i] for i in sorted(pick)]


def plan_verdicts(cfg: dict, dims, dens: np.ndarray, queries: list, results: list) -> dict:
    """``follow`` over each (query, (blocks, rounds)) pair."""
    rpb = int(cfg["records_per_block"])
    cost = anyk.COST_MODELS[cfg["cost_model"]]
    out = {"exact": 0, "tie": 0, "off": 0, "capped": 0}
    for q, (blocks, rounds) in zip(queries, results):
        comb = anyk.combine(dens, anyk.row_ids(cfg["cards"], q.predicates), q.op)
        matches = anyk.block_matches(dims, q.predicates, q.op, rpb)
        verdict, capped = anyk.follow(comb, q.k, matches, blocks, rounds, rpb,
                                      int(cfg["max_refills"]), cost)
        out[verdict] += 1
        out["capped"] += int(capped)
    return out


def judge(cfg: dict, mix: dict, dims, measures, recs: list, seed: int) -> dict:
    rpb = int(cfg["records_per_block"])
    t0 = time.monotonic()
    lost = sum(1 for r in recs if r.completions != 1)
    rec_picked = sample(recs, int(mix["check_records"]), seed)
    rec_off = sum(1 for r in rec_picked if records_off(dims, measures, r, rpb))
    t1 = time.monotonic()
    picked = sample(recs, int(mix["check_sample"]), seed)
    dens = anyk.density_index(dims, cfg["cards"], rpb)
    plans = plan_verdicts(cfg, dims, dens, [r.query for r in picked],
                          [(r.req.result.blocks_fetched, r.req.result.plan_rounds) for r in picked])
    print(f"check: records {t1 - t0:.3f} s, plans {time.monotonic() - t1:.3f} s",
          file=sys.stderr)
    numbers = {"lost": lost, "records_off": rec_off, "plans_off": plans["off"]}
    counts = {"answered": sum(1 for r in recs if r.completions == 1),
              "records_sampled": len(rec_picked), "plans_sampled": len(picked),
              "plan_ties": plans["tie"], "plan_enumeration_capped": plans["capped"]}
    for name, value in counts.items():
        print(f"checked {name} {value}", file=sys.stderr)
    return {
        "correct": all(numbers[k] <= LIMITS[k] for k in LIMITS),
        "failed": lost + rec_off + plans["off"],
        "counts": counts,
        "check": {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()},
    }
