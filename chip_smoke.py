#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of NeedleTail on one NVIDIA card, end to end.

    python3 chip_smoke.py [--records N] [--seed S] [--profile]

Phases, each of which fails the run (non-zero exit) on any fault:

1. card   — print the card's name and power limit (``nvidia-smi``).
2. build  — compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   ``sm_90a``) and print the build time and, per kernel, ptxas's registers
   and spill stores and loads.
3. data   — build an airline-like table (``make_real_like_table("airline")``,
   10⁸ records by default, the size of the public on-time dataset it
   imitates) in blocks of 8192 records (the paper's 256 KB block at 32-byte
   records) and move it to the card.

Then the paths, each through the entry points a user calls.  Before each,
the kernels' launch counters are zeroed; just after, they are read, and the
path must have launched each of its own kernels (``PHASE_KERNELS``):

4. wave        — a wave of 64 any-k queries through
   ``NeedleTailEngine(store, device="cuda").any_k_batch(..., device=True)``,
   cold and again warm.  Every returned record is re-checked against the
   host table, ``num_records >= k`` unless a full scan counts fewer matches
   or ``max_refills`` ran out, ``device_transfers <= rounds + 1``, and the
   same wave run by the port on the CPU (plain versions) must give identical
   per-query results.  Round-0 TWO-PRONG windows are held against the
   float64 ``two_prong_faithful`` under the planner contract.  The wave
   must launch #2 once (its AND and OR queries in one combine) and #5 once
   per planning round.
5. host-mirror — the same wave through ``any_k_batch(..., device=False)``
   on a fresh engine: per-query results, rounds, unique blocks, store reads
   and cache hits must equal the device wave's; #2 must launch once per
   combine of a (round, algorithm) group, whatever its ops and exclusions.
6. single      — ``engine.any_k`` for at least 8 of the wave's queries
   (THRESHOLD, TWO-PRONG and ``auto``; AND and OR; at least one refill),
   each equal to its result in the wave and re-checked on the host table.
7. bisect      — ``ops.threshold_bisect`` on each of the wave's 64 combined
   rows with its k, one launch of the ``theta_stats`` kernel a row (64 in
   all, asserted), against the same steps on the plain statistics
   (thresholds bit for bit in every round until the rounds' ``recsum·rpb
   >= k`` tests part, equal θ, boundary cases where they part within
   ``rtol=1e-5`` of k counted) and against the sort-based THRESHOLD cut,
   whose density must lie in the bisection's final bracket.  Then each row
   timed beside the step-by-step path it replaced (a one-round launch and
   the bracket's tensor operations a round), by CUDA events and host clock.
8. sharded     — a world of one over NCCL (``tcp://127.0.0.1``),
   ``make_host_mesh()`` and ``engine.attach_mesh(mesh)``: the same wave
   through ``any_k_batch(device=True)``, cold and warm, then
   ``device=False`` on a fresh engine; per-query results, rounds, unique
   blocks, store reads and cache hits must equal the wave phase's.  The
   joiners' rows are combined on the rank's λ-shard (#3).
   ``bisect_stats_wave`` on the 64 combined rows against the unsharded
   ``ops.threshold_bisect`` (θ equal, boundary cases counted), one #5
   launch a round and one more (4, asserted; #3 once), and against the
   same loop on the plain rounds, timed beside it.  An NCCL failure fails
   the run.
9. sharded_ranks — P = 4 ranks on the same card, started by this script as
   subprocesses under a time limit (gloo: NCCL refuses two ranks on one
   card; the collectives' CUDA tensors cross the host, the compute stays on
   the card), each building the same table and running the same wave: every
   rank's per-query digest must equal the sharded phase's, and each rank's
   cold wave must launch #3 once.

Then the rest of the paper's query surface on the same table, each phase
also run by the port on the CPU copy of the store (plain versions), which
it must equal:

10. predicates — a wave of 64 queries (``make_tree_wave``): 48 Predicate
   trees (``Eq``, ``In`` of 2-4 values, ``Range`` over month or day of
   week, ``Not``, ``And``/``Or`` nested two deep) and 16 pair lists,
   through the device wave (one #2 launch for the pair lists, one #1 for
   each ``In`` node compiled on the card, one #5 a round, asserted), then
11. predicates_host — the host mirror on a fresh engine (rounds, blocks
   and cache counters equal the device wave's; #2 once a combine), and
12. predicates_single — ``any_k`` for 8 of its queries.  Every record is
   re-checked against its tree on the host table in numpy.
13. forward_optimal — ``forward_optimal_scan`` over a combined row at the
   full λ = 12,208 with k = 1,000 under ``hdd`` (t = 64), its ``opt_table``
   equal to the CPU run's bit for bit; then at the reference bench's scale
   (``make_clustered_table(50_000, num_dims=4, density=0.2, seed=7)``,
   blocks of 64, λ = 782, k = 100: the faithful DP is O(λ·k·t) Python and
   takes minutes at λ = 12,208) the faithful DP and ``any_k(algo=
   "forward_optimal")``, the DP's cost equal to the scan's Opt(k) within
   1e-4.
14. aggregate — ``engine.aggregate`` for a pair list and a tree (measure 0,
   k = 20,000, α = 0.1, both estimators), then ``run_online_aggregate`` to
   an error SLO of 1% of the offline mean (chunks of 8, at most 64 rounds),
   whose last estimate must ``==`` the offline estimator on its fetched
   set; blocks equal the CPU run's, estimates within ``RTOL``; the true
   mean over every matching record, exact in f64 on the card.
15. groupby — ``groupby_any_k`` over the 12 carriers of origin 0's flights,
   k = 1,000 a group, ψ = 8, measure 0: counts, blocks and records equal
   the CPU run's.
16. baselines — bitmap (91 rows × 1,562,500 words), lossy-bitmap and EWAH
   indexes of the whole table on the card, word for word equal to the CPU
   build's; BITMAP-SCAN, EWAH-SCAN and DISK-SCAN for the 16 pair lists,
   first-k ids equal to the host table's; Table 2's bytes.  The indexes
   are freed before the LM phases.

Then the LM serving path, on zamba2-7b at its published widths and full
depth (81 layers, ~5.74·10⁹ parameters, f32, random weights from
``--seed``; the any-k data stays on the card beside it):

17. lm_forward — ``LM.forward`` on a ``[1, 2048]`` token batch with
   ``impl="kernel"``: flash attention (#8) must launch once per ``A``
   occurrence (13) and the SSD scan (#9) once per ``M`` sublayer (68).
   The logits are held against the same forward with ``impl="plain"`` on
   the card within ``LM_ATOL``/``LM_RTOL``.
18. lm_serve — ``ServeEngine(cfg, model, device="cuda").run_until_drained``
   on the launcher's traffic (8 requests, prompts of 4-23 tokens, 16 new
   tokens, 4 slots, ``max_seq`` 128) and on long prompts (4 requests of
   1024-2048 tokens, ``max_seq`` 2176), each beside the same engine with
   ``impl="plain"``: the first wave's prefill logits and caches within
   tolerance, and greedy tokens equal except at near-ties (the plain run's
   top-2 logit gap within twice the tolerance), which are counted.  Prefill
   takes each Mamba layer's final state from #9's own call (one launch per
   ``M`` sublayer, no plain SSD); the long wave's prefill time is logged.
   With ``--profile``, one more wave of each traffic runs under the
   profiler.

Then, with zamba2-7b freed, the sliding-window family: gemma3-12b at its
published widths and full depth (48 layers ``LLLLLG``, window 1024,
d_model 3840, 16 heads of 240, 8 kv heads, ~1.26·10¹⁰ parameters, f32):

19. lm_forward_swa — as lm_forward: #8 must launch once per attention
   sublayer, 48 times (40 windowed, 8 global).
20. lm_serve_swa — as lm_serve on both traffics.  The long prompts exceed
   the window, so prefill arranges each ``L`` layer's ring of 1024 slots
   (compared slot for slot) and decoding goes on around it.

21. kernels — each kernel at its path's shapes against its plain PyTorch
   version on the card (exact for the combines, the gather, the prefix scan
   and the θ-counts, ``rtol=1e-5`` for the θ-sums; the reference's own
   tolerances for #8 and #9), timed with CUDA events (median of 25) beside
   the plain version, a library call where one computes the same function,
   and the least time the card could take (``bound_ms``; for #8 and #9,
   which do their f32 products in 3xTF32, on the tensor cores' TF32 rate,
   with the f32 FMA bound beside it as ``bound_fma_ms``).  The prefix scan is
   also held bit for bit at lengths across its chunk edges and at the
   longest row its shared-memory branch takes and one longer; #8 also at
   h2o-danube-3-4b's GQA sliding-window shape, in bf16, at every head dim
   of ``FA_D_SWEEP`` (1 to 512) and at gemma3-12b's long-wave shapes
   (windowed and global, D 240, timed beside its plain version and
   ``scaled_dot_product_attention``), #9 (the CUDA kernels of a call
   counted and timed by ``torch.profiler`` as ``cuda_kernels_per_call``
   and ``phase_ms``) also per tensor at ``SSD_TF32X3_RTOL``, which the
   plain version with TF32 products must miss, with its final state, under
   slow decay (output and final state, the carried state's weight
   checked), over 64 chunks (``SSD_64_CHUNKS``) and at mamba2-130m's
   d_state 128;
   #2 on the wave's rows from the host (AND, OR, the wave's mix, the mix
   with exclusions) beside the per-op-group path it replaced; the sharded
   combine (#3) at the slab of one of P = 4 ranks and of a world of one;
   #5 as the wave round (T = 1), at 8 given thresholds (θ, 2θ, ..., 8θ)
   and as one sharded bisection round (T = 16) at both slabs.  #4 is timed
   as the path launches it, one whole bisection (3 rounds of 16), and as
   one round at 16 thresholds; #1 with host ids
   (by value) without and with a refill's exclusion list, each beside the
   path it replaced, by CUDA events and host clock.  The build must show
   no spills for the kernels of the last two redesigns (``NEW_KERNELS``).

Then tiered block storage (``repro_torch.storage``) on the same table, the
LMs freed, each phase's store reads through #7:

22. tiered — the wave on ``make_tier_stack(256 MiB, None)`` (~993 blocks
   in tier 0 on the card over unbounded pinned host memory,
   ``CostAwarePolicy``), cold then warm: both equal the flat wave phase's
   (records, blocks, rounds, store reads, cache hits); the warm wave reads
   0 store blocks with 0 evictions.  Then ``RecencyPolicy`` over 128 MiB /
   256 MiB: demotions cascade (``hbm.demotions_out == dram.demotions_in +
   hbm.evictions``) and, the 552.6 MB union exceeding both, blocks drop;
   results unchanged.  The same calls on the CPU copy give equal
   ``tier_counters()`` and ``snapshot()``; ``get_device`` of the union
   equals ``store.fetch``.  Wall times, per-tier hits, peak device memory.
23. calibration — the ``hbm`` level fitted (``calibrate_model``) on CUDA-
   event timings of #7 over the tier-0 pool, the ``dram`` level on copies
   from the pinned tier-1 pool to the card, the backing level through
   ``StoreTimingBackend`` on the card; fits, bandwidth and latency printed
   (these give the port's ``hbm`` and ``dram`` presets).  An engine with
   ``calibrated_cost=True`` and a ``PlanLedger``: its wave equals a flat
   engine's on the fitted model; the ledger's q-errors printed.
24. append_compact — ``engine.append`` of 10⁶ airline rows (seed + 1) on
   the tiered engine, then ``engine.compact`` from the first dirtied block:
   each time exactly the dirtied tail leaves every tier, the store (slabs
   and index) equals ``build_block_store`` of the same table bit for bit,
   and the next wave equals a fresh flat engine's; timed on the card and on
   the CPU copy.
25. prefetch — the wave's 48 ``auto`` queries (the memo predicts the plan
   ``auto`` picks): the memo warmed by a host-mirror wave, the tiers
   cleared, ``TierPrefetcher.kick`` + ``drain(wait=True)``: the next wave's
   round 0 reads 0 store blocks and equals a flat engine's; the async mode
   (a side stream) admits what the sync mode does, with equal results.

The last lines are the ``{"kernels": [...]}`` JSON, the ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import hashlib
import json
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# H100 SXM TF32 on the tensor cores, dense (NVIDIA's published peak):
# #8 and #9 run each f32 product as three TF32 products (3xTF32)
TF32_OPS_PER_S = 494.7e12
RPB = 8192
Q = 64
TIMING_RUNS = 25

KERNELS = {
    "density_combine": ("csrc/density_combine.cu", "src/repro/kernels/density_combine.py:75"),
    "density_combine_batch": ("csrc/density_combine.cu", "src/repro/kernels/density_combine.py:142"),
    "density_combine_batch_sharded": ("csrc/density_combine.cu",
                                      "src/repro/kernels/density_combine.py:222"),
    "theta_stats": ("csrc/theta_stats.cu", "src/repro/kernels/theta_stats.py:65"),
    "theta_stats_batch": ("csrc/theta_stats.cu", "src/repro/kernels/theta_stats.py:132"),
    "prefix_sum": ("csrc/window_scan.cu", "src/repro/kernels/window_scan.py:53"),
    "block_gather": ("csrc/block_gather.cu", "src/repro/kernels/plan_wave.py:325"),
    "flash_attention": ("csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:108"),
    "ssd_scan": ("csrc/ssd_chunk.cu", "src/repro/kernels/ssd_chunk.py:78"),
}
LM_KERNELS = ("flash_attention", "ssd_scan")
# the CUDA kernels each redesign launches (the last two slices'): their
# ptxas lines go into their rows, and the run fails if one spills
NEW_KERNELS = {"theta_stats": ("theta_bisect_kernel",),
               "density_combine": ("density_combine_excl_kernel",),
               "theta_stats_batch": ("theta_batch_kernel<1>", "theta_batch_kernel<16>"),
               "density_combine_batch": ("density_combine_wave_kernel",),
               "density_combine_batch_sharded": ("density_combine_wave_kernel",)}
# the kernels each path must launch; a kernel's "launches" in the JSON line
# are those of the first path listed here that runs it
PHASE_KERNELS = {
    "wave": ("density_combine_batch", "theta_stats_batch", "prefix_sum", "block_gather"),
    "host_mirror": ("density_combine_batch", "prefix_sum", "block_gather"),
    "single": ("density_combine", "prefix_sum", "block_gather"),
    "bisect": ("theta_stats",),
    "sharded": ("density_combine_batch_sharded", "theta_stats_batch", "prefix_sum",
                "block_gather"),
    "sharded_ranks": ("density_combine_batch_sharded", "prefix_sum", "block_gather"),
    "predicates": ("density_combine", "density_combine_batch", "theta_stats_batch", "prefix_sum",
                   "block_gather"),
    "predicates_host": ("density_combine", "density_combine_batch", "prefix_sum", "block_gather"),
    "predicates_single": ("density_combine", "prefix_sum", "block_gather"),
    "forward_optimal": ("density_combine", "block_gather"),
    "aggregate": ("density_combine", "prefix_sum", "block_gather"),
    "groupby": ("density_combine", "block_gather"),
    "baselines": (),  # plain tensor operations: the reference's baselines run no kernel
    "lm_forward": LM_KERNELS,
    "lm_serve": LM_KERNELS,
    "lm_forward_swa": ("flash_attention",),
    "lm_serve_swa": ("flash_attention",),
    "tiered": ("density_combine_batch", "theta_stats_batch", "prefix_sum", "block_gather"),
    "calibration": ("density_combine_batch", "theta_stats_batch", "prefix_sum", "block_gather"),
    "append_compact": ("density_combine_batch", "theta_stats_batch", "prefix_sum",
                       "block_gather"),
    "prefetch": ("density_combine_batch", "theta_stats_batch", "prefix_sum", "block_gather"),
}
SCAN_LENGTHS = (1, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 65_537, 12_208)
RTOL = 1e-5
SHARDS = 4  # ranks of the sharded_ranks phase, all on the one card
# the batched θ-bisection's defaults (core/sharded.py): rounds and fanout
BISECT_ROUNDS, BISECT_FANOUT = 3, 16
RANK_TIMEOUT_S = 300  # the sharded_ranks phase fails rather than hang

LM_ARCH = "zamba2-7b"
SWA_ARCH = "gemma3-12b"  # the sliding-window ('L') family: LLLLLG, window 1024, D 240
LM_FORWARD_SEQ = 2048
# logits and caches of the kernel path against the plain path, both f32 on
# the card (TF32 off): the two differ only in the order of the f32 sums
# inside attention and the SSD, carried through 81 residual layers; held
# per tensor, |a − b| <= atol + rtol·max|b| (check_close(scale="tensor"))
LM_ATOL = LM_RTOL = 2e-3
# the reference's own kernel tolerances (tests/test_kernels.py:160-189)
FA_TOL = 2e-3
SSD_ATOL, SSD_RTOL = 2e-3, 1e-2
# #8 in bf16 reads bf16 values and sums in f32: held against the f32 plain
# version on the same values upcast, to the rounding of its bf16 output
# (one bf16 ulp, 2^-7 relative; atol far below the outputs' ~0.04 at S ~ 1900)
FA_BF16_ATOL, FA_BF16_RTOL = 1e-4, 2.0**-7
# #9's slow-decay check must weigh the carried state: without it the output
# moves by more than this many SSD_ATOL
SSD_CARRY_MIN = 50
# #9 is also held per tensor, max |kernel − plain| <= SSD_TF32X3_RTOL·max
# |plain|: 3xTF32 reads ~3e-6 there, and one TF32 product a step (the
# control: the plain version with TF32 products) ~2^-10 ≈ 1e-3, which the
# check must miss for the run to pass
SSD_TF32X3_RTOL = 3e-5
# extra kernel checks: h2o-danube-3-4b's attention (B, Hq, Hkv, S = T, D,
# window) and mamba2-130m's SSD (B, H, S, dh, ds)
DANUBE_ATTN = (1, 32, 8, 6144, 120, 4096)
MAMBA2_130M_SSD = (1, 24, 2048, 64, 128)
# #9's state pass over 64 chunks at zamba2-7b's heads (B, H, S, dh, ds)
SSD_64_CHUNKS = (1, 112, 8192, 64, 64)
# #8 at every head dim: plain-load staging (1, 6, 7, 17), the whole-head edge
# (256 | 257), gemma3's 240, and D of 2 column groups; each causal (S = T)
# and windowed, right-aligned (S < T), GQA: (B, Hq, Hkv, S, T, window)
FA_D_SWEEP = (1, 6, 7, 17, 120, 128, 129, 240, 256, 257, 300, 512)
FA_SWEEP_SHAPES = ((2, 4, 2, 200, 200, None), (1, 4, 2, 130, 300, 64))
# the launcher's traffic (repro/launch/serve.py defaults) and long prompts
SERVE_TRAFFIC = {
    "launcher": {"requests": 8, "plen": (4, 24), "max_new": 16, "slots": 4, "max_seq": 128},
    "long": {"requests": 4, "plen": (1024, 2049), "max_new": 16, "slots": 4, "max_seq": 2176},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def make_wave(cards: np.ndarray, q: int, seed: int):
    """Q queries of 1-3 (attr, value) pairs, AND and OR, k log-uniform in
    [100, 20000]; most ``auto``, every 8th ``threshold`` and ``two_prong``.
    Airline attrs: month[12], day_of_week[7], carrier[12], origin[30],
    dest[30]; origin/dest values come from the six busiest airports."""
    from repro_torch.core.multi_query import BatchQuery

    rng = np.random.default_rng(seed)
    span = np.minimum(np.asarray(cards), [12, 7, 12, 6, 6])
    wave = []
    for i in range(q):
        attrs = np.sort(rng.choice(len(cards), size=int(rng.integers(1, 4)), replace=False))
        preds = [(int(a), int(rng.integers(0, span[a]))) for a in attrs]
        op = "or" if rng.random() < 0.25 else "and"
        k = int(np.exp(rng.uniform(np.log(100), np.log(20000))))
        algo = {1: "threshold", 2: "two_prong"}.get(i % 8)
        wave.append(BatchQuery(preds, k, op, algo))
    return wave


def time_ms(fn, flush=None) -> float:
    """Median CUDA-event time of one ``fn`` call over TIMING_RUNS runs (3
    warm-ups first).  A sleep kernel holds the card while the host enqueues
    every run, so each event pair brackets device work only, not the
    wrapper's host overhead.  ``flush`` runs before each timed call,
    outside its events."""
    import torch

    for _ in range(3):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(TIMING_RUNS)]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms of device time: the host runs ahead
    for start, end in pairs:
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in pairs]))


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bound_tf32x3_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The bound of f32 work done on the tensor cores in 3xTF32: three TF32
    operations for each f32 one."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, 3 * ops / TF32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations (3xTF32)")


def assert_same(a, b, what: str) -> None:
    if not np.array_equal(a, b):
        raise AssertionError(f"{what} differ")


def tree_mask(pred, dims: np.ndarray) -> np.ndarray:
    """A Predicate tree over the host table's ``[n, r]`` rows, in numpy,
    from the tree's fields alone (not the port's ``mask``)."""
    kind = type(pred).__name__
    if kind == "Eq":
        return dims[:, pred.attr] == pred.value
    if kind == "In":
        return np.isin(dims[:, pred.attr], np.asarray(pred.values))
    if kind == "Not":
        return ~tree_mask(pred.part, dims)
    masks = [tree_mask(p, dims) for p in pred.parts]
    return np.logical_and.reduce(masks) if kind == "And" else np.logical_or.reduce(masks)


def query_mask(q, dims: np.ndarray) -> np.ndarray:
    """Which of the host table's ``[n, r]`` rows satisfy query ``q`` (pairs
    under its op, or its Predicate tree)."""
    if isinstance(q.predicates, (list, tuple)):
        hits = [dims[:, a] == v for a, v in q.predicates]
        return np.logical_and.reduce(hits) if q.op == "and" else np.logical_or.reduce(hits)
    return tree_mask(q.predicates, dims)


def check_records(table, store, queries, batch, max_refills: int) -> dict:
    """Every returned record satisfies its predicates on the host table and
    carries its measures; ``num_records >= k`` unless the data or the refill
    budget runs out.  Returns the shortfall reasons by count."""
    reasons = {"full_scan_short": 0, "max_refills": 0}
    for q, r in zip(queries, batch.results):
        idx = r.record_block * store.records_per_block + r.record_row
        if idx.size and idx.max() >= table.num_records:
            raise AssertionError("a returned record lies in block padding")
        ok = query_mask(q, table.dims[idx])
        if not ok.all():
            raise AssertionError(f"{(~ok).sum()} returned records fail {q.predicates} {q.op}")
        if idx.size:
            assert_same(r.measures, table.measures[idx], "returned measures")
        if r.num_records < q.k:
            if int(query_mask(q, table.dims).sum()) < q.k:
                reasons["full_scan_short"] += 1
            elif r.plan_rounds >= max_refills:
                reasons["max_refills"] += 1
            else:
                raise AssertionError(f"query {q} returned {r.num_records} < k records")
    return reasons


def window_contract(store, queries) -> dict:
    """Round-0 TWO-PRONG windows of the card against float64 Algorithm 2.
    A window may differ only where the f64 record mass of the card's window
    or of the faithful one lies within ε = λ·2⁻²⁴·(total mass) of the need
    (the f32 prefix-sum error bound); such boundary cases are counted."""
    import torch

    from repro_torch.core.two_prong import two_prong_faithful, two_prong_select_batch

    lam, rpb = store.num_blocks, store.records_per_block
    rows = combined_rows(store, queries)
    needs = torch.tensor([float(q.k) for q in queries], device=store.device)
    tp = two_prong_select_batch(rows, needs, rpb)
    starts, ends, host = tp.start.cpu().numpy(), tp.end.cpu().numpy(), rows.cpu().numpy()
    out = {"equal": 0, "boundary": 0, "max_boundary_margin": 0.0}
    for i, q in enumerate(queries):
        fs, fe = two_prong_faithful(host[i], q.k, rpb)
        if (fs, fe) == (int(starts[i]), int(ends[i])):
            out["equal"] += 1
            continue
        m = host[i].astype(np.float64) * rpb
        eps = lam * 2.0**-24 * float(m.sum())
        margin = min(abs(m[starts[i]:ends[i]].sum() - q.k), abs(m[fs:fe].sum() - q.k))
        if margin >= eps:
            raise AssertionError(f"query {i}: window ({starts[i]},{ends[i]}) vs faithful "
                                 f"({fs},{fe}) with margin {margin} >= ε {eps}")
        out["boundary"] += 1
        out["max_boundary_margin"] = max(out["max_boundary_margin"], float(margin))
    return out


def combined_rows(store, queries):
    """The wave's ``[Q, λ]`` round-0 combined rows (each query's own op), in
    one combine."""
    from repro_torch.core.density_map import combine_densities_wave, pack_row_matrix

    rm = pack_row_matrix(store.index.vocab, [q.predicates for q in queries])
    return combine_densities_wave(store.index.densities, rm, [q.op for q in queries])


def compare_results(x, y, what: str) -> None:
    assert_same(x.record_block, y.record_block, f"{what} record_block")
    assert_same(x.record_row, y.record_row, f"{what} record_row")
    assert_same(x.measures, y.measures, f"{what} measures")
    assert_same(np.sort(x.blocks_fetched), np.sort(y.blocks_fetched), f"{what} blocks")
    if (x.plan_rounds, x.algo) != (y.plan_rounds, y.algo):
        raise AssertionError(f"{what}: rounds/algo differ")


def compare_waves(a, b) -> None:
    for i, (x, y) in enumerate(zip(a.results, b.results)):
        compare_results(x, y, f"query {i}")


def pick_single(queries, batch, n: int = 8) -> list[int]:
    """Wave indices for the single-query path: the first query of each
    (algo, op) pair the wave has, the first query that refilled, then the
    next queries in order up to ``n``."""
    pick = []
    for algo in ("threshold", "two_prong", "auto"):
        for op in ("and", "or"):
            i = next((i for i, q in enumerate(queries)
                      if (q.algo or "auto") == algo and q.op == op), None)
            if i is not None:
                pick.append(i)
    if not any(batch.results[i].plan_rounds > 1 for i in pick):
        refill = [i for i, r in enumerate(batch.results) if r.plan_rounds > 1]
        if not refill:
            raise AssertionError("no query of the wave refilled")
        pick.append(refill[0])
    pick += [i for i in range(len(queries)) if i not in pick][: max(0, n - len(pick))]
    return sorted(pick)


def parting_round(trace, ptrace, k: float, rpb: int) -> int | None:
    """The first round whose ``recsum·rpb >= k`` tests differ between the
    one-launch bisection's ``trace`` and the plain steps' ``ptrace``, or
    None.  Up to it the thresholds must be equal bit for bit and the sums
    within ``RTOL``; in it every differing test must lie within ``RTOL``
    of k (a boundary case)."""
    for r, ((ths, rs), (pths, prs)) in enumerate(zip(trace, ptrace)):
        if not np.array_equal(ths.cpu().numpy().view(np.int32),
                              pths.cpu().numpy().view(np.int32)):
            raise AssertionError(f"round {r}: thresholds differ from the plain steps'")
        rs_h, prs_h = rs.cpu().numpy(), prs.cpu().numpy()
        if not np.allclose(rs_h, prs_h, rtol=RTOL, atol=0.0):
            raise AssertionError(f"round {r}: recsum differs beyond rtol={RTOL}")
        ok, pok = rs_h * np.float32(rpb) >= np.float32(k), prs_h * np.float32(rpb) >= np.float32(k)
        if not np.array_equal(ok, pok):
            if not all(abs(float(prs_h[j]) * rpb - k) <= RTOL * k for j in np.flatnonzero(ok != pok)):
                raise AssertionError(f"round {r}: the bracket parts away from k")
            return r
    return None


def bisect_check(rows, queries, rpb: int) -> dict:
    """``ops.threshold_bisect`` on each combined row with its k: one launch
    of the ``theta_stats`` kernel a row (the launches are read right after
    these calls), held against the same steps on the plain statistics.

    * In every round up to the first whose ``recsum·rpb >= k`` tests
      differ, the thresholds must be equal bit for bit and the sums within
      ``rtol=1e-5``; θ* and the bracket must be equal unless such a round
      exists, and its differing tests must lie within ``rtol`` of k (the
      f32 sums add in another order): such boundary cases are counted.
    * The sort-based THRESHOLD cut's density must lie in the final bracket
      ``[lo, hi)`` of the kernel's bisection (blocks at ≥ lo hold ≥ k
      expected records, blocks at ≥ hi fewer), or θ* = 0 when all the
      row's records cannot reach k; a miss whose float64 mass at lo or hi
      lies within ``rtol`` of k is counted as a boundary case.
    * ``test_kernels.py``'s criterion ``|n_bisect − n_sort| <= max(2,
      0.01·n_sort)`` is counted, not required: on rows with many equal
      densities (a month predicate is 1.0 in every block of its month) or
      densities closer than the 16³-step grid, the bisection takes whole
      tie groups by design.
    """
    import torch

    from repro_torch.core.threshold import threshold_sort_batch
    from repro_torch.kernels.ops import bisect_rounds
    from repro_torch.kernels.theta_stats import theta_stats_plain

    kernel = [bisect_rounds(rows[i], float(q.k), rpb) for i, q in enumerate(queries)]
    launches = {}
    if rows.device.type == "cuda":
        from repro_torch.kernels import _lib

        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
    _, sorted_d, cum = threshold_sort_batch(rows)
    sd, cum_h = sorted_d.cpu().numpy(), cum.cpu().numpy()
    host = rows.cpu().numpy().astype(np.float64)
    out = {"equal": 0, "boundary": 0, "bracket": 0, "bracket_boundary": 0,
           "criterion_met": 0, "criterion_missed": 0}

    def near(mass: float, k: float) -> bool:
        return abs(mass - k) <= RTOL * k

    for i, q in enumerate(queries):
        lo, hi, trace = kernel[i]
        plo, phi, ptrace = bisect_rounds(rows[i], float(q.k), rpb, stats=theta_stats_plain)
        part = parting_round(trace, ptrace, float(q.k), rpb)
        if part is None and (float(lo), float(hi)) != (float(plo), float(phi)):
            raise AssertionError(f"query {i}: θ* {float(lo)} vs plain {float(plo)} "
                                 "with equal rounds")
        out["equal" if float(lo) == float(plo) else "boundary"] += 1
        lo, hi = float(lo), float(hi)
        x = host[i]
        # the sort cut, as threshold_cut takes it
        reached = cum_h[i] * np.float32(rpb) >= np.float32(q.k)
        n_sort = int(np.argmax(reached)) + 1 if reached.any() else int((sd[i] > 0).sum())
        if reached.any():
            theta_sort = float(sd[i][n_sort - 1])
            inside = lo <= theta_sort < hi
        else:
            inside = lo == 0.0
        if inside:
            out["bracket"] += 1
        elif near(x[x >= lo].sum() * rpb, q.k) or near(x[x >= hi].sum() * rpb, q.k):
            out["bracket_boundary"] += 1
        else:
            raise AssertionError(f"query {i}: sort cut outside the bisection bracket "
                                 f"[{lo}, {hi})")
        n_bisect = int((x >= lo).sum())
        met = abs(n_bisect - n_sort) <= max(2, 0.01 * n_sort)
        out["criterion_met" if met else "criterion_missed"] += 1
    out["launches"] = launches
    return out


def host_ms(fn, dev, runs: int = 9) -> float:
    """Median host-clock time of one ``fn`` call that ends synchronised
    (wrapper, eager operations and copies included), after one warm-up."""
    fn()
    sync(dev)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def bisect_timing(rows, queries, rpb: int) -> dict:
    """Per row, the one-launch bisection beside the step-by-step path it
    replaced (``bisect_rounds(..., stats=theta_stats)``: a launch of the
    statistics and some 18 tensor operations a round), by CUDA events
    (device time) and by host clock; the median over rows and the sum over
    the rows (the phase)."""
    from repro_torch.kernels.ops import bisect_rounds
    from repro_torch.kernels.theta_stats import theta_stats

    paths = {"one_launch": lambda i: bisect_rounds(rows[i], float(queries[i].k), rpb),
             "steps": lambda i: bisect_rounds(rows[i], float(queries[i].k), rpb,
                                              stats=theta_stats)}
    out = {}
    for name, fn in paths.items():
        ev = [time_ms(lambda: fn(i)) for i in range(len(queries))]
        hc = [host_ms(lambda: fn(i), rows.device, runs=5) for i in range(len(queries))]
        out[name] = {"event_ms_median": float(np.median(ev)), "event_ms_sum": float(np.sum(ev)),
                     "host_ms_median": float(np.median(hc)), "host_ms_sum": float(np.sum(hc))}
    return out


def wave_digest(batch) -> dict:
    """Per query a hash of its records, measures, blocks, rounds and
    algorithm, and the wave's rounds, unique blocks, store reads and cache
    hits: what two runs of one wave must share."""
    queries = []
    for r in batch.results:
        h = hashlib.sha256()
        for a in (r.record_block.astype(np.int64), r.record_row.astype(np.int64),
                  np.ascontiguousarray(r.measures, np.float32),
                  np.sort(r.blocks_fetched).astype(np.int64)):
            h.update(a.tobytes())
        h.update(f"{r.plan_rounds}/{r.algo}".encode())
        queries.append(h.hexdigest()[:16])
    return {"queries": queries, "counters": [batch.rounds, int(batch.unique_blocks_fetched.size),
                                             batch.store_blocks_fetched, batch.cache_hits]}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def collective_ms(dev, rows: int, lam_local: int, world: int) -> float:
    """One all-gather of the device round's THRESHOLD frontier (``[Q,
    2·λ_local]`` int32 from every rank), host clock over 10 calls ending
    synchronised."""
    import torch
    import torch.distributed as dist

    x = torch.zeros((rows, 2 * lam_local), dtype=torch.int32, device=dev)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        dist.all_gather(parts, x)
    sync(dev)
    return (time.perf_counter() - t0) / 10 * 1e3


def sharded_check(store, queries, batch, warm, rows, run, device: str = "cuda",
                  profile: bool = False) -> dict:
    """The sharded phase on an initialised world of one: ``attach_mesh``,
    then the wave cold and warm (with ``bisect_stats_wave`` on the combined
    rows inside the counted run) and the host-mirror loop on a fresh engine,
    each held against the unsharded waves; θ against ``ops.threshold_bisect``
    per row.  ``profile`` traces one more warm wave."""
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.kernels import _lib
    from repro_torch.kernels.ops import bisect_rounds
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device_type=device)
    engine = NeedleTailEngine(store, device=device)
    planner = engine.attach_mesh(mesh)
    needs = np.asarray([float(q.k) for q in queries], np.float32)
    walls = {}

    def cold_wave():
        t0 = time.perf_counter()
        out = engine.any_k_batch(queries, device=True)
        sync(device)
        walls["cold"] = time.perf_counter() - t0
        before = dict(_lib.LAUNCHES)
        bis = planner.bisect_stats_wave(rows, needs)
        return out, bis, {k: n - before[k] for k, n in _lib.LAUNCHES.items()}

    (sh, bis, bis_launches), _, launches = run("sharded", cold_wave)
    if device == "cuda":  # the plain versions launch nothing
        # one combine a wave; the bisection one launch a round and one more
        bis_want = {"theta_stats_batch": BISECT_ROUNDS + 1}
        check_launches(bis_launches, bis_want, "sharded bisection")
        want = {"density_combine_batch_sharded": 1, **bis_want}
        check_launches(launches, want, "sharded")
        log(f"sharded launch counts as expected: {want}, of which the bisection "
            f"{bis_want} ({BISECT_ROUNDS} rounds)")
    bisect_ms = sharded_bisect_ms(planner, rows, needs, store.records_per_block, device)
    t0 = time.perf_counter()
    sh_warm = engine.any_k_batch(queries, device=True)
    sync(device)
    walls["warm"] = time.perf_counter() - t0
    if profile:
        profile_wave(lambda: engine.any_k_batch(queries, device=True), "sharded wave again")
    host_engine = NeedleTailEngine(store, device=device)
    host_engine.attach_mesh(mesh)
    t0 = time.perf_counter()
    sh_host = host_engine.any_k_batch(queries, device=False)
    sync(device)
    walls["host_mirror"] = time.perf_counter() - t0
    for what, (mine, ref) in {"cold": (sh, batch), "warm": (sh_warm, warm),
                              "host_mirror": (sh_host, batch)}.items():
        compare_waves(mine, ref)
        if wave_digest(mine) != wave_digest(ref):
            raise AssertionError(f"sharded {what} wave: counters differ from the unsharded wave's")
    theta = bis.theta.cpu().numpy()
    out = {"equal": 0, "boundary": 0}
    for i, q in enumerate(queries):
        lo, _, trace = bisect_rounds(rows[i], float(q.k), store.records_per_block)
        if float(lo) == float(theta[i]):
            out["equal"] += 1
        elif any(abs(float(r) * store.records_per_block - q.k) <= RTOL * q.k
                 for _, rs in trace for r in rs.cpu().numpy()):
            out["boundary"] += 1
        else:
            raise AssertionError(f"query {i}: sharded θ {theta[i]} vs threshold_bisect {float(lo)}")
    return {"walls": walls, "transfers": sh.device_transfers, "round_seconds": sh.round_seconds,
            "warm_round_seconds": sh_warm.round_seconds, "bisect": out, "bisect_ms": bisect_ms,
            "collective_ms": collective_ms(device, len(queries), planner.local_width(
                store.num_blocks), 1),
            "digest": wave_digest(sh), "launches": launches}


def sharded_bisect_ms(planner, rows, needs, rpb: int, device: str) -> dict:
    """One batched θ-bisection of the wave (``bisect_stats_wave``: a launch
    a round and one more, a collective a round) beside the same loop on the
    plain round (the step-by-step tensor operations of the path it
    replaced), each on the card, by host clock (ends synchronised) and by
    CUDA events.  Both loops are run once more keeping each round's
    all-reduced statistics: per row, counts exact and sums within ``rtol``
    in every round until the rounds' ``recsum·rpb >= k`` tests part; θ and
    the count equal unless they part, where the parting test must lie
    within ``rtol`` of k (a boundary case, counted)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.sharded import shard_density_maps
    from repro_torch.kernels.theta_stats import (
        bisect_carry, bisect_round_batch, bisect_round_batch_plain,
    )

    local = shard_density_maps(rows, planner.sg.group)
    ks = torch.as_tensor(needs, dtype=torch.float32, device=local.device)

    def loop(round_fn, trace=None):
        c = bisect_carry(local.shape[0], BISECT_FANOUT, local.device)
        for r in range(BISECT_ROUNDS):
            c = round_fn(local, ks, rpb, c, first=r == 0)
            dist.all_reduce(c.stats, group=planner.sg.group)
            if trace is not None:
                trace.append(c.stats.clone())
        c = round_fn(local, ks, rpb, c, first=False, stats=False)
        return c.lo, c.n_sel, c.exp

    kt, pt = [], []
    (klo, kn, kexp), (plo, pn, pexp) = loop(bisect_round_batch, kt), \
        loop(bisect_round_batch_plain, pt)
    out = {"equal": 0, "boundary": 0}
    k_h = needs.astype(np.float32)
    for i in range(local.shape[0]):
        part = None
        for r, (a, b) in enumerate(zip(kt, pt)):
            ca, sa = a[i, :BISECT_FANOUT], a[i, BISECT_FANOUT:]
            cb, sb = b[i, :BISECT_FANOUT], b[i, BISECT_FANOUT:]
            oka, okb = sa * rpb >= float(k_h[i]), sb * rpb >= float(k_h[i])
            if not torch.equal(oka, okb):
                diff = (oka != okb).nonzero()[:, 0]
                if not bool(((sb[diff] * rpb - float(k_h[i])).abs()
                             <= RTOL * float(k_h[i])).all()):
                    raise AssertionError(f"row {i}: round {r}'s tests part away from k")
                part = r
                break
            if not (torch.equal(ca, cb) and torch.allclose(sa, sb, rtol=RTOL, atol=0.0)):
                raise AssertionError(f"row {i}: round {r}'s statistics differ from the plain "
                                     "round's")
        if part is not None:
            out["boundary"] += 1
            continue
        if float(klo[i]) != float(plo[i]) or int(kn[i]) != int(pn[i]) or \
                abs(float(kexp[i]) - float(pexp[i])) > RTOL * abs(float(pexp[i])):
            raise AssertionError(f"row {i}: θ {float(klo[i])} / {int(kn[i])} blocks vs the "
                                 f"plain rounds' {float(plo[i])} / {int(pn[i])}")
        out["equal"] += 1

    def kernel():
        return planner.bisect_stats_wave(rows, needs)

    def plain():
        return loop(bisect_round_batch_plain)

    out.update({"host_ms": host_ms(kernel, device), "plain_host_ms": host_ms(plain, device)})
    if device == "cuda":  # CUDA events need the card
        out.update({"event_ms": time_ms(kernel), "plain_event_ms": time_ms(plain)})
    return out


def launch_ranks(records: int, seed: int, world: int, device: str = "cuda",
                 timeout: float = RANK_TIMEOUT_S, profile: bool = False) -> list[dict]:
    """Start ``world`` ranks of this script (gloo, ``file://`` rendezvous)
    and return each one's result, with the profiler's lines of its log
    under ``"profile"``; every rank is killed when the phase ends or
    outlives ``timeout``."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--world",
             str(world), "--init", f"file://{tmp}/rendezvous", "--records", str(records),
             "--seed", str(seed), "--device", device, *(["--profile"] if profile else [])],
            stdout=logs[r], stderr=subprocess.STDOUT, text=True) for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                p.kill()
                p.wait()
        out = []
        for r, (p, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            text = f.read()
            f.close()
            lines = [ln[5:] for ln in text.splitlines() if ln.startswith("RANK ")]
            if p.returncode != 0 or not lines:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n{text[-3000:]}")
            out.append(json.loads(lines[-1]))
            out[-1]["profile"] = [ln for ln in text.splitlines()
                                  if ln.startswith(("profile", "  "))]
    return out


def rank_main(args) -> int:
    """One rank of the sharded_ranks phase: the table, then the wave through
    ``attach_mesh`` on both loops; prints ``RANK {json}``.  With
    ``--profile`` every rank runs one more warm wave, rank 0 under the
    profiler."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.data.block_store import build_block_store
    from repro_torch.data.synthetic import make_real_like_table
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh

    if args.device == "cuda":
        torch.cuda.set_device(args.rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=args.init, world_size=args.world,
                            rank=args.rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        mesh = make_host_mesh(device_type=args.device)
        t0 = time.perf_counter()
        table = make_real_like_table("airline", num_records=args.records, seed=args.seed)
        store = build_block_store(table, RPB, device=args.device)
        sync(args.device)
        data_s = time.perf_counter() - t0
        queries = make_wave(table.cards, Q, args.seed)
        walls, digests = {}, {}
        engine = NeedleTailEngine(store, device=args.device)
        planner = engine.attach_mesh(mesh)
        _lib.reset_launches()
        for what in ("cold", "warm"):
            t0 = time.perf_counter()
            b = engine.any_k_batch(queries, device=True)
            sync(args.device)
            walls[what], digests[what] = time.perf_counter() - t0, wave_digest(b)
            if what == "cold":
                launches, rounds = dict(_lib.LAUNCHES), b.round_seconds
        if args.profile:
            def again():
                return engine.any_k_batch(queries, device=True)

            if args.rank == 0:
                profile_wave(again, f"rank {args.rank} wave again")
            else:
                again()
        host = NeedleTailEngine(store, device=args.device)
        host.attach_mesh(mesh)
        t0 = time.perf_counter()
        digests["host_mirror"] = wave_digest(host.any_k_batch(queries, device=False))
        walls["host_mirror"] = time.perf_counter() - t0
        coll = collective_ms(args.device, Q, planner.local_width(store.num_blocks), args.world)
        print("RANK " + json.dumps({
            "rank": args.rank, "shards": planner.num_shards, "data_s": data_s, "walls": walls,
            "round_seconds": rounds, "digests": digests, "launches": launches,
            "collective_ms": coll, "lam_local": planner.local_width(store.num_blocks)}),
            flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def profile_wave(fn, label: str):
    """Run ``fn`` (one wave) under ``torch.profiler`` and print its device
    busy time by operator, the share of its wall time the device was busy,
    and its host operators and CUDA runtime calls by self CPU time (where a
    cold wave's first-use set-up shows).  Returns ``fn``'s result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side entries only (kernels, copies): the host ops that launched
    # them report the same device time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"profile {label}: wall {wall * 1e3:.3f} ms under the profiler, device busy "
        f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%), {sum(r[2] for r in rows)} device ops")
    for key, ms, n in rows[:12]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    log(f"profile {label}: host self time by operator")
    for key, ms, n in host[:12]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    return out


def device_ms(fn, runs: int = 10) -> dict:
    """Each kernel that ``fn`` launches, traced by ``torch.profiler`` over
    ``runs`` calls: ``{name: {"ms": device ms, "per_call": launches}}`` per
    ``fn`` call, the name without its namespace and arguments.  Empty where
    the profiler reports no device time (after earlier traces in the same
    process, as ``sdpa_kernels`` notes)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key)
            out[name] = {"ms": e.self_device_time_total / 1e3 / runs, "per_call": e.count / runs}
    return out


def sdpa_kernels(b: int, h: int, s: int, d: int) -> list[str]:
    """The device kernels ``scaled_dot_product_attention`` launches in f32
    (causal, [b, h, s, d] of random values), traced in a fresh process: late
    in a run that has traced long waves, the profiler reports no device
    kernels for it."""
    code = (
        "import json, sys, torch\n"
        "import torch.nn.functional as F\n"
        f"sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})\n"
        "import chip_smoke as cs\n"
        f"q, k, v = (torch.randn(({b}, {h}, {s}, {d}), device='cuda') for _ in range(3))\n"
        "print(json.dumps(sorted(cs.device_ms(\n"
        "    lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 1))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                         text=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def ptxas_report(build_log: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``'s log:
    registers, spill stores and spill loads, the kernel named with its
    template arguments (``demangle``)."""
    import re

    out, fn, spill = [], None, ""
    for line in build_log.splitlines():
        if line.startswith("== "):
            out.append(line)
        elif m := re.search(r"Function properties for (\S+)", line):
            fn = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            out.append(f"{demangle(fn)}: {m.group(1)} registers; {spill}")
            fn, spill = None, ""
    return out


_BUILTIN_TYPES = {"b": "bool", "c": "char", "a": "signed char", "h": "unsigned char",
                  "s": "short", "t": "unsigned short", "i": "int", "j": "unsigned",
                  "l": "long", "m": "unsigned long", "x": "long long",
                  "y": "unsigned long long", "f": "float", "d": "double"}


def demangle(mangled: str) -> str:
    """A kernel's own name in an Itanium-mangled symbol, with its template
    arguments as ``torch.profiler`` prints them (``_ZN..17ssd_state_kernelILi1EEEv..``
    → ``ssd_state_kernel<1>``): the last name of the (nested) prefix, then
    builtin types, named types and integer or bool literals."""
    import re

    def ident(i):  # <length><identifier> at i -> (identifier, next i)
        m = re.match(r"\d+", mangled[i:])
        j = i + len(m.group())
        return mangled[j:j + int(m.group())], j + int(m.group())

    i, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while i < len(mangled) and mangled[i].isdigit():
        name, i = ident(i)
    if not mangled.startswith("I", i):
        return name
    args, i = [], i + 1
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i] == "L":  # literal: L <type> <value> E, n for a minus sign
            kind, end = mangled[i + 1], mangled.index("E", i)
            value = mangled[i + 2:end].replace("n", "-")
            args.append({"0": "false", "1": "true"}[value] if kind == "b" else value)
            i = end + 1
        elif mangled[i].isdigit():
            arg, i = ident(i)
            args.append(arg)
        else:
            args.append(_BUILTIN_TYPES.get(mangled[i], mangled[i]))
            i += 1
    return f"{name}<{', '.join(args)}>"


def kernel_row(name, phase_launches: dict, err, ms, plain, lib, nbytes, ops, tf32x3=False,
               **extra) -> dict:
    """One row of the ``{"kernels": [...]}`` line; ``launches`` are those of
    the first path in ``PHASE_KERNELS`` that runs the kernel.  ``tf32x3``: the
    kernel does its f32 products in 3xTF32, so its bound is on that datapath
    and the f32 FMA bound goes beside it as ``bound_fma_ms``."""
    b, by = bound_ms(nbytes, ops)
    if tf32x3:
        extra["bound_fma_ms"] = b
        b, by = bound_tf32x3_ms(nbytes, ops)
    src, rep = KERNELS[name]
    by_phase = {ph: n[name] for ph, n in phase_launches.items()}
    owner = next(ph for ph, names in PHASE_KERNELS.items() if name in names)
    log(f"kernel {name}: {ms:.4f} ms (plain {plain:.4f}, library "
        f"{'n/a' if lib is None else f'{lib:.4f}'}, bound {b:.5f} by {by}), "
        f"max_abs_err {err}, launches {by_phase}")
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/{src}",
            "replaces": rep, "launches": by_phase[owner], "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib, "launches_by_phase": by_phase, **extra}


def kernel_phase(store, queries, batch, phase_launches: dict, rows) -> list[dict]:
    """Each kernel at the path's shapes against its plain version, timed;
    returns the rows of the ``{"kernels": [...]}`` line."""
    import torch

    from repro_torch.core.density_map import pack_row_matrix
    from repro_torch.core.threshold import threshold_sort_batch
    from repro_torch.core.sharded import local_width
    from repro_torch.kernels.density_combine import (
        combine_single, density_combine, density_combine_batch, density_combine_batch_plain,
        density_combine_batch_sharded, density_combine_plain, density_combine_wave,
        density_combine_wave_plain, density_combine_wave_sharded, exclusion_csr, exclusion_ids,
    )
    from repro_torch.kernels.ops import bisect_rounds
    from repro_torch.kernels.plan_wave import (
        block_gather, block_gather_plain, plan_wave_from_combined,
    )
    from repro_torch.kernels.theta_stats import (
        BisectCarry, bisect_carry, bisect_round_batch, bisect_round_batch_plain, theta_stats,
        theta_stats_batch, theta_stats_batch_plain, theta_stats_plain, theta_wave,
        theta_wave_plain,
    )
    from repro_torch.kernels.window_scan import SMEM_MAX_N, prefix_sum, prefix_sum_plain

    dev = store.device
    lam, rpb = store.num_blocks, store.records_per_block
    dens = store.index.densities
    entries = {}

    def entry(name, *args, **extra):
        entries[name] = kernel_row(name, phase_launches, *args, **extra)

    # single ⊕-combine (#1) as the single-query planner calls it: the γ ids
    # of the wave's first 3-predicate AND query from the host (by value),
    # without and with the exclusion list of a refill (the blocks a refilled
    # query of the wave read), each bit for bit its plain version; beside
    # them the path it replaced (the ids copied to the card, a Q = 1 launch
    # of #2's kernel, then a clone, the ids copied again and a scatter)
    q3 = next(q for q in queries if q.op == "and" and len(q.predicates) == 3)
    r3_np = store.index.vocab.rows(q3.predicates)
    r3h = torch.from_numpy(r3_np)
    r3 = r3h.to(dev)
    refill = next(r for r in batch.results if r.plan_rounds > 1)
    excl = np.asarray(refill.blocks_fetched, np.int64)
    for op in ("and", "or"):
        want = density_combine_plain(dens, r3, op)
        for ids in (r3h, r3):
            if not torch.equal(density_combine(dens, ids, op), want):
                raise AssertionError(f"density_combine ({op}) differs from its plain version")
        want[torch.from_numpy(excl).to(dev)] = 0.0
        if not torch.equal(density_combine(dens, r3h, op, excl), want):
            raise AssertionError(f"density_combine ({op}, exclusion) differs from its plain "
                                 "version")

    def old_combine(exclude=None):
        out = density_combine_batch(dens, torch.from_numpy(r3_np).to(dev)[None], "and")[0]
        if exclude is not None:
            out = out.clone()
            out[torch.from_numpy(exclude).to(dev)] = 0.0
        return out

    def plain_excl():
        out = density_combine_plain(dens, r3, "and")
        out[torch.from_numpy(excl).to(dev)] = 0.0
        return out

    r3l = r3.long()
    g = r3.numel()
    n_ex = int(np.unique(excl).size)
    b_ex, by_ex = bound_ms((g + 1) * lam * 4 - g * n_ex * 4 + n_ex * 4, float(g * (lam - n_ex)))
    excl_dev = torch.from_numpy(exclusion_ids(excl, lam)).to(dev)
    if not torch.equal(combine_single(dens, r3h, excl_dev, "and"), plain_excl()):
        raise AssertionError("density_combine's launch with a device exclusion list differs")
    exclusion = {
        "excluded": n_ex, "kernel_ms": time_ms(lambda: combine_single(dens, r3h, excl_dev, "and")),
        "ms": time_ms(lambda: density_combine(dens, r3h, "and", excl)),
        "plain_ms": time_ms(plain_excl), "old_path_ms": time_ms(lambda: old_combine(excl)),
        "host_ms": host_ms(lambda: density_combine(dens, r3h, "and", excl), dev),
        "old_path_host_ms": host_ms(lambda: old_combine(excl), dev),
        "bound_ms": b_ex, "bound_by": by_ex}
    no_excl = {"old_kernel_ms": time_ms(lambda: density_combine_batch(dens, r3[None], "and")),
               "old_path_ms": time_ms(old_combine),
               "host_ms": host_ms(lambda: density_combine(dens, r3h, "and"), dev),
               "old_path_host_ms": host_ms(old_combine, dev)}
    log(f"kernel density_combine: exclusion {exclusion}; without {no_excl}")
    entry(
        "density_combine", 0.0,
        time_ms(lambda: density_combine(dens, r3h, "and")),
        time_ms(lambda: density_combine_plain(dens, r3, "and")),
        time_ms(lambda: torch.prod(dens[r3l], dim=0)),
        (g + 1) * lam * 4, float(g * lam),
        gamma=g, without_exclusion=no_excl, exclusion=exclusion,
    )

    # batched ⊕-combine (#2): the wave's [64, γ<=3] row matrix from the host
    # (ops and ids by value in the launch), every row AND, every row OR, each
    # query's own op (the wave's mix) and the mix with exclusions (even
    # queries exclude the blocks they fetched, odd ones none), each bit for
    # bit its plain version, and with device ids; every row AND timed,
    # the mix and the mix with exclusions beside it and beside the paths they
    # replaced (per op group the ids copied to the card, a launch and a
    # scatter into the wave's rows; then a [Q, λ] bool mask copied and a
    # where), by CUDA events and by host clock
    nq = len(queries)
    rm_np = pack_row_matrix(store.index.vocab, [q.predicates for q in queries])
    rmh = torch.from_numpy(rm_np)
    rm = rmh.to(dev)
    wave_ops = [q.op for q in queries]
    excludes = [np.asarray(r.blocks_fetched, np.int64) if i % 2 == 0 else np.zeros(0, np.int64)
                for i, r in enumerate(batch.results)]
    csr = exclusion_csr(excludes, lam)

    def plain_wave(d, ops, ex=None):
        is_or = torch.tensor([o == "or" for o in ops], device=dev)
        return density_combine_wave_plain(
            d, rm, is_or, None if ex is None else torch.from_numpy(exclusion_csr(ex, lam)).to(dev))

    cases = {"and": (["and"] * nq, None), "or": (["or"] * nq, None), "mixed": (wave_ops, None),
             "mixed_excluded": (wave_ops, excludes)}
    for what, (ops, ex) in cases.items():
        want = plain_wave(dens, ops, ex)
        for ids in (rmh, rm):
            if ids is rm and ex is not None:
                continue
            if not torch.equal(density_combine_wave(dens, ids, ops, ex), want):
                raise AssertionError(f"density_combine_batch ({what}) differs from its plain "
                                     "version")
    def old_path(exclude=False):  # per op group: ids copied, a launch, a scatter
        out = torch.empty((nq, lam), dtype=torch.float32, device=dev)
        for op in ("and", "or"):
            js = [j for j, o in enumerate(wave_ops) if o == op]
            rows_g = torch.from_numpy(rm_np[js]).to(dev)
            out[torch.as_tensor(js, device=dev)] = density_combine_batch(dens, rows_g, op)
        if exclude:  # the [Q, λ] bool mask built on the host, copied, applied
            excl_mask = np.zeros((nq, lam), dtype=bool)
            for i, ex in enumerate(excludes):
                if ex.size:
                    excl_mask[i, ex] = True
            out = torch.where(torch.from_numpy(excl_mask).to(dev), 0.0, out)
        return out

    if not torch.equal(old_path(True), density_combine_wave(dens, rmh, wave_ops, excludes)):
        raise AssertionError("density_combine_batch's wave differs from the per-op-group path")
    rmc, valid = rm.long().clamp(min=0), (rm >= 0)[..., None]
    n_rows = int(np.unique(rm_np[rm_np >= 0]).size)
    n_terms = int((rm_np >= 0).sum())
    n_ex = int(csr.size - nq - 1)
    wave_bytes = (n_rows * lam + nq * lam) * 4
    b_ex, by_ex = bound_ms(wave_bytes + csr.size * 4, float(n_terms * lam))
    mixed = {
        "ms": time_ms(lambda: density_combine_wave(dens, rmh, wave_ops)),
        "old_path_ms": time_ms(old_path),
        "host_ms": host_ms(lambda: density_combine_wave(dens, rmh, wave_ops), dev),
        "old_path_host_ms": host_ms(old_path, dev), "or_rows": wave_ops.count("or")}
    excluded = {
        "excluded": n_ex,
        "ms": time_ms(lambda: density_combine_wave(dens, rmh, wave_ops, excludes)),
        "old_path_ms": time_ms(lambda: old_path(True)),
        "host_ms": host_ms(lambda: density_combine_wave(dens, rmh, wave_ops, excludes), dev),
        "old_path_host_ms": host_ms(lambda: old_path(True), dev),
        "bound_ms": b_ex, "bound_by": by_ex}
    log(f"kernel density_combine_batch: mixed wave {mixed}; with exclusions {excluded}")
    entry(
        "density_combine_batch", 0.0,
        time_ms(lambda: density_combine_batch(dens, rmh, "and")),
        time_ms(lambda: density_combine_batch_plain(dens, rm, "and")),
        time_ms(lambda: torch.prod(torch.where(valid, dens[rmc], 1.0), dim=1)),
        wave_bytes + rm.numel() * 4, float(n_terms * lam),
        mixed=mixed, mixed_excluded=excluded,
    )

    # sharded ⊕-combine (#3): #2's kernel on one rank's λ-shard of the index,
    # at P = 4 (rank 0's slab, timed) and P = 1, with host ids as the wave
    # passes them; each op and the mix equal bit for bit to the plain version
    # and to those columns of the whole index's combine
    full = {what: density_combine_wave(dens, rmh, ops) for what, (ops, _) in cases.items()
            if what != "mixed_excluded"}
    slabs = {}
    for p in (SHARDS, 1):
        w = local_width(lam, p)
        slab = dens[:, :w].contiguous()
        for what, want in full.items():
            ops = cases[what][0]
            k_out = density_combine_wave_sharded(slab, rmh, ops)
            if not torch.equal(k_out, plain_wave(slab, ops)):
                raise AssertionError(f"density_combine_batch_sharded ({what}, P={p}) differs "
                                     "from its plain version")
            if not torch.equal(k_out, want[:, :w]):
                raise AssertionError(f"density_combine_batch_sharded ({what}, P={p}) differs "
                                     "from the whole index's combine")
        slabs[p] = slab
    w, slab = local_width(lam, SHARDS), slabs[SHARDS]
    b1, by1 = bound_ms(wave_bytes + rm.numel() * 4, float(n_terms * lam))
    p1 = {"shape": [int(dens.shape[0]), lam],
          "ms": time_ms(lambda: density_combine_batch_sharded(slabs[1], rmh, None, "and")),
          "mixed_ms": time_ms(lambda: density_combine_wave_sharded(slabs[1], rmh, wave_ops)),
          "bound_ms": b1, "bound_by": by1}
    entry(
        "density_combine_batch_sharded", 0.0,
        time_ms(lambda: density_combine_batch_sharded(slab, rmh, None, "and")),
        time_ms(lambda: density_combine_batch_plain(slab, rm, "and")),
        time_ms(lambda: torch.prod(torch.where(valid, slab[rmc], 1.0), dim=1)),
        (n_rows * w + nq * w) * 4 + rm.numel() * 4,
        float(n_terms * w),
        shape=[int(dens.shape[0]), w], shards=SHARDS, p1=p1,
        mixed_ms=time_ms(lambda: density_combine_wave_sharded(slab, rmh, wave_ops)),
    )

    # single-row θ-stats (#4): one whole bisection of query 0's row, as the
    # bisect phase launches it (3 rounds of 16 thresholds), held against the
    # plain steps (thresholds bit for bit in agreeing rounds) and timed
    # beside them and beside the step-by-step path on the one-round launch
    # it replaced; then one round alone at its first 16 thresholds
    k0 = float(queries[0].k)
    lo, hi, trace = bisect_rounds(rows[0], k0, rpb)
    plo, phi, ptrace = bisect_rounds(rows[0], k0, rpb, stats=theta_stats_plain)
    part = parting_round(trace, ptrace, k0, rpb)
    if part is None and (float(lo), float(hi)) != (float(plo), float(phi)):
        raise AssertionError("the one-launch bisection's bracket differs from the plain steps'")
    agree = trace if part is None else trace[:part]
    bis_err = max((float((rs - prs).abs().max()) for (_, rs), (_, prs) in zip(agree, ptrace)),
                  default=0.0)
    ths = trace[0][0]
    T, R = ths.numel(), len(trace)
    kc, ks = theta_stats(rows[0], ths)
    pc, ps = theta_stats_plain(rows[0], ths)
    if not torch.equal(kc, pc):
        raise AssertionError("theta_stats counts differ from the plain version")
    if not torch.allclose(ks, ps, rtol=RTOL, atol=0.0):
        raise AssertionError("theta_stats sums differ beyond rtol=1e-5")
    b1, by1 = bound_ms((lam + 3 * T) * 4, float(2 * T * lam))
    one_round = {"T": T, "ms": time_ms(lambda: theta_stats(rows[0], ths)),
                 "plain_ms": time_ms(lambda: theta_stats_plain(rows[0], ths)),
                 "max_abs_err": float((ks - ps).abs().max()), "bound_ms": b1, "bound_by": by1}
    steps = {"ms": time_ms(lambda: bisect_rounds(rows[0], k0, rpb, stats=theta_stats)),
             "host_ms": host_ms(lambda: bisect_rounds(rows[0], k0, rpb, stats=theta_stats), dev)}
    log(f"kernel theta_stats: one round {one_round}; the step-by-step bisection {steps}; "
        f"rounds parted at {part}")
    entry(
        "theta_stats", bis_err,
        time_ms(lambda: bisect_rounds(rows[0], k0, rpb)),
        time_ms(lambda: bisect_rounds(rows[0], k0, rpb, stats=theta_stats_plain)),
        None, (lam + 2 * R * T + 2) * 4, float(2 * R * T * lam),
        rounds=R, fanout=T, parted_at=part, one_round=one_round, steps_path=steps,
        host_ms=host_ms(lambda: bisect_rounds(rows[0], k0, rpb), dev),
    )

    # batched θ-stats (#5): the wave round (T = 1) on round 0's rows as the
    # device wave runs it (θ from the cut, then theta_count and expected);
    # eight given thresholds θ, 2θ, ..., 8θ (what the round took before);
    # one round of the sharded bisection (T = 16) on the P = 1 slab (the
    # sharded phase's) and rank 0's P = 4 slab, from round 0's carry: each
    # held against its plain version (θ, carries and counts exact, sums
    # within rtol)
    needs = torch.tensor([float(q.k) for q in queries], device=dev)
    plan = plan_wave_from_combined(rows, torch.zeros_like(rows, dtype=torch.bool), needs, rpb)
    if not bool((plan.theta_count >= plan.n_sel.float()).all()):
        raise AssertionError("θ invariant broken: fewer blocks clear θ than the prefix holds")
    sd, n_sel = threshold_sort_batch(rows)[1], plan.n_sel
    kw, pw = theta_wave(rows, sd, n_sel, rpb), theta_wave_plain(rows, sd, n_sel, rpb)
    if not (torch.equal(kw[0], pw[0]) and torch.equal(kw[1], pw[1])):
        raise AssertionError("theta_wave's θ or counts differ from the plain version")
    if not torch.allclose(kw[2], pw[2], rtol=RTOL, atol=0.0):
        raise AssertionError("theta_wave's expected records differ beyond rtol=1e-5")
    wave_err = float((kw[2] - pw[2]).abs().max())
    mult = torch.arange(1, 9, dtype=torch.float32, device=dev)
    thetas = (plan.theta[:, None] * mult).contiguous()
    kc, ks = theta_stats_batch(rows, thetas)
    pc, ps = theta_stats_batch_plain(rows, thetas)
    if not torch.equal(kc, pc):
        raise AssertionError("theta_stats_batch counts differ from the plain version")
    if not torch.allclose(ks, ps, rtol=RTOL, atol=0.0):
        raise AssertionError("theta_stats_batch sums differ beyond rtol=1e-5")
    b8, by8 = bound_ms((nq * lam + 3 * nq * 8) * 4, float(2 * nq * 8 * lam))
    given = {"T": 8, "ms": time_ms(lambda: theta_stats_batch(rows, thetas)),
             "plain_ms": time_ms(lambda: theta_stats_batch_plain(rows, thetas)),
             "max_abs_err": float((ks - ps).abs().max()), "bound_ms": b8, "bound_by": by8}

    def clone(c):
        return BisectCarry(*(t.clone() for t in c))

    TB = BISECT_FANOUT
    bis = {}
    for p in (1, SHARDS):
        x = rows[:, :local_width(lam, p)].contiguous()
        c0 = bisect_round_batch(x, needs, rpb, bisect_carry(nq, TB, dev), first=True)
        p0 = bisect_round_batch_plain(x, needs, rpb, c0, first=True)
        c1 = bisect_round_batch(x, needs, rpb, clone(c0), first=False)
        p1_ = bisect_round_batch_plain(x, needs, rpb, clone(c0), first=False)
        for r, (kc_, pc_) in enumerate(((c0, p0), (c1, p1_))):
            if not all(torch.equal(a_, b_) for a_, b_ in zip(kc_[:4], pc_[:4])):
                raise AssertionError(f"bisect_round_batch (P={p}, round {r}): the carry "
                                     "differs from the plain version's")
            if not torch.equal(kc_.stats[:, :TB], pc_.stats[:, :TB]):
                raise AssertionError(f"bisect_round_batch (P={p}, round {r}): counts differ")
            if not torch.allclose(kc_.stats[:, TB:], pc_.stats[:, TB:], rtol=RTOL, atol=0.0):
                raise AssertionError(f"bisect_round_batch (P={p}, round {r}): sums differ "
                                     "beyond rtol=1e-5")
        scratch = clone(c0)
        wl = x.shape[1]
        bb, byb = bound_ms((nq * wl + 4 * nq * TB + 9 * nq) * 4, float(2 * TB * nq * wl))
        bis[p] = {"shape": [nq, wl], "T": TB,
                  "ms": time_ms(lambda: bisect_round_batch(x, needs, rpb, scratch, first=False)),
                  "plain_ms": time_ms(lambda: bisect_round_batch_plain(x, needs, rpb, c0,
                                                                       first=False)),
                  "max_abs_err": float((c1.stats - p1_.stats).abs().max()),
                  "bound_ms": bb, "bound_by": byb}
    log(f"kernel theta_stats_batch: 8 thresholds given {given}; one sharded "
        f"bisection round {bis}")
    entry(
        "theta_stats_batch", wave_err,
        time_ms(lambda: theta_wave(rows, sd, n_sel, rpb)),
        time_ms(lambda: theta_wave_plain(rows, sd, n_sel, rpb)),
        None,
        (nq * lam + 5 * nq) * 4, float(2 * nq * lam),
        T=1, given_T8=given, bisect_round=bis,
    )

    # prefix scan: bit for bit at lengths across the chunk edges and at the
    # shared-memory branch's longest row and one longer (the global-scratch
    # branch), each also as [64, n]; then the wave's round-0 sorted rows
    # [64, λ] and one of them alone, timed
    g = torch.Generator().manual_seed(0)
    edge = SMEM_MAX_N
    for n in SCAN_LENGTHS:
        x = (torch.rand(n, generator=g) ** 4).to(dev)
        if not torch.equal(prefix_sum(x), prefix_sum_plain(x)):
            raise AssertionError(f"prefix_sum differs from its plain version at n={n}")
    for shape in ((edge,), (edge + 1,), (Q, edge), (Q, edge + 1)):
        x = (torch.rand(shape, generator=g) ** 4).to(dev)
        if not torch.equal(prefix_sum(x), prefix_sum_plain(x)):
            raise AssertionError(f"prefix_sum differs from its plain version at {list(shape)}")
    sd = threshold_sort_batch(rows)[1]
    sd0 = sd[0].contiguous()
    if not torch.equal(prefix_sum(sd), prefix_sum_plain(sd)):
        raise AssertionError("prefix_sum differs from its plain version on [Q, λ]")
    if not torch.equal(prefix_sum(sd0), prefix_sum_plain(sd0)):
        raise AssertionError("prefix_sum differs from its plain version on [λ]")
    b1, by1 = bound_ms(2 * lam * 4, float(lam))
    single = {"shape": [lam], "ms": time_ms(lambda: prefix_sum(sd0)),
              "plain_ms": time_ms(lambda: prefix_sum_plain(sd0)),
              "library_ms": time_ms(lambda: torch.cumsum(sd0, dim=0)),
              "bound_ms": b1, "bound_by": by1}
    log(f"kernel prefix_sum [{lam}]: {single}")
    entry(
        "prefix_sum", 0.0,
        time_ms(lambda: prefix_sum(sd)),
        time_ms(lambda: prefix_sum_plain(sd)),
        time_ms(lambda: torch.cumsum(sd, dim=1)),
        2 * Q * lam * 4, float(Q * lam),
        shape=[Q, lam], single=single, exact_lengths=list(SCAN_LENGTHS),
        smem_edge=[edge, edge + 1],
    )

    # union gather: the wave's touched blocks from each slab; dims timed cold
    ids = torch.from_numpy(np.sort(batch.unique_blocks_fetched).astype(np.int32)).to(dev)
    for slab in (store.dims, store.measures, store.valid_rows.view(torch.int8)):
        if not torch.equal(block_gather(slab, ids), block_gather_plain(slab, ids)):
            raise AssertionError(f"block_gather differs on a {slab.dtype} slab")
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    block_bytes = store.dims[0].numel() * 4
    entry(
        "block_gather", 0.0,
        time_ms(lambda: block_gather(store.dims, ids), flush=scrub.zero_),
        time_ms(lambda: block_gather_plain(store.dims, ids), flush=scrub.zero_),
        time_ms(lambda: torch.index_select(store.dims, 0, ids.long()), flush=scrub.zero_),
        2 * ids.numel() * block_bytes + ids.numel() * 4,
        0.0,
    )
    log(f"kernel shapes: Q={Q} λ={lam} γ_max={rm_np.shape[1]} rows={n_rows} "
        f"T=1 (wave), 8 (given), {BISECT_FANOUT} (sharded bisection; single {T}) "
        f"U={ids.numel()} R={rpb} d={store.dims.shape[2]}")
    return [entries[name] for name in KERNELS if name not in LM_KERNELS]


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def lm_layer_counts(cfg) -> dict:
    """Kernel launches of one forward or prefill of ``cfg``: #8 per
    attention sublayer (global ``G``, windowed ``L``, shared ``A``), #9 per
    Mamba sublayer."""
    from repro_torch.configs.base import _full_pattern

    pat = _full_pattern(cfg)
    return {"flash_attention": sum(ch in "GLA" for ch in pat), "ssd_scan": pat.count("M")}


def check_launches(launches: dict, want: dict, what: str) -> None:
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


@contextlib.contextmanager
def count_calls(module, name: str):
    """Count the calls of ``module.name`` inside the block (``{"calls": n}``)."""
    fn, seen = getattr(module, name), {"calls": 0}

    def counted(*args, **kwargs):
        seen["calls"] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def check_close(a, b, atol: float, rtol: float, what: str, scale: str = "element") -> float:
    """``max |a − b|``; raises unless both are finite and ``|a − b| <= atol +
    rtol·|b|`` elementwise (``scale="element"``, the kernels' checks, as
    ``allclose``) or ``max |a − b| <= atol + rtol·max |b|`` (``scale=
    "tensor"``, the model's logits and caches: f32 sums in another order
    err in proportion to the magnitudes summed, not to each element)."""
    import torch

    a, b = a.float(), b.float()
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        raise AssertionError(f"{what}: non-finite values (kernel {not bool(torch.isfinite(a).all())}"
                             f", plain {not bool(torch.isfinite(b).all())})")
    if not a.numel():
        return 0.0
    err = float((a - b).abs().max())
    if scale == "tensor":
        ok = err <= atol + rtol * float(b.abs().max())
    else:
        ok = torch.allclose(a, b, atol=atol, rtol=rtol)
    if not ok:
        raise AssertionError(f"{what}: max |kernel − plain| {err} beyond atol {atol}, rtol {rtol}"
                             f" ({scale})")
    return err


def peak_gb(dev) -> float | None:
    import torch

    return torch.cuda.max_memory_allocated(dev) / 1e9 if torch.device(dev).type == "cuda" else None


def lm_forward_check(model, seq: int, seed: int, run, phase: str = "lm_forward") -> dict:
    """``model(tokens, impl="kernel")`` on ``[1, seq]`` tokens through ``run``
    (``run_phase``) as ``phase``, held against ``impl="plain"``; #8 and #9
    must launch once per attention and Mamba sublayer."""
    import torch

    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, seq))).to(dev)
    def timed(impl):
        t0 = time.perf_counter()
        out = model(tokens, impl=impl)
        sync(dev)
        return out, time.perf_counter() - t0

    with torch.inference_mode():
        logits, wall, launches = run(phase, lambda: model(tokens, impl="kernel"))
        plain, plain_wall = timed("plain")
        warm = {impl: timed(impl)[1] for impl in ("kernel", "plain")}  # cuBLAS and modules loaded
    check_launches(launches, lm_layer_counts(cfg), phase)
    if tuple(logits.shape) != (1, seq, cfg.vocab):
        raise AssertionError(f"{phase}: logits of shape {tuple(logits.shape)}")
    err = check_close(logits, plain, LM_ATOL, LM_RTOL, f"{phase} logits", "tensor")
    return {"wall_s": wall, "plain_wall_s": plain_wall, "warm_wall_s": warm, "max_abs_err": err,
            "logits_absmax": float(plain.abs().max()), "launches": launches}


def serve_prompts(cfg, traffic: dict, seed: int) -> list[np.ndarray]:
    """The launcher's request draws: a length, then its tokens, per request."""
    rng = np.random.default_rng(seed)
    lo, hi = traffic["plen"]
    return [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi)))
            for _ in range(traffic["requests"])]


def run_engine(model, traffic: dict, prompts, impl: str):
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(model.cfg, model, max_slots=traffic["slots"],
                      max_seq=traffic["max_seq"], impl=impl, device=model.device)
    for p in prompts:
        eng.submit(p, max_new_tokens=traffic["max_new"])
    return eng, eng.run_until_drained()


def compare_streams(done, plain, tol: float) -> dict:
    """Greedy tokens of the kernel run against the plain run's.  A request's
    streams may part only where the plain run's top-2 logit gap is within
    ``2·tol`` (a near-tie, counted); after that its contexts differ, so the
    rest of that request is not compared."""
    out = {"tokens_equal": 0, "near_ties": 0, "tokens": sum(len(r.out_tokens) for r in plain)}
    for rk, rp in zip(done, plain):
        for j, (a, b) in enumerate(zip(rk.out_tokens, rp.out_tokens)):
            if a == b:
                out["tokens_equal"] += 1
                continue
            if rp.top2_gap[j] > 2 * tol:
                raise AssertionError(f"request {rp.rid} token {j}: {a} vs plain {b} with a "
                                     f"top-2 gap of {rp.top2_gap[j]}")
            out["near_ties"] += 1
            break
        else:
            if len(rk.out_tokens) != len(rp.out_tokens):
                raise AssertionError(f"request {rp.rid}: streams of different lengths")
    return out


def prefill_check(model, traffic: dict, prompts) -> dict:
    """The first wave's prefill as the engine pads it, kernel against plain:
    last-token logits and every layer's cache after prefill."""
    import torch

    from repro_torch.models.decode import prefill
    from repro_torch.serving.engine import Request, pad_wave

    wave = [Request(i, np.asarray(p, np.int32)) for i, p in enumerate(prompts[:traffic["slots"]])]
    toks = torch.from_numpy(pad_wave(wave, traffic["slots"], 0)).to(model.device)
    with torch.inference_mode():
        lk, ck = prefill(model, toks, impl="kernel", max_seq=traffic["max_seq"])
        lp, cp = prefill(model, toks, impl="plain", max_seq=traffic["max_seq"])
        logits_err = check_close(lk, lp, LM_ATOL, LM_RTOL, "prefill last-token logits",
                                 "tensor")
        cache_err = {}
        for i, (a, b) in enumerate(zip(ck, cp)):
            for key in a:
                e = check_close(a[key], b[key], LM_ATOL, LM_RTOL, f"layer {i} cache {key}",
                                "tensor")
                cache_err[key] = max(cache_err.get(key, 0.0), e)
    return {"prompt_len": int(toks.shape[1]), "logits_max_abs_err": logits_err,
            "cache_max_abs_err": cache_err}


def lm_serve_check(model, traffic: dict, seed: int, run, phase: str = "lm_serve") -> dict:
    """One traffic through ``ServeEngine`` with the kernels (through ``run``
    as ``phase``) and again with ``impl="plain"``; the first wave's prefill
    compared, every layer's cache (an ``L`` layer's ring slots) included."""
    cfg = model.cfg
    prompts = serve_prompts(cfg, traffic, seed)
    pre = prefill_check(model, traffic, prompts)
    (eng, done), wall, launches = run(phase, lambda: run_engine(model, traffic, prompts,
                                                                 "kernel"))
    waves = len(eng.wave_stats)
    check_launches(launches, {k: n * waves for k, n in lm_layer_counts(cfg).items()}, phase)
    eng_p, plain = run_engine(model, traffic, prompts, "plain")
    streams = compare_streams(done, plain, LM_ATOL)
    new = sum(w["new_tokens"] for w in eng.wave_stats)
    return {"wall_s": wall, "waves": eng.wave_stats, "plain_waves": eng_p.wave_stats,
            "tokens_per_s": new / wall if wall > 0 else None, "prefill": pre,
            "streams": streams, "launches": launches}


def visible_pairs(s: int, t: int, window: int | None) -> int:
    """(query, key) pairs a causal attention with right-aligned queries
    keeps, per (batch, head): its operations scale with these."""
    qpos = np.arange(s, dtype=np.int64) + (t - s)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros_like(qpos)
    return int(np.maximum(np.minimum(qpos, t - 1) - lo + 1, 0).sum())


def fa_sweep(randn, tol: float) -> dict:
    """#8 against its plain version at every head dim of ``FA_D_SWEEP``, on
    each of ``FA_SWEEP_SHAPES``; the largest error per D."""
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    out = {}
    for d in FA_D_SWEEP:
        out[d] = 0.0
        for b, hq, hkv, s, t, w in FA_SWEEP_SHAPES:
            q, k, v = randn(b, hq, s, d), randn(b, hkv, t, d), randn(b, hkv, t, d)
            out[d] = max(out[d], check_close(
                flash_attention(q, k, v, window=w), attention_plain(q, k, v, window=w),
                tol, tol, f"flash_attention (D {d}, S {s}, T {t}, window {w})"))
    return out


def swa_attention(cfg, b: int, seq: int, randn, launches: int) -> dict:
    """#8 at a sliding-window model's prefill shapes (``cfg``'s heads and
    head dim, batch ``b``, S = T = ``seq``), windowed (its ``L`` layers)
    and global (its ``G`` layers): error against the plain version, ms of
    the kernel, the plain version and ``scaled_dot_product_attention``, and
    the bound over the pairs each keeps; bf16 held against f32 as in the
    main row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = randn(b, hq, seq, d), randn(b, hkv, seq, d), randn(b, hkv, seq, d)
    pos = torch.arange(seq, device=q.device)
    out = {"shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": seq, "T": seq, "D": d},
           "launches_per_forward": launches}
    for name, w in (("window", cfg.attn_window), ("global", None)):
        err = check_close(flash_attention(q, k, v, window=w), attention_plain(q, k, v, window=w),
                          FA_TOL, FA_TOL, f"flash_attention ({cfg.name}, {name})")
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        bf16 = check_close(
            flash_attention(qb, kb, vb, window=w),
            attention_plain(qb.float(), kb.float(), vb.float(), window=w),
            FA_BF16_ATOL, FA_BF16_RTOL, f"flash_attention ({cfg.name}, {name}, bf16)")
        del qb, kb, vb
        if w is None:
            def lib():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=hq != hkv)
        else:
            mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < w)

            def lib():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=hq != hkv)
        lib_err = float((lib() - attention_plain(q, k, v, window=w)).abs().max())
        pairs = visible_pairs(seq, seq, w)
        nbytes, ops = (2 * hq + 2 * hkv) * b * seq * d * 4, 4.0 * b * hq * d * pairs
        bms, by = bound_tf32x3_ms(nbytes, ops)
        out[name] = {
            "window": w, "visible_pairs": pairs, "max_abs_err": err, "bf16_max_abs_err": bf16,
            "library_max_abs_err": lib_err,
            "ms": time_ms(lambda: flash_attention(q, k, v, window=w)),
            "plain_ms": time_ms(lambda: attention_plain(q, k, v, window=w)),
            "library_ms": time_ms(lib), "bound_ms": bms, "bound_by": by,
            "bound_fma_ms": bound_ms(nbytes, ops)[0],
        }
        log(f"kernel flash_attention at {cfg.name} {name} {out['shape']}: {out[name]}")
    return out


def lm_kernel_rows(cfg, phase_launches: dict, seq: int, seed: int, dev,
                   swa=None, profile: bool = False) -> list[dict]:
    """#8 and #9 at the long serving wave's prefill shapes (batch 4, S = T =
    the wave's padded prompt length) against their plain versions, timed;
    #8 also at h2o-danube-3-4b's GQA sliding-window shape, in bf16 and at
    every head dim of ``FA_D_SWEEP``, and, given ``swa = (cfg, seq)``, at
    that sliding-window model's long-wave shapes (``swa_attention``); #9
    also per tensor at ``SSD_TF32X3_RTOL`` beside the plain version with
    TF32 products (on the card), with its final state (prefill's call,
    timed too), under slow decay at the wave's shape and over 64 chunks
    (output, final state and the carried state's weight), and at
    mamba2-130m's d_state 128.  ``profile``: log the kernels that
    ``scaled_dot_product_attention`` launches in f32 at #8's shape (its
    yardstick: 3xTF32 on the tensor cores, or not)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_plain, flash_attention
    from repro_torch.kernels.ssd_chunk import CHUNK, ssd_chunked, ssd_scan

    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32

    def randn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # -- #8
    b, h, d = SERVE_TRAFFIC["long"]["slots"], cfg.num_heads, cfg.head_dim
    q, k, v = (randn(b, h, seq, d) for _ in range(3))
    tol = FA_TOL
    err = check_close(flash_attention(q, k, v), attention_plain(q, k, v), tol, tol,
                      "flash_attention")
    checks = {}
    db, dhq, dhkv, ds_, dd, dw = DANUBE_ATTN
    qd, kd, vd = randn(db, dhq, ds_, dd), randn(db, dhkv, ds_, dd), randn(db, dhkv, ds_, dd)
    checks["gqa_window_danube"] = check_close(
        flash_attention(qd, kd, vd, window=dw), attention_plain(qd, kd, vd, window=dw),
        tol, tol, "flash_attention (GQA, window)")
    del qd, kd, vd
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    checks["bf16"] = check_close(
        flash_attention(qb, kb, vb), attention_plain(qb.float(), kb.float(), vb.float()),
        FA_BF16_ATOL, FA_BF16_RTOL, "flash_attention (bf16)")
    del qb, kb, vb
    checks["d_sweep"] = fa_sweep(randn, tol)
    extra = {}
    if swa is not None:
        scfg, sseq = swa
        extra[scfg.name] = swa_attention(scfg, b, sseq, randn,
                                         phase_launches["lm_forward_swa"]["flash_attention"])
    if profile:
        extra["library_kernels"] = sdpa_kernels(b, h, seq, d)
        log(f"profile: scaled_dot_product_attention (f32, [{b}, {h}, {seq}, {d}], causal) "
            f"launches {extra['library_kernels']}")
    fa = kernel_row(
        "flash_attention", phase_launches, err,
        time_ms(lambda: flash_attention(q, k, v)),
        time_ms(lambda: attention_plain(q, k, v)),
        time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        4 * b * h * seq * d * 4,  # q, k, v read and o written, f32
        4.0 * b * h * d * visible_pairs(seq, seq, None),  # QKᵀ and PV over the causal pairs
        tf32x3=True, shape={"B": b, "Hq": h, "Hkv": cfg.num_kv_heads, "S": seq, "T": seq, "D": d},
        checks=checks, **extra,
    )
    del q, k, v

    # -- #9: u, log-decays and the [B, S, ds] projections broadcast to the heads
    sc = cfg.ssm
    nh, dh, ds = cfg.n_ssm_heads, sc.head_dim, sc.d_state
    sp = -(-seq // CHUNK) * CHUNK

    def ssd_inputs(b, nh, sp, dh, ds, slow=False):
        u = randn(b, nh, sp, dh, scale=0.1)
        if slow:  # ~-1e-3 a step, as trained heads: a chunk keeps ~90% of its state
            ld = -randn(b, nh, sp).abs() * 1e-3
        else:  # dt·A with A = -1, as initialised: ~e^-25 over a chunk
            ld = -F.softplus(randn(b, nh, sp) - 2.0)
        bm = randn(b, sp, ds)[:, None].expand(b, nh, sp, ds)
        cm = randn(b, sp, ds)[:, None].expand(b, nh, sp, ds)
        return u, ld, bm, cm

    def plain(*a):
        return ssd_chunked(*a, CHUNK)

    def chunks_alone(u, ld, bm, cm):  # the state reset at every chunk boundary
        b, nh, sp, dh = u.shape

        def split(t):
            return t.reshape(b, nh * (sp // CHUNK), CHUNK, *t.shape[3:])

        return plain(split(u), split(ld), split(bm), split(cm)).reshape(u.shape)

    def held(a, b, what):
        """#9 against its plain version: within SSD_ATOL/SSD_RTOL elementwise
        and within SSD_TF32X3_RTOL of the plain version's largest value."""
        check_close(a, b, 0.0, SSD_TF32X3_RTOL, f"{what}, 3xTF32", scale="tensor")
        return check_close(a, b, SSD_ATOL, SSD_RTOL, what)

    def slow_checks(shape, what):
        """y and the final state under slow decay, against the plain
        version; the carried state must weigh (SSD_CARRY_MIN)."""
        slow = ssd_inputs(*shape, slow=True)
        y, hfin = ssd_scan(*slow, return_state=True)
        y_p, h_p = ssd_chunked(*slow, CHUNK, return_state=True)
        out = {"y": held(y, y_p, f"ssd_scan ({what})"),
               "final_state": held(hfin, h_p, f"ssd_scan ({what}, final state)")}
        out["carry_weight"] = float((chunks_alone(*slow) - y_p).abs().max())
        if not out["carry_weight"] > SSD_CARRY_MIN * SSD_ATOL:
            raise AssertionError(f"ssd_scan ({what}): the carried state moves the output by "
                                 f"only {out['carry_weight']}; the check cannot see a wrong carry")
        return out

    def rel_err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    args = ssd_inputs(b, nh, sp, dh, ds)
    y_p, h_p = ssd_chunked(*args, CHUNK, return_state=True)
    y = ssd_scan(*args)
    err = held(y, y_p, "ssd_scan")
    checks = {"rel_err": rel_err(y, y_p), "tf32_control": None}
    if dev.type == "cuda":  # the control: the plain version with TF32 products
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            y_tf32 = ssd_chunked(*args, CHUNK)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        checks["tf32_control"] = {
            "rel_err": rel_err(y_tf32, y_p), "max_abs_err": float((y_tf32 - y_p).abs().max()),
            "within_ssd_tol": bool(torch.allclose(y_tf32, y_p, atol=SSD_ATOL, rtol=SSD_RTOL))}
        log(f"kernel ssd_scan: per-tensor error {checks['rel_err']}, one TF32 product a step "
            f"{checks['tf32_control']}")
        if not checks["tf32_control"]["rel_err"] > SSD_TF32X3_RTOL:
            raise AssertionError("ssd_scan: the plain version in TF32 passes SSD_TF32X3_RTOL; "
                                 "the check cannot tell 3xTF32 from one TF32 product")
        del y_tf32
    y, hfin = ssd_scan(*args, return_state=True)  # prefill's call
    checks["final_state"] = held(hfin, h_p, "ssd_scan (final state)")
    checks["y_with_state"] = held(y, y_p, "ssd_scan (with state)")
    del y, hfin, y_p, h_p
    slow = slow_checks((b, nh, sp, dh, ds), "slow decay")
    checks["slow_decay"], checks["slow_decay_final_state"] = slow["y"], slow["final_state"]
    checks["slow_decay_carry_weight"] = slow["carry_weight"]
    checks["chunks_64_slow_decay"] = slow_checks(SSD_64_CHUNKS, "64 chunks, slow decay")
    small = ssd_inputs(*MAMBA2_130M_SSD)
    checks["mamba2_130m_ds128"] = held(ssd_scan(*small), plain(*small), "ssd_scan (ds 128)")
    del small
    phases = device_ms(lambda: ssd_scan(*args))  # the CUDA kernels of a call
    log(f"kernel ssd_scan phases (per call, torch.profiler): {phases}")
    qn = CHUNK
    per_chunk = qn * (qn + 1) * ds + qn * (qn + 1) * dh + 4 * qn * ds * dh
    ssd = kernel_row(
        "ssd_scan", phase_launches, err,
        time_ms(lambda: ssd_scan(*args)),
        time_ms(lambda: plain(*args)),
        None,
        (2 * b * nh * sp * dh + b * nh * sp + 2 * b * sp * ds) * 4,
        float(per_chunk * (sp // qn) * b * nh),
        tf32x3=True,
        shape={"B": b, "H": nh, "S": sp, "dh": dh, "ds": ds, "bc_head_stride": 0},
        checks=checks, phase_ms={k: v["ms"] for k, v in phases.items()},
        # null where the profiler saw no device kernel
        cuda_kernels_per_call=sum(v["per_call"] for v in phases.values()) if phases else None,
        state_ms=time_ms(lambda: ssd_scan(*args, return_state=True)),  # prefill's call
    )
    return [fa, ssd]


def build_lm(cfg, seed: int):
    """``cfg`` at its published widths and depth, f32 weights drawn on the
    card from ``seed``."""
    import torch

    from repro_torch.models import init_params

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    counts = {ch: model.pattern.count(ch) for ch in sorted(set(model.pattern))}
    log(f"lm: {cfg.name} {cfg.num_layers} layers {counts} (window {cfg.attn_window}), d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, {cfg.num_kv_heads} kv heads, "
        f"{n_params} parameters (param_count() {cfg.param_count()}) in f32 on the card in "
        f"{time.perf_counter() - t0:.1f} s; peak {peak_gb('cuda'):.2f} GB")
    return model


def lm_phases(model, fphase: str, sphase: str, args, phase_launches: dict) -> int:
    """The forward phase ``fphase`` and the serving phase ``sphase`` (both
    traffics) on ``model``, logged; their launches go into
    ``phase_launches``.  Returns the long wave's padded prompt length."""
    import torch

    from repro_torch.kernels import _lib

    torch.cuda.reset_peak_memory_stats()
    fwd = lm_forward_check(model, LM_FORWARD_SEQ, args.seed, run_phase, fphase)
    phase_launches[fphase] = fwd.pop("launches")
    log(f"{fphase} [1, {LM_FORWARD_SEQ}]: kernel {fwd['wall_s']} s, plain "
        f"{fwd['plain_wall_s']} s (first calls); again {fwd['warm_wall_s']} s; logits max "
        f"|kernel − plain| {fwd['max_abs_err']} "
        f"(|logits| ≤ {fwd['logits_absmax']}), peak {peak_gb('cuda'):.2f} GB")
    serve_launches = dict.fromkeys(_lib.LAUNCHES, 0)
    long_seq = 0
    for name, traffic in SERVE_TRAFFIC.items():
        torch.cuda.reset_peak_memory_stats()
        res = lm_serve_check(model, traffic, args.seed, run_phase, sphase)
        for k, n in res.pop("launches").items():
            serve_launches[k] += n
        for label, waves in (("kernel", res["waves"]), ("plain", res["plain_waves"])):
            for w in waves:
                log(f"{sphase} {name} {label} wave: {w['size']} requests, prompt_len "
                    f"{w['prompt_len']}, prefill {w['prefill_s']} s, decode "
                    f"{w['decode_s'] / max(w['decode_steps'], 1)} s/step over "
                    f"{w['decode_steps']} steps, {w['new_tokens']} tokens")
        log(f"{sphase} {name}: {res['wall_s']} s, {res['tokens_per_s']} tokens/s; prefill "
            f"check {res['prefill']}; streams {res['streams']}; peak "
            f"{peak_gb('cuda'):.2f} GB")
        if name == "long":
            long_seq = res["waves"][0]["prompt_len"]
            log(f"{sphase} {model.cfg.name} long prefill [{res['waves'][0]['size']}, "
                f"{long_seq}]: kernel {res['waves'][0]['prefill_s']} s, plain "
                f"{res['plain_waves'][0]['prefill_s']} s")
    phase_launches[sphase] = serve_launches
    log(f"{sphase} launches (both traffics): {serve_launches}")
    if args.profile:  # one warm wave of each traffic, with the kernels
        for name, traffic in SERVE_TRAFFIC.items():
            prompts = serve_prompts(model.cfg, traffic, args.seed)[:traffic["slots"]]
            profile_wave(lambda: run_engine(model, traffic, prompts, "kernel"),
                         f"{sphase} {name} wave")
    return long_seq


# ---------------------------------------------------------------------------
# Predicate trees, FORWARD-OPTIMAL, the §5 aggregate path, group-by and the
# baselines on the airline-like table.
# ---------------------------------------------------------------------------

def make_tree_wave(cards: np.ndarray, q: int, seed: int):
    """``q`` queries, every fourth a pair list (``make_wave``'s) and the rest
    Predicate trees, cycling through six shapes: ``Eq``, ``In`` of 2-4
    values, ``Range`` over month or day of week, ``Not``, and ``And`` /
    ``Or`` nested two deep; leaf values as ``make_wave`` draws them, k
    log-uniform in [100, 20000], every 8th ``threshold`` and ``two_prong``."""
    from repro_torch.core import predicates as tp
    from repro_torch.core.multi_query import BatchQuery

    rng = np.random.default_rng(seed + 1)
    span = np.minimum(np.asarray(cards), [12, 7, 12, 6, 6])
    pairs = iter(make_wave(cards, q // 4, seed + 1))

    def eq():
        a = int(rng.integers(0, len(cards)))
        return tp.Eq(a, int(rng.integers(0, span[a])))

    def isin():
        a = int(rng.integers(0, len(cards)))
        vals = rng.choice(int(span[a]), size=int(rng.integers(2, 5)), replace=False)
        return tp.In(a, tuple(sorted(int(v) for v in vals)))

    def rng_range():
        a = int(rng.integers(0, 2))  # month or day of week
        lo = int(rng.integers(0, cards[a] - 1))
        return tp.Range(a, lo, int(rng.integers(lo + 1, min(lo + 4, cards[a] - 1) + 1)))

    def leaf():
        return (eq, isin, rng_range)[int(rng.integers(0, 3))]()

    shapes = [eq, isin, rng_range, lambda: tp.Not(leaf()),
              lambda: tp.And((tp.Or((leaf(), leaf())), leaf())),
              lambda: tp.Or((tp.And((leaf(), tp.Not(leaf()))), leaf()))]
    wave = []
    for i in range(q):
        if i % 4 == 3:
            wave.append(next(pairs))
            continue
        k = int(np.exp(rng.uniform(np.log(100), np.log(20000))))
        algo = {1: "threshold", 2: "two_prong"}.get(i % 8)
        wave.append(BatchQuery(shapes[len(wave) % 6](), k, algo=algo))
    return wave


def count_in_nodes(pred) -> int:
    """``In`` nodes of a tree: each compiles with one ``density_combine``."""
    kind = type(pred).__name__
    if kind == "In":
        return 1
    if kind == "Not":
        return count_in_nodes(pred.part)
    return sum(count_in_nodes(p) for p in getattr(pred, "parts", ()))


def pick_tree_singles(queries, batch, n: int = 8) -> list[int]:
    """Wave indices for single ``any_k`` calls: the first tree of each
    algorithm, the first pair list, the first query that refilled, then the
    next trees up to ``n``."""
    trees = [i for i, q in enumerate(queries) if not isinstance(q.predicates, (list, tuple))]
    pick = [next(i for i in trees if (queries[i].algo or "auto") == a)
            for a in ("threshold", "two_prong", "auto")]
    pick.append(next(i for i, q in enumerate(queries) if isinstance(q.predicates, (list, tuple))))
    pick += [i for i, r in enumerate(batch.results) if r.plan_rounds > 1][:1]
    pick += [i for i in trees if i not in pick][: max(0, n - len(set(pick)))]
    return sorted(set(pick))


def predicates_check(table, store, cpu_store, queries, run, device: str = "cuda") -> dict:
    """The tree wave through the device wave, the host mirror and single
    ``any_k`` calls on ``device`` (each path counted as one ``run`` phase),
    every record re-checked on the host table, each loop equal to the others
    and to the device wave run by the port on the CPU."""
    from repro_torch.core import multi_query
    from repro_torch.core.engine import NeedleTailEngine

    n_in = sum(count_in_nodes(q.predicates) for q in queries
               if not isinstance(q.predicates, (list, tuple)))
    eng = NeedleTailEngine(store, device=device)
    batch, wall, launches = run("predicates", lambda: eng.any_k_batch(queries, device=True))
    if device == "cuda":  # the plain versions launch nothing
        # one combine of the pair lists, one #1 a compiled In node, one θ-round a round
        check_launches(launches, {"density_combine_batch": 1, "density_combine": n_in,
                                  "theta_stats_batch": batch.device_transfers}, "predicates")
    reasons = check_records(table, store, queries, batch, eng.max_refills)
    host_eng = NeedleTailEngine(store, device=device)
    with count_calls(multi_query, "combine_densities_wave") as combines:
        host, host_wall, host_launches = run(
            "predicates_host", lambda: host_eng.any_k_batch(queries, device=False))
    if device == "cuda":
        check_launches(host_launches, {"density_combine_batch": combines["calls"]},
                       "predicates host mirror")
    compare_waves(batch, host)
    if (host.rounds, host.store_blocks_fetched, host.cache_hits) != \
            (batch.rounds, batch.store_blocks_fetched, batch.cache_hits) or \
            not np.array_equal(host.unique_blocks_fetched, batch.unique_blocks_fetched):
        raise AssertionError("the tree wave's host mirror differs from its device wave")
    pick = pick_tree_singles(queries, batch)
    single_eng = NeedleTailEngine(store, device=device)
    times = []

    def singles_fn():
        out = []
        for i in pick:
            q = queries[i]
            t0 = time.perf_counter()
            out.append(single_eng.any_k(q.predicates, q.k, q.op, q.algo or "auto"))
            sync(device)
            times.append(time.perf_counter() - t0)
        return out

    singles, single_wall, single_launches = run("predicates_single", singles_fn)
    for i, r in zip(pick, singles):
        compare_results(r, batch.results[i], f"tree wave any_k of query {i}")
    t0 = time.perf_counter()
    cpu = NeedleTailEngine(cpu_store, device="cpu").any_k_batch(queries, device=True)
    cpu_wall = time.perf_counter() - t0
    compare_waves(batch, cpu)
    return {"walls": {"device_wave": wall, "host_mirror": host_wall, "single": single_wall,
                      "cpu_device_wave": cpu_wall},
            "single_s": times, "picked": pick, "rounds": batch.rounds,
            "transfers": batch.device_transfers,
            "unique_blocks": int(batch.unique_blocks_fetched.size),
            "records": sum(r.num_records for r in batch.results), "short_of_k": reasons,
            "in_nodes": n_in, "launches": {"predicates": launches, "predicates_host": host_launches,
                                           "predicates_single": single_launches}}


FO_BENCH = dict(num_records=50_000, num_dims=4, density=0.2, seed=7)  # bench_forward_optimal
FO_RPB, FO_K, FO_SCAN_K = 64, 100, 1000


def forward_optimal_check(row, run, device: str = "cuda") -> dict:
    """FORWARD-OPTIMAL: the scan DP over the ``[λ]`` combined ``row`` at
    k = 1,000 under ``hdd``, on ``device`` and on the CPU (``opt_table`` bit
    for bit); then, at the reference bench's scale (λ = 782, k = 100), the
    faithful host DP on the card's combined row and ``any_k(algo=
    "forward_optimal")``, each equal to the CPU run's, and the DP's cost
    against the scan's Opt(k)."""
    from repro_torch.core.cost_model import make_cost_model
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.forward_optimal import forward_optimal_faithful, forward_optimal_scan
    from repro_torch.data.block_store import build_block_store
    from repro_torch.data.synthetic import make_clustered_table

    cm = make_cost_model("hdd")
    bench = make_clustered_table(**FO_BENCH)
    small = build_block_store(bench, FO_RPB, device=device)
    preds = [(0, 1)]
    walls = {}

    def card():
        t0 = time.perf_counter()
        scan = forward_optimal_scan(row, FO_SCAN_K, RPB, cm)
        sync(device)
        walls["scan_full"] = time.perf_counter() - t0
        eng = NeedleTailEngine(small, cost_model=cm, device=device)
        comb = eng.combined_density(preds)
        t0 = time.perf_counter()
        dp = forward_optimal_faithful(comb, FO_K, FO_RPB, cm)
        walls["faithful_dp"] = time.perf_counter() - t0
        small_scan = forward_optimal_scan(comb, FO_K, FO_RPB, cm)
        t0 = time.perf_counter()
        r = eng.any_k(preds, FO_K, algo="forward_optimal")
        walls["any_k"] = time.perf_counter() - t0
        return scan, dp, float(small_scan.opt_cost), r

    (scan, dp, small_opt, r), wall, launches = run("forward_optimal", card)
    t0 = time.perf_counter()
    cpu_scan = forward_optimal_scan(row.cpu(), FO_SCAN_K, RPB, cm)
    walls["scan_full_cpu"] = time.perf_counter() - t0
    assert_same(scan.opt_table.cpu().numpy(), cpu_scan.opt_table.numpy(), "the scan's opt_table")
    cpu_small = small.to("cpu")
    cpu_eng = NeedleTailEngine(cpu_small, cost_model=cm, device="cpu")
    if forward_optimal_faithful(cpu_eng.combined_density(preds), FO_K, FO_RPB, cm) != dp:
        raise AssertionError("the faithful DP differs from the CPU run's")
    compare_results(r, cpu_eng.any_k(preds, FO_K, algo="forward_optimal"), "any_k forward_optimal")
    if not np.isclose(dp[1], small_opt, rtol=1e-4, atol=0.0):
        raise AssertionError(f"the DP's cost {dp[1]} is not the scan's Opt(k) {small_opt}")
    valid = bench.valid_mask(preds)
    idx = r.record_block * FO_RPB + r.record_row
    if not valid[idx].all() or r.num_records < FO_K:
        raise AssertionError("any_k forward_optimal returned a non-matching record or < k")
    return {"walls": walls, "wall": wall, "lam_full": int(row.shape[0]),
            "opt_cost_full": float(scan.opt_cost), "lam_bench": small.num_blocks,
            "dp_blocks": len(dp[0]), "dp_cost": dp[1], "scan_opt_k": small_opt,
            "any_k": {"blocks": int(r.blocks_fetched.size), "records": r.num_records,
                      "rounds": r.plan_rounds, "modeled_io_s": r.modeled_io_s},
            "launches": launches}


AGG_K, AGG_ALPHA, AGG_SLO, AGG_CHUNK, AGG_ROUNDS = 20_000, 0.1, 0.01, 8, 64


def offline_estimate(engine, query, plan, population_size):
    """``NeedleTailEngine.aggregate``'s extraction and estimator, one-shot on
    an explicit design: what the online fold's last estimate must equal."""
    from repro_torch.core import estimators as est
    from repro_torch.core.engine import block_partials

    blocks = np.sort(plan.blocks)
    bd, bm, bv = engine.block_cache.get_many(engine.store, blocks)
    tau, n = block_partials(engine._mask(bd, query.predicates, query.op) & bv,
                            bm[..., query.measure])
    in_sc = np.isin(blocks, plan.sc)
    fn = est.horvitz_thompson if query.estimator == "ht" else est.ratio_estimator
    return fn(tau[in_sc], tau[~in_sc], n[in_sc], n[~in_sc], plan, population_size)


def estimate_dict(e) -> dict:
    return {"total": e.total, "mean": e.mean, "ci95": e.ci_halfwidth(), "var_mean": e.var_mean,
            "samples": e.num_samples}


def aggregate_check(store, cpu_store, cases, run, seed: int, device: str = "cuda") -> dict:
    """``engine.aggregate`` for each ``(label, predicates)`` case (measure
    0, both estimators), then ``run_online_aggregate`` to an error SLO of 1%
    of the offline mean, on ``device``; the fold's last estimate ``==`` the
    offline estimator on its fetched set; blocks equal the CPU run's and
    estimates within ``RTOL``; the true mean exact in f64 on ``device``."""
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.online_agg import AggregateQuery, run_online_aggregate

    out = {}
    eng = NeedleTailEngine(store, device=device)

    def card():
        res = {}
        for label, preds in cases:
            for estimator in ("ht", "ratio"):
                t0 = time.perf_counter()
                e, qr, plan = eng.aggregate(preds, 0, AGG_K, AGG_ALPHA, estimator=estimator,
                                            seed=seed)
                res[label, estimator] = (e, qr, plan, time.perf_counter() - t0)
            q = AggregateQuery(preds, 0, AGG_K, AGG_ALPHA, seed=seed)
            slo = AGG_SLO * abs(res[label, "ratio"][0].mean)
            t0 = time.perf_counter()
            online = run_online_aggregate(eng, q, error_slo=slo, chunk_blocks=AGG_CHUNK,
                                          max_rounds=AGG_ROUNDS)
            res[label, "online"] = (q, slo, online, time.perf_counter() - t0)
        return res

    res, wall, launches = run("aggregate", card)
    cpu = NeedleTailEngine(cpu_store, device="cpu")
    for label, preds in cases:
        for estimator in ("ht", "ratio"):
            e, qr, plan, t = res[label, estimator]
            ce, cqr, _ = cpu.aggregate(preds, 0, AGG_K, AGG_ALPHA, estimator=estimator, seed=seed)
            assert_same(qr.blocks_fetched, cqr.blocks_fetched, f"aggregate {label} blocks")
            for f in ("total", "mean", "var_total", "var_mean"):
                if not np.isclose(getattr(e, f), getattr(ce, f), rtol=RTOL, atol=0.0):
                    raise AssertionError(f"aggregate {label} {estimator} {f} differs from the CPU")
            out[f"{label} {estimator}"] = {**estimate_dict(e), "blocks": int(qr.blocks_fetched.size),
                                           "wall_s": t, "bit_equal_cpu": e == ce}
        q, slo, online, t = res[label, "online"]
        if online.estimate != offline_estimate(eng, q, online.plan, online.population_size):
            raise AssertionError(f"online {label}: the fold differs from the offline estimator")
        conline = run_online_aggregate(cpu, q, error_slo=slo, chunk_blocks=AGG_CHUNK,
                                       max_rounds=AGG_ROUNDS)
        if (online.reason, online.rounds, online.blocks_fetched) != \
                (conline.reason, conline.rounds, conline.blocks_fetched):
            raise AssertionError(f"online {label}: rounds or blocks differ from the CPU run's")
        if not np.isclose(online.estimate.mean, conline.estimate.mean, rtol=RTOL, atol=0.0):
            raise AssertionError(f"online {label}: estimate differs from the CPU run's")
        out[f"{label} online"] = {**estimate_dict(online.estimate), "slo": slo,
                                  "reason": online.reason, "rounds": online.rounds,
                                  "blocks": online.blocks_fetched, "wall_s": t}
        # the true mean over every matching record, exact in f64 on the card
        mask = eng._mask(store.dims, preds) & store.valid_rows
        out[f"{label} true"] = {
            "mean": float(store.measures[..., 0].double()[mask].sum() / mask.sum()),
            "records": int(mask.sum())}
        del mask
        sync(device)
    out["wall"], out["launches"] = wall, launches
    return out


GROUPBY = dict(predicates=[(3, 0)], group_attr=2, k=1000, psi=8, measure=0)  # carrier


def groupby_check(table, store, cpu_store, run, device: str = "cuda") -> dict:
    """``groupby_any_k`` over the 12 carriers of origin 0's flights on
    ``device``: counts, blocks, records and snapshots equal the CPU run's,
    every record matches on the host table."""
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.groupby import groupby_any_k

    eng = NeedleTailEngine(store, device=device)
    g, wall, launches = run("groupby", lambda: groupby_any_k(eng, **GROUPBY))
    t0 = time.perf_counter()
    c = groupby_any_k(NeedleTailEngine(cpu_store, device="cpu"), **GROUPBY)
    cpu_wall = time.perf_counter() - t0
    for f in ("per_group_counts", "blocks_fetched", "record_block", "record_row", "record_group"):
        assert_same(getattr(g, f), getattr(c, f), f"groupby {f}")
    for snap, csnap in zip(g.estimate_stream, c.estimate_stream):
        for grp in snap:
            if not np.isclose(snap[grp].mean, csnap[grp].mean, rtol=RTOL, atol=0.0):
                raise AssertionError(f"groupby snapshot of group {grp} differs from the CPU")
    idx = g.record_block * store.records_per_block + g.record_row
    a, v = GROUPBY["predicates"][0]
    if not ((table.dims[idx, a] == v).all()
            and (table.dims[idx, GROUPBY["group_attr"]] == g.record_group).all()):
        raise AssertionError("groupby returned a record outside its predicate or group")
    if (g.per_group_counts != GROUPBY["k"]).any():
        raise AssertionError(f"groupby counts {g.per_group_counts} short of k")
    return {"wall": wall, "cpu_wall": cpu_wall, "rounds": g.rounds,
            "blocks": int(g.blocks_fetched.size), "counts": g.per_group_counts.tolist(),
            "ci95": {int(k): v.ci_halfwidth() for k, v in g.group_estimates.items()},
            "launches": launches}


def first_k_truth(table, q, k: int, chunk: int = 1 << 22) -> np.ndarray:
    """The first k matching records of the host table, a stretch at a time."""
    out, got = [], 0
    for lo in range(0, table.num_records, chunk):
        hit = np.flatnonzero(query_mask(q, table.dims[lo:lo + chunk]))[: k - got] + lo
        out.append(hit)
        got += hit.size
        if got >= k:
            break
    return np.concatenate(out)


def baselines_check(table, store, cpu_store, queries, run, device: str = "cuda") -> dict:
    """Bitmap, lossy-bitmap and EWAH indexes of the whole table built on
    ``device`` and by the port on the CPU, word for word equal; BITMAP-SCAN,
    EWAH-SCAN and DISK-SCAN of the pair ``queries`` on both, first-k ids
    equal to the host table's truth; Table 2's bytes.  Returns the summary
    and the ``device`` indexes (the caller frees them)."""
    import torch

    from repro_torch.core import baselines as tb

    def build(st, dev):
        dims = st.dims.view(-1, st.dims.shape[-1])[:st.num_records]
        t0 = time.perf_counter()
        bm = tb.build_bitmap_index(dims, table.cards, device=dev)
        sync(dev)
        t1 = time.perf_counter()
        ew = tb.build_ewah_index(bm)
        sync(dev)
        t2 = time.perf_counter()
        lossy = tb.build_lossy_bitmap(st.index.densities, st.index.vocab.attr_offsets)
        return bm, ew, lossy, {"bitmap_s": t1 - t0, "ewah_s": t2 - t1}

    def scans(st, bm, ew):
        out, t = [], {"bitmap": 0.0, "ewah": 0.0, "disk": 0.0}
        for q in queries:
            t0 = time.perf_counter()
            b = tb.bitmap_scan(bm, q.predicates, q.k, RPB, q.op)
            t1 = time.perf_counter()
            e = tb.ewah_scan(ew, q.predicates, q.k, RPB, q.op)
            t2 = time.perf_counter()
            valid = (st.predicate_mask(st.dims, q.predicates, q.op) & st.valid_rows).view(-1)
            d = tb.disk_scan(valid, q.k, RPB)
            t3 = time.perf_counter()
            t["bitmap"] += t1 - t0
            t["ewah"] += t2 - t1
            t["disk"] += t3 - t2
            out.append((b, e, d))
        return out, t

    def card():
        bm, ew, lossy, tbuild = build(store, device)
        res, tscan = scans(store, bm, ew)
        return bm, ew, lossy, res, {**tbuild, **tscan}

    (bm, ew, lossy, res, walls), wall, launches = run("baselines", card)
    cbm, cew, clossy, cwalls = build(cpu_store, "cpu")
    if not torch.equal(bm.bits.cpu(), cbm.bits):
        raise AssertionError("bitmap words differ from the CPU build's")
    if not torch.equal(lossy.bits.cpu(), clossy.bits):
        raise AssertionError("lossy-bitmap words differ from the CPU build's")
    for r, (a, b) in enumerate(zip(ew.streams, cew.streams)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"EWAH stream of row {r} differs from the CPU build's")
    cres, ctscan = scans(cpu_store, cbm, cew)
    for q, got, want in zip(queries, res, cres):
        truth = first_k_truth(table, q, q.k)
        for name, (recs, blocks), (crecs, cblocks) in zip(("bitmap", "ewah", "disk"), got, want):
            assert_same(recs, crecs, f"{name} scan records vs the CPU")
            assert_same(blocks, cblocks, f"{name} scan blocks vs the CPU")
            assert_same(recs, truth, f"{name} scan records vs the table")
    nbytes = {"data": store.data_nbytes(), "density_maps": store.index.nbytes_maps_only(),
              "density_maps_with_sorted": store.index.nbytes(), "bitmap": bm.nbytes(),
              "ewah": ew.nbytes(), "lossy_bitmap": lossy.nbytes()}
    return {"wall": wall, "walls": walls, "cpu_walls": {**cwalls, **ctscan}, "nbytes": nbytes,
            "queries": len(queries), "launches": launches}, (bm, ew, lossy)


TIER_HBM_BYTES = 256 << 20  # ~993 blocks of the 10⁸ table: the Q = 64 union does not fit
RECENCY_TIERS = (128 << 20, 256 << 20)  # 384 MiB in all: the union must drop blocks
APPEND_ROWS = 1_000_000
PREFETCH_MAX_BLOCKS = 1 << 16  # no cap: the whole predicted round 0
# reads a timed call, so one block's share stands out of the jitter; at most
# 25 runs × 4 reads × 6 copies stay inside the card's launch queue, so the
# host never waits to enqueue and the events time the card alone
CALIBRATION_REPS = 4


def tier_state(stack) -> dict:
    """Per-tier counters and resident ids (LRU order) of a tier stack."""
    return {"counters": stack.tier_counters(), "snapshot": stack.snapshot(),
            "resident": [list(t.block_ids()) for t in stack.tiers]}


def wave_counts(b) -> tuple:
    return (b.rounds, b.store_blocks_fetched, b.cache_hits,
            tuple(int(x) for x in b.unique_blocks_fetched))


def tiered_check(store, cpu_store, queries, flat, flat_walls: dict, run, device: str = "cuda",
                 hbm_bytes: int = TIER_HBM_BYTES, recency: tuple = RECENCY_TIERS) -> dict:
    """The wave on a tier stack (``hbm_bytes`` on the card over unbounded
    pinned host memory, ``CostAwarePolicy``), cold then warm, equal to the
    flat engine's wave ``flat`` in records, blocks and counts; the warm wave
    reads no store block and drops none.  Then ``RecencyPolicy`` over
    ``recency`` budgets: demotions cascade and, the union exceeding both
    budgets, blocks drop; results unchanged.  The same calls on the CPU copy
    give the same counters, and ``get_device`` of the union the store's
    bytes."""
    import torch

    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.storage import CostAwarePolicy, RecencyPolicy, TierStack, make_tier_stack

    nb = TierStack.block_nbytes(store)

    def waves(st, on_store, dev):
        eng = NeedleTailEngine(on_store, tiers=st, device=dev)
        out = []
        for _ in range(2):
            t0 = time.perf_counter()
            out.append(eng.any_k_batch(queries, device=True))
            sync(dev)
            out.append(time.perf_counter() - t0)
        return eng, *out

    def sequence(on_store, dev):
        # device_fill as on the card: two store reads a miss batch on the CPU too
        cost = make_tier_stack(hbm_bytes, None, policy=CostAwarePolicy(), device_fill=True,
                               device=dev)
        rec = make_tier_stack(*recency, policy=RecencyPolicy(), device_fill=True, device=dev)
        return (cost, waves(cost, on_store, dev)), (rec, waves(rec, on_store, dev))

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ((stack, (eng, cold, cold_s, warm, warm_s)),
     (rstack, (_, rcold, rcold_s, rwarm, rwarm_s))), wall, launches = run(
        "tiered", lambda: sequence(store, device))
    peak = peak_gb(device)
    for b in (cold, warm, rcold, rwarm):
        compare_waves(flat, b)
    if wave_counts(cold) != wave_counts(flat):
        raise AssertionError("the cold tiered wave's rounds, blocks or counts differ from the "
                             "flat wave's")
    if (warm.rounds, warm.store_blocks_fetched, stack.stats.evictions) != (flat.rounds, 0, 0):
        raise AssertionError(f"warm tiered wave: {warm.store_blocks_fetched} store blocks read, "
                             f"{stack.stats.evictions} evictions")
    tc = rstack.tier_counters()
    union = int(flat.unique_blocks_fetched.size)
    if not tc["hbm.demotions_out"] > 0 or \
            tc["hbm.demotions_out"] != tc["dram.demotions_in"] + tc["hbm.evictions"]:
        raise AssertionError(f"recency demotions do not cascade: {tc}")
    if union * nb > sum(recency) and rstack.stats.evictions == 0:
        raise AssertionError("the union exceeds the recency budgets, yet nothing dropped")
    t0 = time.perf_counter()
    (cstack, (_, ccold, _, cwarm, _)), (crstack, _) = sequence(cpu_store, "cpu")
    cpu_wall = time.perf_counter() - t0
    compare_waves(ccold, cold)
    compare_waves(cwarm, warm)
    for mine, cpu in ((stack, cstack), (rstack, crstack)):
        a, b = tier_state(mine), tier_state(cpu)
        if a != b:
            diff = {k: (a[k], b[k]) for k in ("counters", "snapshot") if a[k] != b[k]}
            raise AssertionError(f"the card's tier counters differ from the CPU run's: {diff}, "
                                 f"residents equal: {a['resident'] == b['resident']}")
    ids = np.sort(flat.unique_blocks_fetched)
    got, want = stack.get_device(store, ids), store.fetch(ids)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("get_device of the union differs from store.fetch")
    return {"engine": eng, "stack": stack, "launches": launches, "wall": wall,
            "walls": {"flat_cold": flat_walls["cold"], "flat_warm": flat_walls["warm"],
                      "tiered_cold": cold_s, "tiered_warm": warm_s, "recency_cold": rcold_s,
                      "recency_warm": rwarm_s, "cpu_sequence": cpu_wall},
            "union_blocks": union, "block_bytes": nb,
            "tier_blocks": [len(t) for t in stack.tiers],
            "tier_stats": {"cold": cold.tier_stats, "warm": warm.tier_stats},
            "recency": {"counters": tc, "evictions": rstack.stats.evictions,
                        "warm_store_blocks": rwarm.store_blocks_fetched},
            "peak_gb": peak}


class PoolTimer:
    """Timing adapter of tier 0: ``block_gather`` of slots of a tier's pool
    on the card (one launch per tensor), timed by CUDA events over
    ``CALIBRATION_REPS`` reads, per read."""

    def __init__(self, pool):
        self.pool = pool
        self.max_block_id = int(pool[0].shape[0]) - 1
        self.calls = 0

    def levels(self):
        return {"hbm"}

    def io_seconds(self, level: str, block_ids) -> float:
        import torch

        from repro_torch.kernels.plan_wave import block_gather

        ids = np.clip(np.asarray(list(block_ids), np.int64), 0, self.max_block_id)
        ids_t = torch.from_numpy(ids.astype(np.int32)).to(self.pool[0].device)
        d, m, v = self.pool
        def reads():
            for _ in range(CALIBRATION_REPS):
                block_gather(d, ids_t), block_gather(m, ids_t)
                block_gather(v.view(torch.int8), ids_t)

        self.calls += 1
        return time_ms(reads) / 1e3 / CALIBRATION_REPS


class PinnedTimer:
    """Timing adapter of tier 1: a copy from a pinned host pool to the card,
    one ``non_blocking`` copy per tensor per contiguous run of slots,
    timed by CUDA events over ``CALIBRATION_REPS`` copies, per copy."""

    def __init__(self, pool, device):
        self.pool, self.device = pool, device
        self.max_block_id = int(pool[0].shape[0]) - 1
        self.calls = 0

    def levels(self):
        return {"dram"}

    def io_seconds(self, level: str, block_ids) -> float:
        import torch

        ids = np.unique(np.clip(np.asarray(list(block_ids), np.int64), 0, self.max_block_id))
        cuts = np.flatnonzero(np.diff(ids) != 1) + 1
        runs = [(int(r[0]), int(r[-1]) + 1) for r in np.split(ids, cuts)]
        dst = [torch.empty((ids.size, *p.shape[1:]), dtype=p.dtype, device=self.device)
               for p in self.pool]

        def copies():
            for _ in range(CALIBRATION_REPS):
                off = 0
                for a, b in runs:
                    for p, o in zip(self.pool, dst):
                        o[off:off + b - a].copy_(p[a:b], non_blocking=True)
                    off += b - a

        self.calls += 1
        return time_ms(copies) / 1e3 / CALIBRATION_REPS


def calibration_check(store, stack, queries, run, device: str = "cuda",
                      hbm_bytes: int = TIER_HBM_BYTES) -> dict:
    """Fit the ``hbm`` level on the tier-0 pool (:class:`PoolTimer`), the
    ``dram`` level on the pinned pool of tier 1 (:class:`PinnedTimer`) and
    the backing level through ``StoreTimingBackend`` on the card, each with
    ``calibrate_model``; print the fits and the bandwidth and latency they
    give (``seq = block_bytes / BW``, ``far = seq + latency``).  Then an
    engine with ``calibrated_cost=True`` and a ``PlanLedger``: its wave
    equals a flat engine's given the same fitted model."""
    from repro_torch.core.cost_model import make_cost_model
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.plan_ledger import PlanLedger
    from repro_torch.storage import StoreTimingBackend, TierStack, calibrate_model, make_tier_stack

    nb = TierStack.block_nbytes(store)

    def card():
        fits = {"hbm": calibrate_model(PoolTimer(stack.tiers[0]._pool), "hbm",
                                       base=make_cost_model("hbm", nb)),
                "dram": calibrate_model(PinnedTimer(stack.tiers[1]._pool, store.device), "dram",
                                        base=make_cost_model("dram", nb)),
                "hdd": calibrate_model(StoreTimingBackend(store), "hdd",
                                       base=make_cost_model("hdd"))}
        eng = NeedleTailEngine(store, tiers=make_tier_stack(hbm_bytes, None, device=device),
                               calibrated_cost=True, ledger=PlanLedger(), device=device)
        t0 = time.perf_counter()
        batch = eng.any_k_batch(queries, device=True)
        sync(device)
        return fits, eng, batch, time.perf_counter() - t0

    (fits, eng, batch, wave_s), wall, launches = run("calibration", card)
    flat = NeedleTailEngine(store, cost_model=eng.cost, device=device).any_k_batch(queries)
    compare_waves(flat, batch)
    if (batch.rounds, tuple(batch.unique_blocks_fetched)) != \
            (flat.rounds, tuple(flat.unique_blocks_fetched)):
        raise AssertionError("the calibrated wave's rounds or blocks differ from the flat wave's")
    levels = {}
    for lv, cm in fits.items():
        levels[lv] = {"seq_s": cm.seq_cost, "max_dist": cm.max_dist, "far_s": cm.far_cost,
                      "kappa_s": cm.first_block_cost, "bytes_per_s": nb / cm.seq_cost,
                      "latency_s": max(cm.far_cost - cm.seq_cost, 0.0)}
    engine_fit = {"seq_s": eng.cost.seq_cost, "max_dist": eng.cost.max_dist,
                  "far_s": eng.cost.far_cost, "kappa_s": eng.cost.first_block_cost}
    qerrors = {f"{site}/{tier}": {"qerror": st.qerror, "max": st.max_qerror, "count": st.count}
               for (site, tier), st in eng.ledger.sites.items()}
    return {"levels": levels, "engine_hdd_fit": engine_fit, "qerrors": qerrors,
            "block_bytes": nb, "wave_s": wave_s, "wall": wall, "launches": launches}


def append_compact_check(table, store, cpu_store, eng, stack, queries, run, seed: int,
                         device: str = "cuda", rows: int = APPEND_ROWS) -> dict:
    """On the tiered engine ``eng`` (holding the wave's blocks), append
    ``rows`` records of ``make_real_like_table("airline", seed=seed + 1)``,
    then compact the tail from the first dirtied block; after each, exactly
    the dirtied blocks left every tier, the store (slabs and index) equals
    ``build_block_store`` of the same table bit for bit, and the next wave
    equals a fresh flat engine's on it.  Append and compaction are timed on
    the card and on the CPU copy."""
    import torch

    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.data.append import append_records, dirtied_block_ids
    from repro_torch.data.block_store import Table, build_block_store
    from repro_torch.data.synthetic import make_real_like_table
    from repro_torch.storage import compact_tail

    extra = make_real_like_table("airline", num_records=rows, seed=seed + 1)
    new = Table(extra.dims, extra.measures, table.cards)
    dims = np.concatenate([table.dims, new.dims])
    meas = np.concatenate([table.measures, new.measures])

    def resident() -> set:
        return {int(b) for t in stack.tiers for b in t.block_ids()}

    def rewrite(fn):
        """``fn``'s store, its seconds, the residents before and after it,
        the copies it evicted, then the next wave and its seconds."""
        held, inv0 = resident(), stack.stats.invalidations
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        secs = time.perf_counter() - t0
        left, evicted = resident(), stack.stats.invalidations - inv0
        t0 = time.perf_counter()
        wave = eng.any_k_batch(queries, device=True)
        sync(device)
        return out, secs, held, left, evicted, wave, time.perf_counter() - t0

    tail = store.num_records // store.records_per_block  # the first dirtied block
    stack.ensure(eng.store, [store.num_blocks - 1])  # the partial tail block resident too
    if not np.array_equal(dirtied_block_ids(store, rows),
                          np.arange(tail, -(-(store.num_records + rows) // RPB))):
        raise AssertionError("dirtied_block_ids is not the tail from the partial block on")
    (grown, compacted), wall, launches = run(
        "append_compact", lambda: (rewrite(lambda: eng.append(new)),
                                   rewrite(lambda: eng.compact(tail))))
    out = {"wall": wall, "launches": launches, "rows": rows, "tail_start": tail}
    lo = tail * store.records_per_block
    order = np.lexsort(dims[lo:].T[::-1])
    tables = {"append": (dims, meas),
              "compact": (np.concatenate([dims[:lo], dims[lo:][order]]),
                          np.concatenate([meas[:lo], meas[lo:][order]]))}
    for what, (new_store, secs, held, left, evicted, wave, wave_s) in (
            ("append", grown), ("compact", compacted)):
        dirty = set(range(tail, new_store.num_blocks))
        if left & dirty or left != held - dirty or evicted != len(held & dirty):
            raise AssertionError(f"{what}: the tiers did not evict exactly the dirtied blocks")
        t0 = time.perf_counter()
        full = build_block_store(Table(*tables[what], table.cards), store.records_per_block,
                                 device=device)
        build_s = time.perf_counter() - t0
        for name in ("dims", "measures", "valid_rows"):
            if not torch.equal(getattr(new_store, name), getattr(full, name)):
                raise AssertionError(f"{what}: {name} differ from the full build's")
        for name in ("densities", "sorted_block_ids", "sorted_densities"):
            if not torch.equal(getattr(new_store.index, name), getattr(full.index, name)):
                raise AssertionError(f"{what}: index {name} differ from the full build's")
        del full
        fresh = NeedleTailEngine(new_store, device=device).any_k_batch(queries)
        compare_waves(fresh, wave)
        if wave_counts(fresh)[0] != wave.rounds:
            raise AssertionError(f"{what}: the wave's rounds differ from a fresh engine's")
        out[what] = {"card_s": secs, "full_build_s": build_s, "wave_s": wave_s,
                     "blocks": new_store.num_blocks, "evicted": len(held & dirty),
                     "kept": len(held - dirty), "wave_store_blocks": wave.store_blocks_fetched}
    t0 = time.perf_counter()
    cpu_grown = append_records(cpu_store, new)
    t1 = time.perf_counter()
    cpu_compacted = compact_tail(cpu_grown, tail)
    t2 = time.perf_counter()
    for cpu, mine in ((cpu_grown, grown[0]), (cpu_compacted, compacted[0])):
        for name in ("densities", "sorted_block_ids", "sorted_densities"):
            if not torch.equal(getattr(cpu.index, name), getattr(mine.index, name).cpu()):
                raise AssertionError(f"the CPU run's index {name} differs from the card's")
    out["append"]["cpu_s"], out["compact"]["cpu_s"] = t1 - t0, t2 - t1
    return out


def prefetch_check(store, queries, run, device: str = "cuda",
                   hbm_bytes: int = TIER_HBM_BYTES) -> dict:
    """Warm the plan memo with one host-mirror wave on a tiered engine,
    clear the tiers, ``kick`` the same requests and ``drain(wait=True)``:
    the next wave's round 0 reads no store block, and its results equal a
    flat engine's.  Sync and async (side-stream) prefetchers give the same
    admissions and results.  The wave's ``auto`` queries only: the memo
    predicts the plan ``auto`` would choose, which needs both of a query's
    memoized plans, and a query pinned to one algorithm memoizes one."""
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.storage import TierPrefetcher, make_tier_stack, predicted_wave_blocks

    queries = [q for q in queries if q.algo is None]
    flat = NeedleTailEngine(store, device=device).any_k_batch(queries)

    def mode(async_fetch: bool):
        st = make_tier_stack(hbm_bytes, None, device=device)
        eng = NeedleTailEngine(store, tiers=st, device=device)
        eng.any_k_batch(queries, device=False)  # the host mirror memoizes round 0's plans
        st.clear()
        if predicted_wave_blocks(eng, queries)[1] != len(queries):
            raise AssertionError("the host-mirror wave left a query's round 0 unpredicted")
        pf = TierPrefetcher(eng, max_blocks=PREFETCH_MAX_BLOCKS, async_fetch=async_fetch)
        sync(device)
        t0 = time.perf_counter()
        issued = pf.kick(queries)
        t1 = time.perf_counter()
        moved = pf.drain(wait=True)
        sync(device)
        t2 = time.perf_counter()
        admitted = tier_state(st)
        reads, ensure = [], st.ensure
        st.ensure = lambda s, ids: reads.append(ensure(s, ids)) or reads[-1]
        t3 = time.perf_counter()
        wave = eng.any_k_batch(queries, device=True)
        sync(device)
        t4 = time.perf_counter()
        del st.ensure
        pf.observe_wave(wave.unique_blocks_fetched)
        return {"issued": issued, "moved": moved, "kick_s": t1 - t0, "drain_s": t2 - t1,
                "wave_s": t4 - t3, "round_reads": reads, "stats": pf.stats.snapshot(),
                "admitted": admitted, "wave": wave}

    (sync_run, async_run), wall, launches = run("prefetch", lambda: (mode(False), mode(True)))
    for name, r in (("sync", sync_run), ("async", async_run)):
        if not r["round_reads"] or r["round_reads"][0] != 0 or not r["issued"]:
            raise AssertionError(f"{name} prefetch: round 0 read {r['round_reads'][:1]} store "
                                 f"blocks after issuing {r['issued']}")
        compare_waves(flat, r["wave"])
    if sync_run["admitted"]["counters"] != async_run["admitted"]["counters"] or \
            sync_run["admitted"]["resident"] != async_run["admitted"]["resident"] or \
            sync_run["issued"] != async_run["issued"] or \
            sync_run["stats"]["fetched"] != async_run["stats"]["fetched"]:
        raise AssertionError("the async prefetcher's admissions differ from the sync one's")
    out = {"wall": wall, "launches": launches, "queries": len(queries)}
    for name, r in (("sync", sync_run), ("async", async_run)):
        out[name] = {k: r[k] for k in ("issued", "moved", "kick_s", "drain_s", "wave_s",
                                       "round_reads", "stats")}
        out[name]["hbm_blocks"] = len(r["admitted"]["resident"][0])
    return out


def run_phase(name: str, fn):
    """Zero the launch counters, run ``fn``, read them: ``name``'s kernels
    must all have launched.  Returns ``(result, wall seconds, launches)``."""
    import torch

    from repro_torch.kernels import _lib

    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    missing = [k for k in PHASE_KERNELS[name] if launches[k] == 0]
    log(f"{name} launches: {launches}")
    if missing:
        raise AssertionError(f"the {name} path launched no {missing}")
    return out, wall, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="run the first wave under torch.profiler and trace one more "
                         "warm wave, one warm sharded wave and one LM serving wave of each "
                         "traffic; print device and host time by operator, and the kernels "
                         "scaled_dot_product_attention launches in f32")
    # one rank of the sharded_ranks phase (the script starts these itself)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=SHARDS, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    started = time.perf_counter()

    import torch

    if args.rank is not None:
        return rank_main(args)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import multi_query
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.data.block_store import build_block_store
    from repro_torch.data.synthetic import make_real_like_table
    from repro_torch.kernels import _lib

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    _lib.load()
    log(f"build: {_lib.build_seconds:.1f} s")
    ptxas = ptxas_report((_lib.BUILD_DIR / "build.log").read_text())
    for line in ptxas:
        log(f"  {line}")
    redesigned = {name: [next((ln for ln in ptxas if ln.startswith(f"{kern}:")), None)
                         for kern in kerns] for name, kerns in NEW_KERNELS.items()}
    for name, lines in redesigned.items():
        for line in lines:
            if line is None or "0 bytes spill stores, 0 bytes spill loads" not in line:
                raise AssertionError(f"{name}: ptxas reports spills or no kernel: {line}")

    t0 = time.perf_counter()
    table = make_real_like_table("airline", num_records=args.records, seed=args.seed)
    t1 = time.perf_counter()
    store = build_block_store(table, RPB, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"data: {args.records} records in {t1 - t0:.1f} s; store λ={store.num_blocks} "
        f"({store.data_nbytes() / 1e9:.2f} GB of slabs) on the card in {t2 - t1:.1f} s")

    queries = make_wave(table.cards, Q, args.seed)
    phase_launches = {}

    def counters(b) -> str:
        return (f"rounds {b.rounds}, unique blocks {b.unique_blocks_fetched.size}, "
                f"store blocks read {b.store_blocks_fetched}, cache hits {b.cache_hits}, "
                f"records {sum(r.num_records for r in b.results)}")

    # -- 4. wave: the device-resident any-k wave, cold then warm
    engine = NeedleTailEngine(store, device="cuda")

    def first_wave():
        if args.profile:
            return profile_wave(lambda: engine.any_k_batch(queries, device=True), "first wave")
        return engine.any_k_batch(queries, device=True)

    batch, wall, phase_launches["wave"] = run_phase("wave", first_wave)
    t0 = time.perf_counter()
    warm = engine.any_k_batch(queries, device=True)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    compare_waves(batch, warm)
    if args.profile:
        profile_wave(lambda: engine.any_k_batch(queries, device=True), "wave again")
    log(f"wave: Q={Q} wall {wall} s, transfers {batch.device_transfers}, {counters(batch)}")
    log(f"wave again (warm cache): wall {warm_wall} s, transfers {warm.device_transfers}, "
        f"{counters(warm)}")
    log(f"wave round seconds: {batch.round_seconds}; warm {warm.round_seconds}")
    if not batch.device_transfers <= batch.rounds + 1:
        raise AssertionError("more than one plan transfer per round")
    # one combine a wave whatever its ops, one θ-round a planning round
    want = {"density_combine_batch": 1, "theta_stats_batch": batch.device_transfers}
    check_launches(phase_launches["wave"], want, "wave")
    log(f"wave launch counts as expected: {want}")
    reasons = check_records(table, store, queries, batch, engine.max_refills)
    log(f"records re-checked on the host table; short of k: {reasons}")

    cpu_store = store.to("cpu")
    t0 = time.perf_counter()
    cpu = NeedleTailEngine(cpu_store, device="cpu").any_k_batch(queries, device=True)
    log(f"cpu wave: {time.perf_counter() - t0:.1f} s")
    compare_waves(batch, cpu)
    log("card wave == cpu wave on every query (boundary cases: 0)")
    del cpu
    log(f"two-prong contract at round 0: {window_contract(store, queries)}")

    # -- 5. host-mirror: the reference's default loop on a fresh engine
    host_engine = NeedleTailEngine(store, device="cuda")
    with count_calls(multi_query, "_combined_matrix") as combines:
        host, host_wall, phase_launches["host_mirror"] = run_phase(
            "host_mirror", lambda: host_engine.any_k_batch(queries, device=False))
    # one combine launch per planned (round, algorithm) group, whatever its ops
    want = {"density_combine_batch": combines["calls"]}
    check_launches(phase_launches["host_mirror"], want, "host_mirror")
    log(f"host_mirror launch counts as expected: {want}")
    compare_waves(batch, host)
    same = (host.rounds, host.store_blocks_fetched, host.cache_hits) == \
        (batch.rounds, batch.store_blocks_fetched, batch.cache_hits)
    if not same or not np.array_equal(host.unique_blocks_fetched, batch.unique_blocks_fetched):
        raise AssertionError("host-mirror wave's rounds or cache counters differ from the device wave's")
    t0 = time.perf_counter()
    host_warm = host_engine.any_k_batch(queries, device=False)
    torch.cuda.synchronize()
    host_warm_wall = time.perf_counter() - t0
    compare_waves(batch, host_warm)
    log(f"host-mirror wave: wall {host_wall} s, {counters(host)}; round seconds "
        f"{host.round_seconds}")
    log(f"host-mirror again (warm cache and plan memo): wall {host_warm_wall} s, "
        f"{counters(host_warm)}; plan memo {host_engine.plan_cache.stats}")
    log("host-mirror wave == device wave on every query, rounds and cache counters")

    # -- 6. single: engine.any_k, the reference's sequential loop
    pick = pick_single(queries, batch)
    single_engine = NeedleTailEngine(store, device="cuda")
    times = []

    def run_single():
        out = []
        for i in pick:
            q = queries[i]
            t0 = time.perf_counter()
            out.append(single_engine.any_k(q.predicates, q.k, q.op, q.algo or "auto"))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out

    singles, single_wall, phase_launches["single"] = run_phase("single", run_single)
    for i, r in zip(pick, singles):
        compare_results(r, batch.results[i], f"any_k of query {i}")
    sub = [queries[i] for i in pick]
    reasons = check_records(table, store, sub, SimpleNamespace(results=singles),
                            single_engine.max_refills)
    for i, r, t in zip(pick, singles, times):
        q = queries[i]
        log(f"any_k query {i} ({q.algo or 'auto'} -> {r.algo}, {q.op}, γ={len(q.predicates)}, "
            f"k={q.k}): {t} s, {r.plan_rounds} rounds, {r.blocks_fetched.size} blocks, "
            f"{r.num_records} records")
    log(f"single: {len(pick)} any_k calls in {single_wall} s, each == its wave result; "
        f"short of k: {reasons}; cache {single_engine.block_cache.stats.snapshot()}")

    # -- 7. bisect: θ-bisection on the kernel against its plain steps
    rows = combined_rows(store, queries)
    _lib.reset_launches()
    t0 = time.perf_counter()
    bis = bisect_check(rows, queries, RPB)
    bisect_wall = time.perf_counter() - t0
    phase_launches["bisect"] = bis.pop("launches")
    log(f"bisect launches: {phase_launches['bisect']}")
    if phase_launches["bisect"]["theta_stats"] != Q:
        raise AssertionError(f"the bisect path launched theta_stats "
                             f"{phase_launches['bisect']['theta_stats']} times, not once a row")
    log(f"bisect: {Q} rows in {bisect_wall} s (with its checks): {bis}")
    log(f"bisect per row, one launch vs the step-by-step path: "
        f"{bisect_timing(rows, queries, RPB)}")

    # -- 8. sharded: a world of one over NCCL on the card, through attach_mesh
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        sh = sharded_check(store, queries, batch, warm, rows, run_phase, profile=args.profile)
    finally:
        dist.destroy_process_group()
    phase_launches["sharded"] = sh.pop("launches")
    log(f"sharded (NCCL, P=1): wave {sh['walls']['cold']} s cold (round seconds "
        f"{sh['round_seconds']}), {sh['walls']['warm']} s warm ({sh['warm_round_seconds']}), "
        f"host mirror {sh['walls']['host_mirror']} s; transfers {sh['transfers']}; frontier "
        f"all_gather {sh['collective_ms']} ms; bisect_stats_wave vs the plain rounds "
        f"{sh['bisect_ms']}; bisect_stats_wave vs threshold_bisect "
        f"{sh['bisect']}; each wave == the unsharded wave's, counters included")

    # -- 9. sharded_ranks: P = 4 ranks on the one card, each with its own table
    t0 = time.perf_counter()
    ranks = launch_ranks(args.records, args.seed, SHARDS, profile=args.profile)
    ranks_wall = time.perf_counter() - t0
    for r in ranks:
        for what in ("cold", "warm", "host_mirror"):
            want = sh["digest"] if what != "warm" else wave_digest(warm)
            if r["digests"][what] != want:
                raise AssertionError(f"rank {r['rank']}'s {what} wave differs from the sharded "
                                     "phase's")
        missing = [k for k in PHASE_KERNELS["sharded_ranks"] if r["launches"][k] == 0]
        if missing or r["shards"] != SHARDS:
            raise AssertionError(f"rank {r['rank']}: {r['shards']} shards, launched no {missing}")
        # one combine of the rank's slab a wave, whatever its ops
        check_launches(r["launches"], {"density_combine_batch_sharded": 1}, f"rank {r['rank']}")
    phase_launches["sharded_ranks"] = ranks[0]["launches"]
    for line in ranks[0]["profile"]:
        log(line)
    log(f"sharded_ranks launches (rank 0): {ranks[0]['launches']}")
    log(f"sharded_ranks (P={SHARDS} on one card, gloo: the collectives' CUDA tensors are "
        f"staged through the host, compute stays on the card; {args.records} records, "
        f"λ_local {ranks[0]['lam_local']}): {ranks_wall:.1f} s in all; per rank "
        + "; ".join(f"rank {r['rank']}: data {r['data_s']:.1f} s, waves {r['walls']}, round "
                    f"seconds {r['round_seconds']}, frontier all_gather {r['collective_ms']} ms"
                    for r in ranks)
        + "; every rank == the sharded phase, counters included")

    # -- 10-16. predicate trees, FORWARD-OPTIMAL, the §5 aggregate path,
    # group-by and the baselines, each also run by the port on the CPU store
    tree_queries = make_tree_wave(table.cards, Q, args.seed)
    t0 = time.perf_counter()
    pr = predicates_check(table, store, cpu_store, tree_queries, run_phase)
    phase_launches.update(pr.pop("launches"))
    log(f"predicates: Q={Q} ({Q - Q // 4} trees with {pr['in_nodes']} In nodes, {Q // 4} pair "
        f"lists) {pr}; every loop == the device wave == the CPU run; {time.perf_counter() - t0:.1f} "
        "s in all")
    t0 = time.perf_counter()
    fo = forward_optimal_check(rows[0], run_phase)
    phase_launches["forward_optimal"] = fo.pop("launches")
    log(f"forward_optimal: {fo}; opt_table == the CPU run's, DP == CPU DP, any_k == CPU any_k, "
        f"DP cost == scan Opt(k) within 1e-4; {time.perf_counter() - t0:.1f} s in all")
    from repro_torch.core import predicates as tp

    t0 = time.perf_counter()
    agg = aggregate_check(store, cpu_store, [
        ("pairs [(0, 6), (2, 3)]", [(0, 6), (2, 3)]),
        ("tree And(In(0, (5, 6, 7)), Not(Eq(3, 0)))",
         tp.And((tp.In(0, (5, 6, 7)), tp.Not(tp.Eq(3, 0)))))], run_phase, args.seed)
    phase_launches["aggregate"] = agg.pop("launches")
    log(f"aggregate: {agg}; blocks == the CPU run's, estimates within {RTOL}, each online fold "
        f"== its offline estimator; {time.perf_counter() - t0:.1f} s in all")
    t0 = time.perf_counter()
    gb = groupby_check(table, store, cpu_store, run_phase)
    phase_launches["groupby"] = gb.pop("launches")
    log(f"groupby {GROUPBY}: {gb}; counts, blocks and records == the CPU run's; "
        f"{time.perf_counter() - t0:.1f} s in all")
    t0 = time.perf_counter()
    bl, held = baselines_check(table, store, cpu_store,
                               [q for q in tree_queries if isinstance(q.predicates, list)],
                               run_phase)
    phase_launches["baselines"] = bl.pop("launches")
    log(f"baselines: {bl}; words, streams and scans == the CPU run's, first-k ids == the "
        f"table's; {time.perf_counter() - t0:.1f} s in all")
    del held, cpu_store
    torch.cuda.empty_cache()

    # -- 17. lm_forward and 18. lm_serve: zamba2-7b at full width on the card
    # f32 products stay f32 on the card, as in the reference (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    cfg, scfg = get_config(LM_ARCH), get_config(SWA_ARCH)
    model = build_lm(cfg, args.seed)
    long_seq = lm_phases(model, "lm_forward", "lm_serve", args, phase_launches)
    del model
    torch.cuda.empty_cache()

    # -- 19. lm_forward_swa and 20. lm_serve_swa: gemma3-12b at full width
    model = build_lm(scfg, args.seed)
    swa_seq = lm_phases(model, "lm_forward_swa", "lm_serve_swa", args, phase_launches)
    del model
    torch.cuda.empty_cache()

    entries = kernel_phase(store, queries, batch, phase_launches, rows)
    for e in entries:
        if e["name"] in redesigned:
            e["ptxas"] = redesigned[e["name"]]
    entries += lm_kernel_rows(cfg, phase_launches, long_seq, args.seed, torch.device("cuda"),
                              swa=(scfg, swa_seq), profile=args.profile)

    # -- 22-25. tiered storage on the same table, the LMs freed
    cpu_store = store.to("cpu")
    t0 = time.perf_counter()
    ti = tiered_check(store, cpu_store, queries, batch, {"cold": wall, "warm": warm_wall},
                      run_phase)
    phase_launches["tiered"] = ti.pop("launches")
    tier_engine, tier_stack = ti.pop("engine"), ti.pop("stack")
    log(f"tiered: {ti}; both waves == the flat wave (records, blocks, counts), the warm one "
        f"read 0 store blocks with 0 evictions; recency demotions cascade; the CPU run's "
        f"counters == the card's; get_device == store.fetch; {time.perf_counter() - t0:.1f} s "
        "in all")
    t0 = time.perf_counter()
    ca = calibration_check(store, tier_stack, queries, run_phase)
    phase_launches["calibration"] = ca.pop("launches")
    for lv, fit in ca.pop("levels").items():
        log(f"calibration {lv}: {fit}")
    log(f"calibration: {ca}; the calibrated wave == a flat engine's on the fitted model; "
        f"{time.perf_counter() - t0:.1f} s in all")
    t0 = time.perf_counter()
    ac = append_compact_check(table, store, cpu_store, tier_engine, tier_stack, queries,
                              run_phase, args.seed)
    phase_launches["append_compact"] = ac.pop("launches")
    log(f"append_compact: {ac}; each evicted exactly the dirtied tail from every tier, its "
        f"store == build_block_store bit for bit, its wave == a fresh flat engine's; "
        f"{time.perf_counter() - t0:.1f} s in all")
    del tier_engine, tier_stack, cpu_store
    t0 = time.perf_counter()
    pf = prefetch_check(store, queries, run_phase)
    phase_launches["prefetch"] = pf.pop("launches")
    log(f"prefetch: {pf}; round 0 read 0 store blocks in both modes, async admissions == "
        f"sync; {time.perf_counter() - t0:.1f} s in all")
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
