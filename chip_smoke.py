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

Then the remaining LM families, each built on the card, driven kernel
against plain and freed before the next (wall times, tokens/s, #8
launches, peak memory logged):

21. lm_moe — qwen3-moe-235b-a22b at its published widths (d_model 4,096, 64
   heads of 64, 4 kv heads, 128 experts, top 8, expert d_ff 1,536, vocab
   151,936, capacity factor 1.25), its depth cut from 94 to ``MOE_LAYERS``
   = 4 layers (f32 at full depth needs ~940 GB; four take ~44 GB): as
   lm_forward, lm_serve (both traffics) and serve_lm_continuous, #8 once a
   layer a forward or prefill.  The MoE is the reference's capacity-bounded
   einsum dispatch in top-1 rounds; its router can part the two paths
   where two experts' probabilities lie within the paths' ~1e-6 difference,
   so every call's ranked top-k is recorded (``RouterLog``): each routing
   flip must sit at a margin below ``MOE_MARGIN_BOUND`` on both paths, and
   logits, caches and greedy streams are held before each row's or
   request's first flip; flips are counted.
22. lm_encdec — whisper-tiny whole (4 encoder and 4 decoder layers, d_model
   384, ``enc_seq`` 1,500): 4 requests (the launcher's prompt draws beside
   seeded frames ``[4, 1500, 384]·0.02``) through ``make_prefill_step``
   (#8 12 times: 4 encoder self-attentions and 4 cross-attentions without
   the causal mask, 4 causal) and 16 greedy ``make_decode_step`` steps,
   kernel against plain: logits, caches (cross K/V included), tokens.
23. lm_vlm — phi-3-vision-4.2b whole (32 layers, d_model 3,072): as
   lm_forward with seeded ``patch_embeds [1, 256, 3072]·0.02``, then 4
   requests of 256 patches and 256-768 text tokens through the step
   functions as lm_encdec (#8 32 times a prefill).

24. kernels — each kernel at its path's shapes against its plain PyTorch
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
   ``scaled_dot_product_attention``), without the causal mask at every head
   dim (``FA_NONCAUSAL_SHAPES``: S = T, S < T, S > T, GQA) and at
   whisper-tiny's encoder and cross shapes (timed beside non-causal SDPA),
   #9 (the CUDA kernels of a call
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
   path it replaced, by CUDA events and host clock.  #10, the round's
   record selection and packing, at each benchmark cell's round shapes
   (``RECORD_ROUNDS``: tpch 16,600 pairs over 11,000 blocks, γ = 3, s = 20;
   synth 340 over 226, s = 2), bit for bit its plain op chain, then timed.
   The build must show no spills for the kernels of the last redesigns
   (``NEW_KERNELS``).

Then tiered block storage (``repro_torch.storage``) on the same table, the
LMs freed, each phase's store reads through #7:

25. tiered — the wave on ``make_tier_stack(256 MiB, None)`` (~993 blocks
   in tier 0 on the card over unbounded pinned host memory,
   ``CostAwarePolicy``), cold then warm: both equal the flat wave phase's
   (records, blocks, rounds, store reads, cache hits); the warm wave reads
   0 store blocks with 0 evictions.  Then ``RecencyPolicy`` over 128 MiB /
   256 MiB: demotions cascade (``hbm.demotions_out == dram.demotions_in +
   hbm.evictions``) and, the 552.6 MB union exceeding both, blocks drop;
   results unchanged.  The same calls on the CPU copy give equal
   ``tier_counters()`` and ``snapshot()``; ``get_device`` of the union
   equals ``store.fetch``.  Wall times, per-tier hits, peak device memory.
26. calibration — the ``hbm`` level fitted (``calibrate_model``) on CUDA-
   event timings of #7 over the tier-0 pool, the ``dram`` level on copies
   from the pinned tier-1 pool to the card, the backing level through
   ``StoreTimingBackend`` on the card; fits, bandwidth and latency printed
   (these give the port's ``hbm`` and ``dram`` presets).  An engine with
   ``calibrated_cost=True`` and a ``PlanLedger``: its wave equals a flat
   engine's on the fitted model; the ledger's q-errors printed.
27. append_compact — ``engine.append`` of 10⁶ airline rows (seed + 1) on
   the tiered engine, then ``engine.compact`` from the first dirtied block:
   each time exactly the dirtied tail leaves every tier, the store (slabs
   and index) equals ``build_block_store`` of the same table bit for bit,
   and the next wave equals a fresh flat engine's; timed on the card and on
   the CPU copy.
28. prefetch — the wave's 48 ``auto`` queries (the memo predicts the plan
   ``auto`` picks): the memo warmed by a host-mirror wave, the tiers
   cleared, ``TierPrefetcher.kick`` + ``drain(wait=True)``: the next wave's
   round 0 reads 0 store blocks and equals a flat engine's; the async mode
   (a side stream) admits what the sync mode does, with equal results.
29. peer — the cooperative peer-memory tier (``repro_torch.storage.peer``):
   ``make_peer_group(store, 4)`` (four in-process shards, each a 256 MiB
   tier 0 on the card over unbounded pinned host memory), the engine on
   shard 0 and the wave's union warmed in thirds on shards 1-3.  The
   peer-served wave equals the flat wave, reads 0 store blocks, and its
   ``peer.remote_fetches`` equal its ``peer.hits``; the same calls on the
   CPU copy give equal counters and directory.  The ``ici`` level fitted
   (``calibrate_model``) on CUDA-event timings of the peer hop's copies
   (``PeerTimer``; these give the port's ``ici`` preset).  Shard 1 raising:
   equal results, one failure and one store read a read of its blocks;
   shard 1 missing: equal results, its blocks read once.  Two waves of heat,
   then ``OwnershipRebalancer.rebalance()`` moves the union to shard 0, and
   the next wave reads none of it over the peer hop.  A world of one over
   NCCL: ``attach_mesh(mesh, peer_group=...)``, ``fetch_remote`` serves warm
   ids byte for byte and the mesh wave (#3) equals the flat wave.  Last, an
   append raced into a peer read through ``mid_fetch_hook`` aborts it, and
   the next wave equals a flat engine's on the grown store.  Wall times
   beside the tiered wave's, peak device memory.

Serving and observability (``ServeEngine``, ``serving/admission.py``,
``obs/``), each phase beside the path it drives:

30. serve_exemplar — after the sharded phase, inside its NCCL world: the
   wave's 64 queries as exemplar requests (each ``auto``) on 16 slots, a
   fake clock: ``run_continuous`` on the device wave (#2 once per join
   flush, #5 once a tick, asserted), on the host-mirror round
   (``serve_exemplar_host``: #2 once a tick), ``drain_exemplar_requests``
   (``serve_exemplar_drain``) and over the mesh (``serve_exemplar_mesh``:
   #3 once per join flush); every request equal to the all-``auto`` wave,
   the wave phase's ``auto`` queries and 8 solo ``any_k``.  Then a real
   clock (SLO 50 ms, one arrival a tick): the admission waits' p50 / p99.
31. serve_aggregate — after the baselines: 8 online aggregates on 4 slots
   (six error SLOs set from their solo runs' half-widths, one modeled-I/O
   deadline, one without); each stream equal to its solo run on a fresh
   card engine (``==``) and on the CPU copy (``rtol``); the error SLOs
   answer ``"ci"``, one mid-wave.
32. obs — both kinds traced by a ``TraceRecorder``, equal to the untraced
   run; the export read by ``tools/trace_report.py`` (a subprocess), which
   must rebuild one path per request.
33. serve_lm_continuous (after lm_serve) and 34. serve_lm_continuous_swa
   (after lm_serve_swa) — ``run_continuous`` with joiners prefilled at the
   position counter and grafted into the live cache (gemma3-12b past its
   window, so the rings wrap), kernel against plain, near-ties counted; the
   joiner at ``pos`` equal to its solo wave; #8/#9 once per sublayer a
   prefill.
35. serve_tiered (last) — the requests in groups of 8 on a 256 MiB tier 0:
   the residency probe, the asynchronous prefetcher, the cost gate and a
   refit every 8 ticks; equal to the all-``auto`` wave.

Training on the card (``launch/train.py``, ``launch/steps.py``,
``optim/``, ``checkpoint/``, ``data/pipeline.py``), after the LM families
and before the kernels phase; the model trains on the plain path (the
kernels define no gradient), the pipeline's refills run #1, #6 and #7:

36. train_stream — ``make_token_corpus`` of 65,536 sequences of 2,049
   tokens on the card (vocab 50,280; λ = 2,048 blocks of 32, 0.54 GB of
   tokens); ``FilteredBatchStream`` batches of 8 under
   ``domain=code,quality=hi`` (32) and ``lang=zh`` (past its first epoch
   reset, asserted, and 32 more): every batch's ``record_ids`` equal the
   same stream's on the CPU copy, every record matches its filter on the
   host table, the pipeline state equals the CPU's.
37. train — ``repro_torch.launch.train.main`` on mamba2-130m at its
   published widths and depth (24 layers, d_model 768, vocab 50,280,
   d_state 128), ``--batch 8 --seq 2048`` (the Mamba-2 paper's context)
   under ``domain=code,quality=hi`` on that corpus: 24 steps with a
   checkpoint every 12; then a second directory crashed after its step-12
   commit and resumed to 24 (the reference's restart test at full width;
   a run stopped by ``--steps 12`` would decay its rate on another
   schedule): the resumed loss equals the uninterrupted one within
   ``rel=1e-4`` and the pipeline state saved at step 24 is identical.
   Seconds a step (host clock, synchronised), the refill's share of it,
   tokens/s and peak memory are logged.
38. train_learns — ``make_train_step(peak_lr=3e-3, warmup=2,
   total_steps=60)`` on mamba2-130m at full width, 30 steps on
   ``tests/test_models.py``'s learnable batch: the last loss below 0.6 ×
   the first.
39. train_archs — one train step of each of the ten configurations at
   ``reduced()`` on the card beside the same step on the CPU from the same
   parameters (``TRAIN_ARCHS_*``: the loss, grad norm and updated
   parameters).

40. lm_sharded — the multi-GPU LM in an NCCL world of one (``(1, 1)``
   ``("data", "model")`` mesh, ``world_of_one``): mamba2-130m at full width
   and depth, one train step on ``[8, 2048]`` under ``tp_sp`` and under
   ``fsdp`` (parameters and AdamW moments DTensors placed by the sharding
   tables): loss within ``SHARD_LOSS_RTOL`` and parameters within
   ``SHARD_PARAM_LR``·lr of the unsharded step (2·lr more at a leaf's
   rounding floor, counted); the collectives of a step
   (count and bytes) counted at dispatch; then zamba2-7b at full width and
   depth served through ``ServeEngine(rules=...)`` on the launcher's
   traffic: its tokens equal the unsharded engine's and its #8 and #9
   launch counts equal the unsharded run's.
41. lm_sharded_ranks — four gloo ranks of this script on the one card
   (NCCL refuses two ranks on one card), started as sharded_ranks starts
   them.  First, one launch checks that gloo carries, on CUDA tensors,
   each collective DTensor issues (``reduce_scatter_tensor``,
   ``all_to_all_single``, ``all_gather_into_tensor``, in that order; a crash
   of the ranks counts as a no, and leaves the ones after it unprobed); a
   missing one is logged as the phase's gloo limit and the phase stops
   there (the multi-rank proof then stays with the CPU tests).  Else: mamba2-130m train steps at full width on ``(2, 2)``
   ``tp_sp`` and ``(4,)`` ``fsdp``, each rank's loss and parameters equal
   the world of one's unsharded step; zamba2-7b at full width, depth cut to
   ``SHARD_ZAMBA_LAYERS`` layers, served with heads over ``model`` on
   ``(2, 2)``: each rank launches #8 and #9 on its half of the heads, and
   its tokens equal the world of one's.
42. dryrun — ``python -m repro_torch.launch.dryrun --arch mamba2-130m
   --shape train_4k --mesh single`` and ``python -m
   repro_torch.launch.dryrun_engine``, two subprocesses side by side: both
   artifacts written, their walls logged.

lm_moe also serves ``MOE_EQUAL_TRAFFIC``: 4 prompts of one length (2,048
tokens), so no row is padded and the tokens are compared up to each row's
first routing flip; the count compared is logged.

The last lines are the ``{"kernels": [...]}`` JSON, the ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import faulthandler
import hashlib
import json
import os
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
    "record_select": ("csrc/record_select.cu",
                      "none: the reference finds and gathers records with numpy on the host"),
}
LM_KERNELS = ("flash_attention", "ssd_scan")
# the CUDA kernels each redesign launches (the last two slices'): their
# ptxas lines go into their rows, and the run fails if one spills
NEW_KERNELS = {"theta_stats": ("theta_bisect_kernel",),
               "density_combine": ("density_combine_excl_kernel",),
               "theta_stats_batch": ("theta_batch_kernel<1>", "theta_batch_kernel<16>"),
               "density_combine_batch": ("density_combine_wave_kernel",),
               "density_combine_batch_sharded": ("density_combine_wave_kernel",),
               "record_select": ("record_count_kernel<2>", "record_scan_kernel",
                                 "record_pack_kernel")}
# the kernels each path must launch; a kernel's "launches" in the JSON line
# are those of the first path listed here that runs it
PHASE_KERNELS = {
    "wave": ("density_combine_batch", "theta_stats_batch", "prefix_sum", "block_gather",
             "record_select"),
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
    "peer": ("density_combine_batch", "density_combine_batch_sharded", "theta_stats_batch",
             "prefix_sum", "block_gather"),
    "serve_exemplar": ("density_combine_batch", "theta_stats_batch", "prefix_sum",
                       "block_gather"),
    "serve_exemplar_host": ("density_combine_batch", "prefix_sum", "block_gather"),
    "serve_exemplar_drain": ("density_combine_batch", "theta_stats_batch", "prefix_sum",
                             "block_gather"),
    "serve_exemplar_mesh": ("density_combine_batch_sharded", "prefix_sum", "block_gather"),
    "serve_aggregate": ("density_combine", "prefix_sum", "block_gather"),
    "obs": ("density_combine", "density_combine_batch", "theta_stats_batch", "prefix_sum",
            "block_gather"),
    "serve_lm_continuous": LM_KERNELS,
    "serve_lm_continuous_swa": ("flash_attention",),
    "lm_moe": ("flash_attention",),
    "lm_encdec": ("flash_attention",),
    "lm_vlm": ("flash_attention",),
    "serve_tiered": ("density_combine_batch", "theta_stats_batch", "prefix_sum",
                     "block_gather"),
    # training: the pipeline's refills run #1 (the filter's combine with the
    # consumed blocks excluded), #6 (THRESHOLD's scan) and #7 (the read); the
    # model trains on the plain path (the kernels define no gradient)
    "train_stream": ("density_combine", "prefix_sum", "block_gather"),
    "train": ("density_combine", "prefix_sum", "block_gather"),
    "train_learns": (),
    "train_archs": (),
    # the multi-GPU LM: the train steps run the plain path (no gradient
    # through a kernel); serving under rules runs #8 and #9 on local shards
    "lm_sharded_train": (),
    "lm_sharded_plain": LM_KERNELS,
    "lm_sharded": LM_KERNELS,
    "lm_sharded_ranks": (),  # counted inside each rank, asserted by the parent
    "dryrun": (),  # fake tensors: nothing runs on the card
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
# ... and without the causal mask (the encoder's and the cross-attention's):
# S = T, S < T and S > T, each GQA: (B, Hq, Hkv, S, T, window)
FA_NONCAUSAL_SHAPES = ((2, 4, 2, 200, 200, None), (1, 4, 2, 130, 300, None),
                       (1, 6, 2, 300, 130, None))
# the remaining families: qwen3-moe at its published widths, its depth cut
# from 94 layers to MOE_LAYERS (94 f32 layers would need ~940 GB; four take
# ~44 GB); whisper-tiny and phi-3-vision whole
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 4
ENCDEC_ARCH = "whisper-tiny"
VLM_ARCH = "phi-3-vision-4.2b"
# a routing flip between the kernel and plain paths (a token whose ranked
# top-k experts differ) must sit at a router margin below this on both
# paths: the paths differ by ~1e-6 relative in attention's f32 sums
MOE_MARGIN_BOUND = 1e-5
# whisper's requests: the launcher's prompt draws beside seeded frames [B,
# enc_seq, d_model]·0.02 (the scale of tests/test_models.py); phi-3-vision's:
# seeded patches [B, num_patches, d_model]·0.02 ahead of 256-768 text tokens
ENCDEC_TRAFFIC = {"requests": 4, "plen": (4, 24), "max_new": 16, "scale": 0.02}
VLM_TRAFFIC = {"requests": 4, "plen": (256, 769), "max_new": 16, "scale": 0.02}
# the launcher's traffic (repro/launch/serve.py defaults) and long prompts
SERVE_TRAFFIC = {
    "launcher": {"requests": 8, "plen": (4, 24), "max_new": 16, "slots": 4, "max_seq": 128},
    "long": {"requests": 4, "plen": (1024, 2049), "max_new": 16, "slots": 4, "max_seq": 2176},
}

# qwen3-moe's long traffic left-pads its rows, and pad rows share a router
# state with near-ties; this one gives every prompt one length (no padding)
# so its tokens are compared up to each row's first routing flip
MOE_EQUAL_TRAFFIC = {"requests": 4, "plen": (2048, 2049), "max_new": 16, "slots": 4,
                     "max_seq": 2176}

# training on the card: mamba2-130m at its published widths and depth on a
# make_token_corpus of 65,536 sequences of 2,049 tokens (2,048, the context
# the Mamba-2 paper trained at, plus the label shift): λ = 2,048 blocks of 32
TRAIN_ARCH = "mamba2-130m"
TRAIN_CORPUS = {"num_seqs": 65_536, "seq_len": 2_049}
TRAIN_FILTERS = ("domain=code,quality=hi", "lang=zh")
TRAIN_BATCH = 8
TRAIN_STREAM_BATCHES = 32  # a stream's batches, and again past the lang=zh epoch reset
TRAIN_STREAM_CAP = 20_000  # batches lang=zh may draw before it must have reset
# the launcher: 24 steps at [8, 2048], a checkpoint every 12; the restart run
# crashes after its step-12 commit and resumes to 24 (tests/test_system.py:24)
TRAIN_RUN = {"steps": 24, "ckpt_every": 12, "seq": 2048, "filter": TRAIN_FILTERS[0]}
TRAIN_RESTART_RTOL = 1e-4  # tests/test_system.py:38
# tests/test_models.py:86-101: 30 steps on a tiled arange(16), [4, 47]
TRAIN_LEARN = {"peak_lr": 3e-3, "warmup": 2, "total_steps": 60, "steps": 30, "ratio": 0.6}
# one train step of every configuration at reduced(), card beside CPU, from
# the same parameters; warmup 0, so the step's rate is peak_lr.  The loss is
# an f32 sum in another order on each device.  AdamW's first step moves each
# element by lr·g/(|g| + eps): an f32 rounding of g moves it by far less than
# 1e-3·lr, except where g lies at its leaf's rounding floor (|g| ≤ 1e-4·max
# |g| of the leaf), where the move may flip, up to 2·lr (counted)
# the multi-GPU LM phases: mamba2-130m's train step at [8, 2048] (warmup 0, so
# the first step moves the parameters).  AdamW's first step is about
# lr·sign(g): an updated parameter is held within SHARD_PARAM_LR·lr of the
# unsharded step's, or 2·lr more where its gradient lies at its leaf's
# rounding floor (TRAIN_ARCHS_FLOOR), whose sign a reduction in another
# order may flip
SHARD_TRAIN = {"batch": 8, "seq": 2048, "peak_lr": 3e-4}
SHARD_LOSS_RTOL = 1e-5
SHARD_PARAM_LR = 0.1
SHARD_RANKS = 4  # gloo ranks on the one card
SHARD_ZAMBA_LAYERS = 12  # the ranks' zamba2-7b depth cut: two whole MMMMMA cycles
SHARD_RANK_TIMEOUT_S = 360
DRYRUN_TIMEOUT_S = 300
TRAIN_ARCHS = {"batch": 2, "seq": 16, "peak_lr": 3e-4}
TRAIN_ARCHS_LOSS_RTOL = 1e-5
TRAIN_ARCHS_PARAM_RTOL, TRAIN_ARCHS_PARAM_LR = 1e-6, 1e-3
TRAIN_ARCHS_FLOOR = 1e-4


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
    rounds = RECORD_ROUNDS if on_card(dev) else {
        name: (8, 12, s, g) for name, (_, _, s, g) in RECORD_ROUNDS.items()}
    entries["record_select"] = record_select_row(phase_launches, dev, rounds, rpb)
    log(f"kernel shapes: Q={Q} λ={lam} γ_max={rm_np.shape[1]} rows={n_rows} "
        f"T=1 (wave), 8 (given), {BISECT_FANOUT} (sharded bisection; single {T}) "
        f"U={ids.numel()} R={rpb} d={store.dims.shape[2]}")
    return [entries[name] for name in KERNELS if name not in LM_KERNELS]


# a round of each benchmark cell as its traced runs show it: union blocks,
# (query, block) pairs of 64 AND queries, measures, tests a query; tpch's
# tests keep ~0.7% of the rows (~0.9·10⁶ records), synth's ~86%
RECORD_ROUNDS = {"tpch": (11_000, 16_600, 20, 3), "synth": (226, 340, 2, 2)}
RECORD_CARDS = (3, 2, 4, 7, 50, 11, 9, 7)  # TPC-H LINEITEM's eight dims


def record_round(dev, n_union: int, n_pairs: int, s: int, gamma: int, rpb: int, seed: int = 0):
    """Union slabs on ``dev`` and a round's pairs over them: γ = 3 draws
    LINEITEM's dims and tests flag, mode and ship year; γ = 2 draws binary
    dims at 93% ones and tests two of them at 1.  The last block is half
    invalid.  Returns ``(dims, meas, valid)`` and the wrapper's arguments."""
    import torch

    from repro_torch.core.multi_query import _predicate_table

    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n_union, rpb, len(RECORD_CARDS))
    if gamma == 3:
        cards = torch.tensor(RECORD_CARDS, dtype=torch.float32, device=dev)
        dims = (torch.rand(shape, generator=g, device=dev) * cards).to(torch.int32)
    else:
        dims = (torch.rand(shape, generator=g, device=dev) < 0.93).to(torch.int32)
    meas = torch.randn((n_union, rpb, s), generator=g, device=dev)
    valid = torch.ones((n_union, rpb), dtype=torch.bool, device=dev)
    valid[-1, rpb // 2:] = False
    rng = np.random.default_rng(seed)
    sizes = np.full(Q, n_pairs // Q)
    sizes[:n_pairs % Q] += 1
    blocks = [np.sort(rng.choice(n_union, size=min(int(k), n_union), replace=False))
              for k in sizes]
    if gamma == 3:
        preds = [[(0, 1), (3, 2), (7, 3)]] * Q
    else:
        preds = [[(int(a), 1) for a in rng.choice(len(RECORD_CARDS), 2, replace=False)]
                 for _ in range(Q)]
    states = [SimpleNamespace(query=SimpleNamespace(predicates=p, op="and")) for p in preds]
    pos = np.concatenate(blocks).astype(np.int64)
    owner = np.repeat(np.arange(Q), [b.size for b in blocks])
    attrs, vals, is_or = _predicate_table(states)
    return (dims, meas, valid), (pos, owner, attrs, vals, is_or, [None] * Q)


def record_select_row(phase_launches: dict, dev, rounds: dict, rpb: int) -> dict:
    """#10 at each cell's round shapes: the kernels' packed buffer and count
    equal the plain op chain's on the same slabs, bit for bit; then the
    count pass with its scan and the write pass timed by CUDA events as
    one launch each (the table built and uploaded once; ``count_ms`` and
    ``pack_ms`` apart), the plain op chain, and the wrappers as the path
    calls them by host clock (table, upload and the count's read
    included).  The bound counts the union blocks' dims and valid bytes
    once, the mask words and tile counts written and read, the table, the
    records' measures read and their packed bytes written."""
    import torch

    from repro_torch.core.multi_query import _PAIR_CHUNK
    from repro_torch.kernels import record_select as rs

    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    out = {}
    for name, (n_union, n_pairs, s, gamma) in rounds.items():
        (dims, meas, valid), args = record_round(dev, n_union, n_pairs, s, gamma, rpb)
        pos = args[0]
        plain_sel = rs.record_select_plain(dims, valid, *args, _PAIR_CHUNK)
        want = rs.record_pack_plain(plain_sel, meas)
        sel = rs.record_select(dims, valid, *args, _PAIR_CHUNK)
        if sel.n != plain_sel.n or not torch.equal(rs.record_pack(sel, meas), want):
            raise AssertionError(f"record_select differs from its plain version ({name})")

        def plain():
            return rs.record_pack_plain(rs.record_select_plain(dims, valid, *args, _PAIR_CHUNK),
                                        meas)

        def path():
            return rs.record_pack(rs.record_select(dims, valid, *args, _PAIR_CHUNK), meas)

        if on_card(dev):
            table, at, tree_rows = rs.kernel_table(dims, *args)
            launch = (dims, valid, table, at, tree_rows, pos.size, args[2].shape[1])
            bits, offsets = rs.select_launch(*launch)

            def both():
                return rs.pack_launch(*rs.select_launch(*launch), table, meas, sel.n)

            ms = time_ms(both, flush=scrub.zero_)
            count_ms = time_ms(lambda: rs.select_launch(*launch), flush=scrub.zero_)
            pack_ms = time_ms(lambda: rs.pack_launch(bits, offsets, table, meas, sel.n),
                              flush=scrub.zero_)
            table_bytes = table.nbytes
        else:
            ms = count_ms = pack_ms = time_ms(path)
            table_bytes = 0
        words, tiles = -(-rpb // 32), -(-rpb // 1024)
        read_blocks = int(np.unique(pos).size)
        nbytes = (read_blocks * rpb * (4 * dims.shape[2] + 1) + 2 * pos.size * (words + tiles) * 4
                  + 2 * (pos.size + 1) * 8 + table_bytes + sel.n * (16 + 8 * s))
        b, by = bound_ms(nbytes, float(pos.size * rpb * (gamma + 1)))
        out[name] = {"union": n_union, "pairs": int(pos.size), "blocks_read": read_blocks,
                     "s": s, "gamma": gamma, "records": sel.n, "ms": ms, "count_ms": count_ms,
                     "pack_ms": pack_ms, "plain_ms": time_ms(plain),
                     "path_host_ms": host_ms(path, dev, runs=5), "bound_ms": b, "bound_by": by,
                     "bytes": nbytes}
        log(f"kernel record_select ({name}): {out[name]}")
        del dims, meas, valid, plain_sel, want, sel
    main = out["tpch"]
    return kernel_row("record_select", phase_launches, 0.0, main["ms"], main["plain_ms"], None,
                      main["bytes"], float(main["pairs"] * rpb * (main["gamma"] + 1)),
                      roofline=main["bound_ms"] / main["ms"] if main["ms"] else None,
                      rounds=out)


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def lm_layer_counts(cfg) -> dict:
    """Kernel launches of one forward or prefill of ``cfg``: #8 per
    attention sublayer (global ``G``, windowed ``L``, shared ``A``), and for
    an encoder-decoder per encoder layer and per cross-attention (``G``,
    ``L``); #9 per Mamba sublayer."""
    from repro_torch.configs.base import _full_pattern

    pat = _full_pattern(cfg)
    attn = sum(ch in "GLA" for ch in pat)
    if cfg.family == "encdec":
        attn += cfg.enc_layers + sum(ch in "GL" for ch in pat)
    return {"flash_attention": attn, "ssd_scan": pat.count("M")}


def check_launches(launches: dict, want: dict, what: str) -> None:
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


@contextlib.contextmanager
def patched(obj, name: str, make):
    """Replace ``obj.name`` by ``make(original)`` inside the block."""
    fn = getattr(obj, name)
    setattr(obj, name, make(fn))
    try:
        yield
    finally:
        setattr(obj, name, fn)


@contextlib.contextmanager
def count_calls(module, name: str):
    """Count the calls of ``module.name`` inside the block (``{"calls": n}``)."""
    seen = {"calls": 0}

    def make(fn):
        def counted(*args, **kwargs):
            seen["calls"] += 1
            return fn(*args, **kwargs)
        return counted

    with patched(module, name, make):
        yield seen


class RouterLog:
    """What a run routed: inside :meth:`record`, each call of
    ``repro_torch.models.layers.moe`` appends ``("moe", top-k experts [B, S,
    K] in rank order, gaps [B, S, K] between adjacent ranks p₍ⱼ₎ − p₍ⱼ₊₁₎
    of the router's probabilities, j = 1..K)``, taken from the router on
    the call's own input, and each ``ServeEngine._greedy`` appends
    ``("tokens", [(row, request id, token index), ...])``.  The package has
    no hook: both are wrapped here, as :func:`count_calls` wraps."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def record(self):
        from repro_torch.models import layers
        from repro_torch.serving.engine import ServeEngine

        moe, greedy = layers.moe, ServeEngine._greedy

        def logged_moe(x, p, cfg, rules=None):
            if rules is not None:  # the sharded MoE routes on local rows: not logged
                return moe(x, p, cfg, rules)
            k = cfg.moe.top_k
            vals, idx = layers.router_top_k(layers.router_probs(x, p), k + 1)
            self.events.append(("moe", idx[..., :k].cpu(), (vals[..., :-1] - vals[..., 1:]).cpu()))
            return moe(x, p, cfg)

        def logged_greedy(eng, logits, slots, rows):
            rows = list(rows)
            self.events.append(("tokens", [(b, slots[b].rid, len(slots[b].out_tokens))
                                           for b in rows]))
            return greedy(eng, logits, slots, rows)

        layers.moe, ServeEngine._greedy = logged_moe, logged_greedy
        try:
            yield self
        finally:
            layers.moe, ServeEngine._greedy = moe, greedy


def routing_flips(kern: RouterLog, plain: RouterLog, bound: float = MOE_MARGIN_BOUND) -> dict:
    """The two paths' routing, call for call.  A flip is a token whose ranked
    top-k differs (the set, or the round an expert is in: either moves the
    capacity positions of later tokens in its row); its margin is the gap at
    the first rank where the lists part, on each path.  Once a row has
    flipped at position f, its positions from f on differ between the paths
    in every later layer (the capacity cumsum runs forward in S, attention
    is causal), and so does every later decode step of its request: flips
    there are counted as ``downstream``.  Every other flip must lie below
    ``bound`` on both paths, else the run fails.  The ``tokens`` events
    part the passes (a prefill, a decode step) and map rows to requests.
    Returns the counts, the largest margin of a flip that had to lie below
    ``bound``, the smallest gap of any token, per row its first flipped
    position (``first_pos``) and per request the index of its first token
    after a flip in its row (``first_token``)."""
    import torch

    ka, pa = kern.events, plain.events
    if [(e[0], tuple(e[1].shape) if e[0] == "moe" else e[1]) for e in ka] != \
            [(e[0], tuple(e[1].shape) if e[0] == "moe" else e[1]) for e in pa]:
        raise AssertionError("the kernel and plain runs made different MoE calls or tokens")
    out = {"moe_calls": sum(e[0] == "moe" for e in ka), "flips": 0, "downstream": 0,
           "largest_flip_margin": 0.0, "smallest_margin": None, "first_pos": {},
           "first_token": {}}
    pending, flagged, row_req, tainted = set(), set(), {}, None
    for a, b in zip(ka, pa):
        if a[0] == "tokens":
            for row, rid, j in a[1]:
                row_req[row] = rid
                if row in pending:
                    flagged.add(rid)
                    out["first_token"].setdefault(rid, j)
            pending, tainted = set(), None
            continue
        if tainted is None:  # a pass begins: a decode step carries its requests' flips
            decode = a[1].shape[1] == 1
            tainted = {row: 0 for row, rid in row_req.items() if decode and rid in flagged}
        low = float(torch.minimum(a[2].min(), b[2].min()))
        out["smallest_margin"] = low if out["smallest_margin"] is None else min(
            out["smallest_margin"], low)
        diff = a[1] != b[1]
        flip = diff.any(dim=-1)
        if not bool(flip.any()):
            continue
        rank = diff.to(torch.int8).argmax(dim=-1, keepdim=True)  # the first rank that parts
        margin = torch.maximum(a[2].gather(-1, rank), b[2].gather(-1, rank))[..., 0]
        first = {}
        for row, pos in flip.nonzero().tolist():
            first[row] = min(first.get(row, pos), pos)
            if pos >= tainted.get(row, a[1].shape[1]):
                out["downstream"] += 1
                continue
            m = float(margin[row, pos])
            out["flips"] += 1
            out["largest_flip_margin"] = max(out["largest_flip_margin"], m)
            if m >= bound:
                raise AssertionError(f"a routing flip between the paths at a router margin of {m}"
                                     f" (row {row}, position {pos}), not below {bound}")
        for row, pos in first.items():
            tainted[row] = min(tainted.get(row, pos), pos)
            out["first_pos"][row] = min(out["first_pos"].get(row, pos), pos)
            pending.add(row)
    return out


def check_close_rows(a, b, first_pos: dict, atol: float, rtol: float, what: str,
                     axis: int = 1) -> float:
    """:func:`check_close` per tensor over each row ``r`` of axis 0, along
    ``axis`` only the positions before ``first_pos[r]`` (a routing flip's:
    none of them can see it); the whole tensor when ``first_pos`` is empty."""
    if not first_pos:
        return check_close(a, b, atol, rtol, what, "tensor")
    err = 0.0
    for r in range(a.shape[0]):
        n = first_pos.get(r, a.shape[axis])
        err = max(err, check_close(a[r].narrow(axis - 1, 0, n), b[r].narrow(axis - 1, 0, n),
                                   atol, rtol, f"{what} (row {r}, before position {n})",
                                   "tensor"))
    return err


def add_launches(phase_launches: dict, phase: str, launches: dict) -> None:
    """Sum ``launches`` into ``phase_launches[phase]`` (a phase of several runs)."""
    into = phase_launches.setdefault(phase, dict.fromkeys(launches, 0))
    for k, n in launches.items():
        into[k] = into.get(k, 0) + n


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


def lm_forward_check(model, seq: int, seed: int, run, phase: str = "lm_forward",
                     extra: dict | None = None) -> dict:
    """``model(tokens, impl="kernel", **extra)`` on ``[1, seq]`` tokens
    through ``run`` (``run_phase``) as ``phase``, held against
    ``impl="plain"``; #8 and #9 must launch once per attention and Mamba
    sublayer.  A MoE model's logits are held before the first routing flip
    between the paths (:func:`routing_flips`)."""
    import torch

    cfg, dev = model.cfg, model.device
    extra = extra or {}
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, seq))).to(dev)
    def timed(impl):
        t0 = time.perf_counter()
        out = model(tokens, impl=impl, **extra)
        sync(dev)
        return out, time.perf_counter() - t0

    kern_log, plain_log = RouterLog(), RouterLog()
    with torch.inference_mode():
        with kern_log.record():
            logits, wall, launches = run(phase, lambda: model(tokens, impl="kernel", **extra))
        with plain_log.record():
            plain, plain_wall = timed("plain")
        warm = {impl: timed(impl)[1] for impl in ("kernel", "plain")}  # cuBLAS and modules loaded
    check_launches(launches, lm_layer_counts(cfg), phase)
    if tuple(logits.shape) != (1, seq, cfg.vocab):
        raise AssertionError(f"{phase}: logits of shape {tuple(logits.shape)}")
    routing = routing_flips(kern_log, plain_log)
    err = check_close_rows(logits, plain, routing["first_pos"], LM_ATOL, LM_RTOL,
                           f"{phase} logits")
    return {"wall_s": wall, "plain_wall_s": plain_wall, "warm_wall_s": warm, "max_abs_err": err,
            "logits_absmax": float(plain.abs().max()), "routing": routing,
            "launches": launches}


def serve_prompts(cfg, traffic: dict, seed: int) -> list[np.ndarray]:
    """The launcher's request draws: a length, then its tokens, per request."""
    rng = np.random.default_rng(seed)
    lo, hi = traffic["plen"]
    return [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi)))
            for _ in range(traffic["requests"])]


def run_engine(model, traffic: dict, prompts, impl: str, log: RouterLog | None = None):
    """``prompts`` drained through a ``ServeEngine`` with ``impl``, its
    routing recorded into ``log`` when given."""
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(model.cfg, model, max_slots=traffic["slots"],
                      max_seq=traffic["max_seq"], impl=impl, device=model.device)
    for p in prompts:
        eng.submit(p, max_new_tokens=traffic["max_new"])
    with log.record() if log is not None else contextlib.nullcontext():
        return eng, eng.run_until_drained()


def compare_streams(done, plain, tol: float, first_flip: dict | None = None) -> dict:
    """Greedy tokens of the kernel run against the plain run's.  A request's
    streams may part only where the plain run's top-2 logit gap is within
    ``2·tol`` (a near-tie, counted); after that its contexts differ, so the
    rest of that request is not compared.  ``first_flip`` (request id ->
    token index, :func:`routing_flips`): a request is compared only before
    its first token after a routing flip in its row (the rest counted as
    ``after_flip``)."""
    out = {"tokens_equal": 0, "near_ties": 0, "tokens": sum(len(r.out_tokens) for r in plain)}
    if first_flip is not None:
        out["after_flip"] = 0
    for rk, rp in zip(done, plain):
        stop = (first_flip or {}).get(rp.rid)
        if stop is not None:
            out["after_flip"] += len(rp.out_tokens) - stop
        for j, (a, b) in enumerate(zip(rk.out_tokens[:stop], rp.out_tokens[:stop])):
            if a == b:
                out["tokens_equal"] += 1
                continue
            if rp.top2_gap[j] > 2 * tol:
                raise AssertionError(f"request {rp.rid} token {j}: {a} vs plain {b} with a "
                                     f"top-2 gap of {rp.top2_gap[j]}")
            out["near_ties"] += 1
            break
        else:
            if stop is None and len(rk.out_tokens) != len(rp.out_tokens):
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
    kern_log, plain_log = RouterLog(), RouterLog()
    with torch.inference_mode():
        with kern_log.record():
            lk, ck = prefill(model, toks, impl="kernel", max_seq=traffic["max_seq"])
        with plain_log.record():
            lp, cp = prefill(model, toks, impl="plain", max_seq=traffic["max_seq"])
        routing = routing_flips(kern_log, plain_log)
        # a row with a routing flip has none of its last-token logits held
        flipped = {r: 0 for r in routing["first_pos"]}
        logits_err = check_close_rows(lk[:, None], lp[:, None], flipped, LM_ATOL, LM_RTOL,
                                      "prefill last-token logits")
        cache_err = {}
        for i, (a, b) in enumerate(zip(ck, cp)):
            for key in a:
                e = check_close_rows(a[key], b[key], routing["first_pos"], LM_ATOL, LM_RTOL,
                                     f"layer {i} cache {key}")
                cache_err[key] = max(cache_err.get(key, 0.0), e)
    return {"prompt_len": int(toks.shape[1]), "logits_max_abs_err": logits_err,
            "cache_max_abs_err": cache_err, "routing": routing}


def lm_serve_check(model, traffic: dict, seed: int, run, phase: str = "lm_serve") -> dict:
    """One traffic through ``ServeEngine`` with the kernels (through ``run``
    as ``phase``) and again with ``impl="plain"``; the first wave's prefill
    compared, every layer's cache (an ``L`` layer's ring slots) included."""
    cfg = model.cfg
    prompts = serve_prompts(cfg, traffic, seed)
    pre = prefill_check(model, traffic, prompts)
    kern_log, plain_log = RouterLog(), RouterLog()
    (eng, done), wall, launches = run(phase, lambda: run_engine(model, traffic, prompts,
                                                                 "kernel", kern_log))
    waves = len(eng.wave_stats)
    check_launches(launches, {k: n * waves for k, n in lm_layer_counts(cfg).items()}, phase)
    eng_p, plain = run_engine(model, traffic, prompts, "plain", plain_log)
    routing = routing_flips(kern_log, plain_log)
    streams = compare_streams(done, plain, LM_ATOL, routing["first_token"])
    new = sum(w["new_tokens"] for w in eng.wave_stats)
    return {"wall_s": wall, "waves": eng.wave_stats, "plain_waves": eng_p.wave_stats,
            "tokens_per_s": new / wall if wall > 0 else None, "prefill": pre,
            "streams": streams, "routing": routing, "launches": launches}


def visible_pairs(s: int, t: int, window: int | None) -> int:
    """(query, key) pairs a causal attention with right-aligned queries
    keeps, per (batch, head): its operations scale with these."""
    qpos = np.arange(s, dtype=np.int64) + (t - s)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros_like(qpos)
    return int(np.maximum(np.minimum(qpos, t - 1) - lo + 1, 0).sum())


def fa_sweep(randn, tol: float, causal: bool = True) -> dict:
    """#8 against its plain version at every head dim of ``FA_D_SWEEP``, on
    each of ``FA_SWEEP_SHAPES`` (``causal``) or ``FA_NONCAUSAL_SHAPES``
    (without the causal mask); the largest error per D."""
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    out = {}
    for d in FA_D_SWEEP:
        out[d] = 0.0
        for b, hq, hkv, s, t, w in FA_SWEEP_SHAPES if causal else FA_NONCAUSAL_SHAPES:
            q, k, v = randn(b, hq, s, d), randn(b, hkv, t, d), randn(b, hkv, t, d)
            out[d] = max(out[d], check_close(
                flash_attention(q, k, v, causal=causal, window=w),
                attention_plain(q, k, v, causal=causal, window=w), tol, tol,
                f"flash_attention (D {d}, S {s}, T {t}, causal {causal}, window {w})"))
    return out


def noncausal_attention(cfg, b: int, prompt_len: int, randn, launches: int) -> dict:
    """#8 without the causal mask at an encoder-decoder's shapes (``cfg``'s
    heads and head dim, batch ``b``): the encoder's self-attention (S = T =
    ``enc_seq``) and the decoder's cross-attention (S = ``prompt_len``, T =
    ``enc_seq``): error against the plain version, ms of the kernel, the
    plain version and non-causal ``scaled_dot_product_attention``, and the
    bound over all S·T pairs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    hq, hkv, d, t = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.enc_seq
    out = {"launches_per_prefill": launches}
    for name, s in (("encoder", t), ("cross", prompt_len)):
        q, k, v = randn(b, hq, s, d), randn(b, hkv, t, d), randn(b, hkv, t, d)
        err = check_close(flash_attention(q, k, v, causal=False),
                          attention_plain(q, k, v, causal=False), FA_TOL, FA_TOL,
                          f"flash_attention ({cfg.name} {name}, not causal)")

        def lib():
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=hq != hkv)

        lib_err = float((lib() - attention_plain(q, k, v, causal=False)).abs().max())
        nbytes, ops = (2 * hq * s + 2 * hkv * t) * b * d * 4, 4.0 * b * hq * d * s * t
        bms, by = bound_tf32x3_ms(nbytes, ops)
        out[name] = {
            "shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "T": t, "D": d}, "max_abs_err": err,
            "library_max_abs_err": lib_err,
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=False)),
            "plain_ms": time_ms(lambda: attention_plain(q, k, v, causal=False)),
            "library_ms": time_ms(lib), "bound_ms": bms, "bound_by": by,
            "bound_fma_ms": bound_ms(nbytes, ops)[0],
        }
        log(f"kernel flash_attention at {cfg.name} {name} (not causal): {out[name]}")
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
                   swa=None, profile: bool = False, encdec=None) -> list[dict]:
    """#8 and #9 at the long serving wave's prefill shapes (batch 4, S = T =
    the wave's padded prompt length) against their plain versions, timed;
    #8 also at h2o-danube-3-4b's GQA sliding-window shape, in bf16 and at
    every head dim of ``FA_D_SWEEP``, and, given ``swa = (cfg, seq)``, at
    that sliding-window model's long-wave shapes (``swa_attention``), over
    every D without the causal mask (``FA_NONCAUSAL_SHAPES``) and, given
    ``encdec = (cfg, {"prompt_len": ..., "launches_per_prefill": ...})``,
    at that encoder-decoder's shapes (``noncausal_attention``); #9
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
    checks["d_sweep_non_causal"] = fa_sweep(randn, tol, causal=False)
    extra = {}
    if encdec is not None:
        ecfg, info = encdec
        extra[ecfg.name] = noncausal_attention(ecfg, b, info["prompt_len"], randn,
                                               info["launches_per_prefill"])
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
    add_launches(phase_launches, fphase, fwd.pop("launches"))
    log(f"{fphase} [1, {LM_FORWARD_SEQ}]: kernel {fwd['wall_s']} s, plain "
        f"{fwd['plain_wall_s']} s (first calls); again {fwd['warm_wall_s']} s; logits max "
        f"|kernel − plain| {fwd['max_abs_err']} "
        f"(|logits| ≤ {fwd['logits_absmax']}), peak {peak_gb('cuda'):.2f} GB")
    if model.cfg.moe:
        log(f"{fphase} forward routing: {fwd['routing']}")
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
        if model.cfg.moe:
            log(f"{sphase} {name} serving routing: {res['routing']}")
        if name == "long":
            long_seq = res["waves"][0]["prompt_len"]
            log(f"{sphase} {model.cfg.name} long prefill [{res['waves'][0]['size']}, "
                f"{long_seq}]: kernel {res['waves'][0]['prefill_s']} s, plain "
                f"{res['plain_waves'][0]['prefill_s']} s")
    if model.cfg.moe:  # prompts of one length: no row padded, tokens compared to each flip
        torch.cuda.reset_peak_memory_stats()
        res = lm_serve_check(model, MOE_EQUAL_TRAFFIC, args.seed, run_phase, sphase)
        for k, n in res.pop("launches").items():
            serve_launches[k] += n
        log(f"{sphase} equal-length [{MOE_EQUAL_TRAFFIC['requests']}, "
            f"{MOE_EQUAL_TRAFFIC['plen'][0]}]: {res['wall_s']} s, {res['tokens_per_s']} tokens/s; "
            f"prefill check {res['prefill']}; streams {res['streams']} (tokens compared "
            f"{res['streams']['tokens_equal'] + res['streams']['near_ties']} of "
            f"{res['streams']['tokens']}); routing "
            f"{res['routing']}; peak {peak_gb('cuda'):.2f} GB")
    add_launches(phase_launches, sphase, serve_launches)
    log(f"{sphase} launches (all traffics): {serve_launches}")
    if args.profile:  # one warm wave of each traffic, with the kernels
        for name, traffic in SERVE_TRAFFIC.items():
            prompts = serve_prompts(model.cfg, traffic, args.seed)[:traffic["slots"]]
            profile_wave(lambda: run_engine(model, traffic, prompts, "kernel"),
                         f"{sphase} {name} wave")
    return long_seq


def steps_batch(cfg, traffic: dict, seed: int, dev) -> dict:
    """An encoder-decoder's or a VLM's requests as one batch for the step
    functions: prompts drawn as the launcher draws (:func:`serve_prompts`),
    left-padded with token 0 to the longest, a VLM's after ``num_patches``
    slots that its patches fill; the stub frontend's seeded ``enc_frames
    [B, enc_seq, D]`` or ``patch_embeds [B, num_patches, D]``, times
    ``traffic["scale"]``."""
    import torch

    prompts = serve_prompts(cfg, traffic, seed)
    b = len(prompts)
    lead = cfg.num_patches if cfg.family == "vlm" else 0
    plen = lead + max(len(p) for p in prompts)
    toks = np.zeros((b, plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    rng = np.random.default_rng(seed + 2)

    def frontend(n):
        x = rng.standard_normal((b, n, cfg.d_model)) * traffic["scale"]
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    if cfg.family == "encdec":
        batch["enc_frames"] = frontend(cfg.enc_seq)
    if cfg.family == "vlm":
        batch["patch_embeds"] = frontend(cfg.num_patches)
    return batch


def greedy_steps(model, cache, last, steps: int, pos: int):
    """``steps`` greedy ``make_decode_step`` steps from position ``pos`` after
    a prefill's last logits: per row an object with ``rid``, ``out_tokens``
    and ``top2_gap`` (as ``ServeEngine``'s requests), and seconds a step."""
    import torch

    from repro_torch.launch.steps import make_decode_step

    step = make_decode_step(model.cfg)
    rows = [SimpleNamespace(rid=i, out_tokens=[], top2_gap=[]) for i in range(last.shape[0])]

    def emit(logits):
        top = torch.topk(logits, 2, dim=-1).values
        nxt = torch.argmax(logits, dim=-1)
        for r, t, g in zip(rows, nxt.tolist(), (top[:, 0] - top[:, 1]).tolist()):
            r.out_tokens.append(t)
            r.top2_gap.append(g)
        return nxt

    nxt = emit(last)
    t0 = time.perf_counter()
    for j in range(steps):
        logits, cache = step(model, cache, nxt, pos + j)
        nxt = emit(logits)
    sync(model.device)
    return rows, (time.perf_counter() - t0) / max(steps, 1)


def steps_check(model, traffic: dict, seed: int, run, phase: str) -> dict:
    """:func:`steps_batch` through ``make_prefill_step`` with the kernels
    (through ``run`` as ``phase``: #8 once per attention sublayer, encoder
    layer and cross-attention) and with ``impl="plain"``: last-token logits
    and every cache tensor, cross K/V included, within ``LM_ATOL``/
    ``LM_RTOL`` per tensor; then ``traffic["max_new"]`` greedy
    ``make_decode_step`` steps from each prefill, tokens equal but for
    counted near-ties.  Each prefill again, warm, timed."""
    import torch

    from repro_torch.launch.steps import make_prefill_step

    cfg, dev = model.cfg, model.device
    batch = steps_batch(cfg, traffic, seed, dev)
    plen, steps = int(batch["tokens"].shape[1]), traffic["max_new"]
    kern_step, plain_step = (make_prefill_step(cfg, impl, max_seq=plen + steps)
                             for impl in ("kernel", "plain"))

    def timed(fn):
        t0 = time.perf_counter()
        out = fn(model, batch)
        sync(dev)
        return out, time.perf_counter() - t0

    with torch.inference_mode():
        (lk, ck), wall, launches = run(phase, lambda: kern_step(model, batch))
        check_launches(launches, {"flash_attention": lm_layer_counts(cfg)["flash_attention"]},
                       phase)
        (lp, cp), plain_wall = timed(plain_step)
        logits_err = check_close(lk, lp, LM_ATOL, LM_RTOL, f"{phase} prefill last-token logits",
                                 "tensor")
        cache_err = {}
        for i, (a, b) in enumerate(zip(ck, cp)):
            for key in a:
                e = check_close(a[key], b[key], LM_ATOL, LM_RTOL, f"{phase} layer {i} cache {key}",
                                "tensor")
                cache_err[key] = max(cache_err.get(key, 0.0), e)
        done, step_s = greedy_steps(model, ck, lk, steps, plen)
        plain, plain_step_s = greedy_steps(model, cp, lp, steps, plen)
        del ck, cp
        warm = {impl: timed(fn)[1] for impl, fn in (("kernel", kern_step), ("plain", plain_step))}
    new = sum(len(r.out_tokens) for r in done)
    return {"batch": int(lk.shape[0]), "prompt_len": plen, "prefill_s": wall,
            "plain_prefill_s": plain_wall, "warm_prefill_s": warm, "decode_s_per_step": step_s,
            "plain_decode_s_per_step": plain_step_s, "decode_steps": steps,
            "tokens_per_s": new / (wall + step_s * steps), "logits_max_abs_err": logits_err,
            "cache_max_abs_err": cache_err, "streams": compare_streams(done, plain, LM_ATOL),
            "launches": launches}


def family_phases(args, phase_launches: dict) -> dict:
    """The remaining families, each built, driven and freed in turn:
    ``lm_moe`` (qwen3-moe at its published widths, ``MOE_LAYERS`` layers:
    the forward, both traffics and the continuous loop with its joiners,
    routing flips accounted), ``lm_encdec`` (whisper-tiny whole through the
    step functions) and ``lm_vlm`` (phi-3-vision whole: the forward with its
    patches, then the step functions).  Returns whisper's prompt length and
    the launches of one prefill of each."""
    import torch

    from repro_torch.configs import get_config

    out = {}
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    log(f"lm_moe: {MOE_ARCH} cut from {get_config(MOE_ARCH).num_layers} to {MOE_LAYERS} layers "
        "(the full depth needs ~940 GB in f32)")
    t0 = time.perf_counter()
    model = build_lm(cfg, args.seed)
    lm_phases(model, "lm_moe", "lm_moe", args, phase_launches)
    lm_continuous_phase(model, "lm_moe", LM_JOIN, args.seed, phase_launches,
                        SERVE_TRAFFIC["launcher"])
    log(f"lm_moe: {time.perf_counter() - t0:.1f} s in all, launches {phase_launches['lm_moe']}")
    del model
    torch.cuda.empty_cache()

    for phase, arch, traffic in (("lm_encdec", ENCDEC_ARCH, ENCDEC_TRAFFIC),
                                 ("lm_vlm", VLM_ARCH, VLM_TRAFFIC)):
        t0 = time.perf_counter()
        model = build_lm(get_config(arch), args.seed)
        torch.cuda.reset_peak_memory_stats()
        if phase == "lm_vlm":
            patches = steps_batch(model.cfg, {**traffic, "requests": 1}, args.seed,
                                  model.device)["patch_embeds"]
            fwd = lm_forward_check(model, LM_FORWARD_SEQ, args.seed, run_phase, phase,
                                   extra={"patch_embeds": patches})
            add_launches(phase_launches, phase, fwd.pop("launches"))
            log(f"{phase} forward [1, {LM_FORWARD_SEQ}] with {model.cfg.num_patches} patches: "
                f"{ {k: v for k, v in fwd.items() if k != 'routing'} }")
        res = steps_check(model, traffic, args.seed, run_phase, phase)
        add_launches(phase_launches, phase, res.pop("launches"))
        out[phase] = {"prompt_len": res["prompt_len"],
                      "launches_per_prefill": lm_layer_counts(model.cfg)["flash_attention"]}
        log(f"{phase} {arch}: {res}; peak {peak_gb('cuda'):.2f} GB; "
            f"{time.perf_counter() - t0:.1f} s in all")
        del model
        torch.cuda.empty_cache()
    return out


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


PEER_SHARDS = 4  # in-process shards of the peer phase, as the reference simulates them
# reads a timed call of PeerTimer: each run synchronises, so there is no
# launch queue to fill, and a run spans a few ms of the host's work
PEER_TIMER_REPS = 16


def paired_event_ms(fn_a, fn_b) -> tuple[list, list]:
    """CUDA-event times (ms) of ``fn_a`` and ``fn_b`` in turns over
    TIMING_RUNS runs each (3 warm-ups of each first), the card synchronised
    before each: the card waits while the host works, so the events bracket
    the host's copies as well as the copies to the card, and a drift in the
    host's speed falls on both alike."""
    import torch

    def once(fn) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    for _ in range(3):
        fn_a(), fn_b()
    runs = [(once(fn_a), once(fn_b)) for _ in range(TIMING_RUNS)]
    return [a for a, _ in runs], [b for _, b in runs]


class PeerTimer:
    """Timing adapter of the peer hop: the copies a peer-served read makes,
    per block the rows of a peer's pinned host slot copied out
    (``Tier.rows``, what ``PeerGroup.fetch_block`` copies), then the call's
    rows stacked into one pinned staging buffer (``tiers.stage``) and copied
    to the card, one ``non_blocking`` copy per tensor; ``PEER_TIMER_REPS``
    reads a run.  The host's speed drifts between calls by more than a
    block's cost, so each call times its blocks in turns with one block
    (:func:`paired_event_ms`) and returns the timer's one-block time (its
    first call's median) plus the median difference, per read."""

    def __init__(self, tier, device):
        import torch

        self.tier, self.device = tier, torch.device(device)
        self.max_block_id = int(tier._pool[0].shape[0]) - 1
        self.one_ms: float | None = None
        self.calls = 0

    def levels(self):
        return {"ici"}

    def _reads(self, slots):
        from repro_torch.storage.tiers import stage

        def reads():
            for _ in range(PEER_TIMER_REPS):
                staged = stage([self.tier.rows(int(s)) for s in slots], self.device)
                for t in staged:
                    t.to(self.device, non_blocking=True)

        return reads

    def io_seconds(self, level: str, block_ids) -> float:
        slots = np.clip(np.asarray(list(block_ids), np.int64), 0, self.max_block_id)
        one, these = paired_event_ms(self._reads(slots[:1]), self._reads(slots))
        if self.one_ms is None:
            self.one_ms = float(np.median(one))
        self.calls += 1
        diff = float(np.median(np.subtract(these, one)))
        return (self.one_ms + diff) / 1e3 / PEER_TIMER_REPS


@contextlib.contextmanager
def world_of_one(device: str):
    """A ``torch.distributed`` world of one in this process (NCCL on a card,
    gloo on the CPU) and its host mesh; destroyed on leaving."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device(device)
    init = f"tcp://127.0.0.1:{free_port()}"
    if dev.type == "cuda":
        dist.init_process_group("nccl", init_method=init, world_size=1, rank=0,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group("gloo", init_method=init, world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=60))
    try:
        yield make_host_mesh(device_type=dev.type)
    finally:
        dist.destroy_process_group()


def peer_check(table, store, cpu_store, queries, flat, tiered_walls: dict, run, seed: int,
               device: str = "cuda", hbm_bytes: int = TIER_HBM_BYTES,
               append_rows: int = APPEND_ROWS) -> dict:
    """The cooperative peer tier: ``make_peer_group(store, PEER_SHARDS)``,
    each shard a ``hbm_bytes`` tier 0 on the card over unbounded pinned host
    memory, the engine on shard 0, the wave's union warmed in thirds on
    shards 1-3.  In order:

    * the peer-served wave equals the flat wave ``flat``, reads 0 store
      blocks, and its ``peer.remote_fetches`` equal its ``peer.hits``; the
      same calls on the CPU copy give the same stack and group counters and
      directory;
    * the ``ici`` level fitted on :class:`PeerTimer` over shard 1's pool;
    * shard 1 raising: equal results, one failure and one store read per
      read of one of its blocks; shard 1 missing: equal results, no
      failure, its blocks read once from the store;
    * two waves of heat, ``OwnershipRebalancer.rebalance()`` moves every
      union block to shard 0, and the next wave serves them from shard 0's
      own tiers (no peer hit, no store read), equal;
    * a world of one (``world_of_one``): ``attach_mesh(mesh,
      peer_group=...)`` on a fresh cluster, ``fetch_remote`` serves warm ids
      byte for byte, and the mesh wave equals the flat wave;
    * an append of ``append_rows`` rows raced into a peer read of the tail
      block through ``mid_fetch_hook``: the read aborts, and the next wave
      equals a flat engine's on the grown store."""
    import torch

    from repro_torch.core.cost_model import make_cost_model
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.data.block_store import Table
    from repro_torch.data.synthetic import make_real_like_table
    from repro_torch.storage import (
        OwnershipRebalancer, TierStack, calibrate_model, make_peer_group,
    )

    nb = TierStack.block_nbytes(store)
    union = np.sort(flat.unique_blocks_fetched).astype(np.int64)
    thirds = np.array_split(union, PEER_SHARDS - 1)
    assignment = {s + 1: part.tolist() for s, part in enumerate(thirds)}
    held = {int(b): s for s, part in assignment.items() for b in part}

    def cluster(on_store, dev):
        # device_fill as on the card: two store reads a miss batch on the CPU too
        group = make_peer_group(on_store, PEER_SHARDS, hbm_bytes=hbm_bytes, device_fill=True,
                                device=dev)
        group.warm(on_store, assignment)
        return group, NeedleTailEngine(on_store, tiers=group.stacks[0], device=dev)

    def wave(eng, dev):
        sync(dev)
        t0 = time.perf_counter()
        b = eng.any_k_batch(queries, device=True)
        sync(dev)
        return b, time.perf_counter() - t0

    def state(group) -> dict:
        return {"stack": tier_state(group.stacks[0]), "group": group.stats.snapshot(),
                "owner": dict(group.owner)}

    def reads_of(b, shard: int) -> int:
        return sum(sum(held.get(int(x)) == shard for x in r.blocks_fetched) for r in b.results)

    def sequence():
        out = {}
        group, eng = cluster(store, device)
        stack = group.stacks[0]
        out["served"] = wave(eng, device)
        out["served_state"] = state(group)
        out["ici"] = calibrate_model(PeerTimer(group.stacks[1].tiers[1], device), "ici",
                                     base=make_cost_model("ici", nb))
        f0, ff0 = stack.peer_tier.failures, group.stats.failed_fetches
        group.fail_shard(1, "raise")
        out["raise"] = (*wave(eng, device), stack.peer_tier.failures - f0,
                        group.stats.failed_fetches - ff0)
        group.heal_shard(1)
        f0, rf0 = stack.peer_tier.failures, group.stats.remote_fetches
        group.fail_shard(1, "miss")
        out["miss"] = (*wave(eng, device), stack.peer_tier.failures - f0,
                       group.stats.remote_fetches - rf0)
        group.heal_shard(1)
        stack.clear()  # drop the local copies the miss wave admitted
        out["heat"] = [wave(eng, device)[1] for _ in range(2)]
        reb = OwnershipRebalancer(group, hysteresis=1.2, min_heat=0.5)
        sync(device)
        t0 = time.perf_counter()
        out["moved"] = reb.rebalance()
        sync(device)
        out["rebalance_s"] = time.perf_counter() - t0
        out["owners"] = {group.owner_of(b) for b in union}
        out["rebalanced"] = wave(eng, device)
        with world_of_one(device) as mesh:
            mgroup, meng = cluster(store, device)
            planner = meng.attach_mesh(mesh, peer_group=mgroup)
            ids = union[:3]
            got = planner.fetch_remote(ids, requester=0)
            want = store.fetch(ids)
            out["mesh_served"] = sum(
                all(torch.equal(got[int(b)][i].to(want[i].device), want[i][j]) for i in range(3))
                for j, b in enumerate(ids) if int(b) in got)
            rf0 = mgroup.stats.remote_fetches
            out["mesh"] = wave(meng, device)
            out["mesh_remote"] = mgroup.stats.remote_fetches - rf0
            del mgroup, meng, planner
        extra = make_real_like_table("airline", num_records=append_rows, seed=seed + 1)
        tail = store.num_blocks - 1  # the partial last block: any append dirties it
        group.migrate(tail, 1)  # its one host copy, if any, to shard 1, then warmed there
        group.warm(eng.store, {1: [tail]})
        fired = []

        def hook(b):
            if not fired:
                fired.append(b)
                eng.append(Table(extra.dims, extra.measures, table.cards))

        a0 = group.stats.stale_aborts
        group.mid_fetch_hook = hook
        out["race_read"] = group.fetch_block(tail, requester=0)
        group.mid_fetch_hook = None
        out["race"] = (fired, group.stats.stale_aborts - a0, group.locate(tail))
        out["grown"] = wave(eng, device)
        out["grown_flat"] = NeedleTailEngine(eng.store, device=device).any_k_batch(queries)
        return out

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out, wall, launches = run("peer", sequence)
    peak = peak_gb(device)
    served, served_s = out["served"]
    compare_waves(flat, served)
    ts = served.tier_stats
    if wave_counts(served)[:1] != wave_counts(flat)[:1] or served.store_blocks_fetched != 0 or \
            not ts["peer.hits"] > 0 or ts["peer.remote_fetches"] != ts["peer.hits"]:
        raise AssertionError(f"peer-served wave: {served.store_blocks_fetched} store blocks "
                             f"read, tier stats {ts}")
    t0 = time.perf_counter()
    cgroup, ceng = cluster(cpu_store, "cpu")
    compare_waves(served, ceng.any_k_batch(queries, device=True))
    cpu_s = time.perf_counter() - t0
    if state(cgroup) != out["served_state"]:
        raise AssertionError("the peer-served wave's counters or directory differ from the "
                             "CPU run's")
    raised, raised_s, failures, failed = out["raise"]
    compare_waves(flat, raised)
    if not 0 < failures == failed == raised.store_blocks_fetched == reads_of(raised, 1):
        raise AssertionError(f"raising shard 1: {failures} failures, {failed} refused, "
                             f"{raised.store_blocks_fetched} store blocks, "
                             f"{reads_of(raised, 1)} reads of its blocks")
    missed, missed_s, mfail, mremote = out["miss"]
    compare_waves(flat, missed)
    if mfail or missed.store_blocks_fetched != len(assignment[1]) or \
            mremote != missed.tier_stats["peer.hits"]:
        raise AssertionError(f"missing shard 1: {mfail} failures, {missed.store_blocks_fetched} "
                             f"store blocks for its {len(assignment[1])}")
    after, after_s = out["rebalanced"]
    compare_waves(flat, after)
    ta = after.tier_stats
    if out["moved"] != union.size or out["owners"] != {0} or ta["peer.hits"] or \
            after.store_blocks_fetched or not ta["dram.hits"] + ta["hbm.hits"] > 0:
        raise AssertionError(f"rebalance moved {out['moved']} of {union.size}, owners "
                             f"{out['owners']}, then tier stats {ta}")
    mesh, mesh_s = out["mesh"]
    compare_waves(flat, mesh)
    if out["mesh_served"] != 3 or mesh.store_blocks_fetched or \
            out["mesh_remote"] != mesh.tier_stats["peer.hits"]:
        raise AssertionError(f"mesh: fetch_remote served {out['mesh_served']} of 3, the wave "
                             f"read {mesh.store_blocks_fetched} store blocks")
    fired, aborts, holder = out["race"]
    if out["race_read"] is not None or not fired or aborts < 1 or holder is not None:
        raise AssertionError(f"append race: read served {out['race_read'] is not None}, "
                             f"aborts {aborts}, tail still on shard {holder}")
    grown, grown_s = out["grown"]
    compare_waves(out["grown_flat"], grown)
    ici = out["ici"]
    return {"wall": wall, "launches": launches, "union_blocks": int(union.size),
            "warmed": [len(p) for p in thirds], "block_bytes": nb,
            "walls": {"tiered_cold": tiered_walls["cold"], "tiered_warm": tiered_walls["warm"],
                      "peer_served": served_s, "raise": raised_s, "miss": missed_s,
                      "per_peer_read": served_s / ts["peer.hits"],
                      "heat_waves": out["heat"], "rebalance": out["rebalance_s"],
                      "per_migration": out["rebalance_s"] / out["moved"],
                      "rebalanced": after_s, "mesh": mesh_s, "grown": grown_s,
                      "cpu_served": cpu_s},
            "served": {"store_blocks": served.store_blocks_fetched,
                       "peer_hits": ts["peer.hits"], "remote_fetches": ts["peer.remote_fetches"],
                       "remote_bytes": out["served_state"]["group"]["remote_bytes"]},
            "raise": {"failures": failures, "store_blocks": raised.store_blocks_fetched},
            "miss": {"failures": mfail, "store_blocks": missed.store_blocks_fetched},
            "rebalance": {"moved": out["moved"], "peer_hits": ta["peer.hits"],
                          "dram_hits": ta["dram.hits"], "hbm_hits": ta["hbm.hits"]},
            "mesh": {"served": out["mesh_served"], "peer_hits": mesh.tier_stats["peer.hits"]},
            "race": {"stale_aborts": aborts, "grown_blocks": int(grown.unique_blocks_fetched.size)},
            "ici": {"seq_s": ici.seq_cost, "max_dist": ici.max_dist, "far_s": ici.far_cost,
                    "kappa_s": ici.first_block_cost, "bytes_per_s": nb / ici.seq_cost,
                    "latency_s": max(ici.far_cost - ici.seq_cost, 0.0)},
            "peak_gb": peak}


# ---------------------------------------------------------------------------
# Serving and observability: the SLO admission controller, the continuous
# exemplar, aggregate and LM slot loops of ServeEngine, and the trace plane.
# ---------------------------------------------------------------------------
SERVE_SLOTS = 16  # exemplar slots, and the admission wave cap
SERVE_SLO_S = 10.0  # the fake-clock runs' latency SLO: launches are full or refills
SERVE_REAL_SLO_S = 0.05  # the real-clock run's latency SLO
SERVE_CHEAP_COST_S = 0.007  # the cost gate: at most one far read of the hdd backing model
SERVE_TIER_GROUP = 8  # the tiered run's requests arrive in groups of this many
SERVE_RECALIBRATE_EVERY = 8
SERVE_IDLE_TICKS = 3  # held idle ticks before the tiered run's clock jumps to the deadline
AGG_SERVE_ALPHA = 0.3
AGG_SERVE_SLOTS = 4
# the solo round whose CI half-width becomes each error-SLO request's SLO;
# then one request with a modeled-I/O deadline and one without an SLO
AGG_SERVE_CI_ROUNDS = (3, 5, 8, 12, 4, 6)
AGG_SERVE_ROUNDS = 12  # max_rounds of every aggregate request
# the LM join runs: a first prompt, a joiner of the same length (it joins at
# pos == its length, so its tokens equal its solo wave's) and a shorter one
# that joins later, left-padded to pos; new tokens each; cache capacity
LM_JOIN = {"plens": (20, 20, 9), "max_new": (12, 4, 4), "max_seq": 64}
# gemma3-12b: past its 1,024 window, so the joiners' prefill rings wrap
SWA_JOIN = {"plens": (1100, 1100, 600), "max_new": (12, 4, 4), "max_seq": 1152}


class FakeClock:
    """A settable clock for the admission controller."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@contextlib.contextmanager
def count_join_flushes():
    """Count ``DeviceWave`` join flushes that seat at least one joiner (one
    combine launch each: #2, or #3 with a sharded planner)."""
    from repro_torch.core.multi_query import DeviceWave

    fn, seen = DeviceWave._flush_joins, {"flushes": 0}

    def counted(self):
        if self._joining:
            seen["flushes"] += 1
        return fn(self)

    DeviceWave._flush_joins = counted
    try:
        yield seen
    finally:
        DeviceWave._flush_joins = fn


def auto_wave(queries):
    """The wave as ``ServeEngine`` runs it: each query under ``auto``."""
    from repro_torch.core.multi_query import BatchQuery

    return [BatchQuery(q.predicates, q.k, q.op) for q in queries]


def exemplar_server(device: str, clock=None, slo_s: float = SERVE_SLO_S,
                    cheap_cost_s: float | None = None, **kw):
    from repro_torch.serving import AdmissionPolicy, ServeEngine

    return ServeEngine(None, None, max_slots=SERVE_SLOTS, device=device,
                       clock=clock or FakeClock(),
                       exemplar_policy=AdmissionPolicy(slo_s=slo_s, max_wave=SERVE_SLOTS,
                                                       cheap_cost_s=cheap_cost_s), **kw)


def compare_requests(reqs, results, what: str) -> None:
    for i, (r, res) in enumerate(zip(reqs, results)):
        if not r.done:
            raise AssertionError(f"{what}: request {i} not served")
        compare_results(r.result, res, f"{what} request {i}")


def serve_exemplar_check(store, queries, batch, run, device: str = "cuda", mesh=None) -> dict:
    """The wave's 64 queries as exemplar requests through ``ServeEngine``
    (16 slots, a fake clock): the continuous loop on the device wave
    (``run_continuous``), on the host-mirror round, the drained waves
    (``drain_exemplar_requests``) and, given ``mesh``, the device wave over
    the λ-sharded planner; each request's records equal the all-``auto``
    wave's (and, for the wave's ``auto`` queries, the wave phase's) and 8
    equal solo ``any_k``.  Launches: #2 once per join flush and #5 once a
    tick on the device wave, #2 once a tick on the host mirror, #3 once per
    flush under the mesh.  Then a real clock (SLO 50 ms) with requests
    arriving one a tick: the admission waits' p50 and p99."""
    from repro_torch.core import multi_query
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.obs import TraceRecorder

    auto = auto_wave(queries)
    ref = NeedleTailEngine(store, device=device).any_k_batch(auto, device=True)
    for i, q in enumerate(queries):
        if q.algo is None:
            compare_results(ref.results[i], batch.results[i], f"all-auto wave query {i}")
    solo = NeedleTailEngine(store, device=device)
    for i in range(min(8, len(auto))):
        compare_results(solo.any_k(auto[i].predicates, auto[i].k, auto[i].op), ref.results[i],
                        f"solo any_k of query {i}")
    out = {}

    def serve(name: str, drain: bool = False, **kw):
        engine = NeedleTailEngine(store, device=device)
        srv = exemplar_server(device, **kw)
        reqs = [srv.submit_exemplar_request(q.predicates, q.k, q.op) for q in auto]

        def go():
            with count_join_flushes() as fl, count_calls(multi_query, "_combined_matrix") as cm:
                t0 = time.perf_counter()
                done = (srv.drain_exemplar_requests(engine) if drain
                        else srv.run_continuous(engine)["exemplar"])
                sync(device)
                return done, fl["flushes"], cm["calls"], time.perf_counter() - t0

        (done, flushes, combines, secs), wall, launches = run(name, go)
        if sorted(r.rid for r in done) != [r.rid for r in reqs]:
            raise AssertionError(f"{name}: served {len(done)} of {len(reqs)} requests")
        compare_requests(reqs, ref.results, name)
        loop = srv._exemplar_loop
        ticks = loop.sched.rounds if loop is not None else 0
        res = {"wall_s": secs, "ticks": ticks, "flushes": flushes,
               "admission": dataclasses.asdict(srv.exemplar_admission.stats),
               "last_wave_stats": {k: v for k, v in srv.last_wave_stats.items()
                                   if k not in ("answered",)}}
        if loop is not None:
            res["slot_occupancy"] = loop.sched.occupancy
            res["s_per_tick"] = secs / max(ticks, 1)
        if device == "cuda":
            if drain:
                want = {"density_combine_batch": flushes}
            elif kw.get("exemplar_mesh") is not None:
                want = {"density_combine_batch_sharded": flushes, "density_combine_batch": 0}
            elif kw.get("exemplar_device"):
                want = {"density_combine_batch": flushes, "theta_stats_batch": ticks}
            else:
                want = {"density_combine_batch": combines}
            check_launches(launches, want, name)
            res["launches_checked"] = want
        out[name] = res
        return launches

    launches = serve("serve_exemplar", exemplar_device=True)
    out["launches"] = {"serve_exemplar": launches}
    out["launches"]["serve_exemplar_host"] = serve("serve_exemplar_host", exemplar_device=False)
    out["launches"]["serve_exemplar_drain"] = serve("serve_exemplar_drain", drain=True,
                                                    exemplar_device=True)
    if mesh is not None:
        out["launches"]["serve_exemplar_mesh"] = serve("serve_exemplar_mesh", exemplar_device=True,
                                                       exemplar_mesh=mesh)
    # a real clock: requests arrive one a tick, the pool claims under the
    # 50 ms SLO (full, deadline) or refills mid-wave; waits from the metrics
    rec = TraceRecorder(enabled=False)  # the metrics plane alone: no events, no clock reads
    engine = NeedleTailEngine(store, device=device)
    srv = exemplar_server(device, clock=time.monotonic, slo_s=SERVE_REAL_SLO_S,
                          exemplar_device=True, obs=rec)
    reqs = []
    t0 = time.perf_counter()
    for q in auto:
        reqs.append(srv.submit_exemplar_request(q.predicates, q.k, q.op))
        srv.step(engine)
    while not all(r.done for r in reqs):
        srv.step(engine)
    sync(device)
    compare_requests(reqs, ref.results, "serve_exemplar real clock")
    st = srv.exemplar_admission.stats
    out["ref"] = ref
    out["real_clock"] = {"wall_s": time.perf_counter() - t0,
                         "ticks": srv._exemplar_loop.sched.rounds,
                         "wait_p50_s": rec.metrics.quantile("admission.wait_s", 0.5),
                         "wait_p99_s": rec.metrics.quantile("admission.wait_s", 0.99),
                         "admission": dataclasses.asdict(st), "events": len(rec.events)}
    return out


class TierPoolClock:
    """Timing backend of tier 0 for the serving loop's periodic refits: one
    read of the given slots of the tier-0 pool (#7 on each tensor), host
    clock, synchronised.  Measures the ``hbm`` level only, so a refit moves
    placement, never the engine's plans."""

    def __init__(self, stack):
        self.stack = stack
        self.calls = 0

    def levels(self):
        return {"hbm"}

    @property
    def max_block_id(self) -> int:
        return int(self.stack.tiers[0]._pool[0].shape[0]) - 1

    def io_seconds(self, level: str, block_ids) -> float:
        import torch

        from repro_torch.kernels.plan_wave import block_gather

        d, m, v = self.stack.tiers[0]._pool
        ids = np.clip(np.asarray(list(block_ids), np.int64), 0, self.max_block_id)
        ids_t = torch.from_numpy(ids.astype(np.int32)).to(d.device)
        sync(d.device)
        t0 = time.perf_counter()
        block_gather(d, ids_t), block_gather(m, ids_t), block_gather(v.view(torch.int8), ids_t)
        sync(d.device)
        self.calls += 1
        return time.perf_counter() - t0


def serve_tiered_check(store, queries, ref, run, device: str = "cuda",
                       hbm_bytes: int = TIER_HBM_BYTES) -> dict:
    """The same requests on a tiered engine (256 MiB tier 0 over pinned
    host memory, a ``PlanLedger``, tier 0's timing backend), its plan memo
    warmed by one host-mirror wave and the tiers then cleared:
    ``exemplar_residency``, the asynchronous prefetcher, the cost gate
    (``cheap_cost_s``) and a refit every 8 ticks.  Requests arrive in
    groups of 8 on a fake clock (``drain=False``: an idle pool claims under
    the policy; after 3 held ticks the clock jumps to the deadline).  The
    records equal the all-``auto`` wave's ``ref``."""
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.plan_ledger import PlanLedger
    from repro_torch.storage import TierPrefetcher, make_tier_stack

    auto = auto_wave(queries)
    stack = make_tier_stack(hbm_bytes, None, device=device)
    timer = TierPoolClock(stack)
    eng = NeedleTailEngine(store, tiers=stack, ledger=PlanLedger(), timing_backend=timer,
                           device=device)
    eng.any_k_batch(auto, device=False)  # the host mirror memoizes round 0's plans
    stack.clear()
    clk = FakeClock()
    srv = exemplar_server(device, clock=clk, cheap_cost_s=SERVE_CHEAP_COST_S,
                          exemplar_device=True, exemplar_residency=True, exemplar_prefetch=True,
                          recalibrate_every=SERVE_RECALIBRATE_EVERY)
    pf = TierPrefetcher(eng, max_blocks=PREFETCH_MAX_BLOCKS, async_fetch=True)
    srv._prefetcher = (eng, pf)  # the loop's prefetcher, in its asynchronous mode
    refits = []
    recal = eng.recalibrate
    eng.recalibrate = lambda **kw: refits.append(sorted(recal(**kw))) or refits[-1]

    def go():
        reqs, ticks, jumps = [], 0, 0
        t0 = time.perf_counter()
        for lo in range(0, len(auto), SERVE_TIER_GROUP):
            group = [srv.submit_exemplar_request(q.predicates, q.k, q.op)
                     for q in auto[lo:lo + SERVE_TIER_GROUP]]
            reqs += group
            held = 0
            while not all(r.done for r in group):
                srv.exemplar_tick(eng)
                ticks += 1
                clk.advance(0.001)
                idle = srv._exemplar_loop.sched.busy == 0 and srv.exemplar_admission.pending
                held = held + 1 if idle else 0
                if held >= SERVE_IDLE_TICKS:
                    clk.advance(SERVE_SLO_S)
                    jumps += 1
                    held = 0
        pf.drain(wait=True)
        sync(device)
        return reqs, ticks, jumps, time.perf_counter() - t0

    (reqs, ticks, jumps, secs), wall, launches = run("serve_tiered", go)
    compare_requests(reqs, ref.results, "serve_tiered")
    st = srv.exemplar_admission.stats
    return {"wall_s": secs, "ticks": ticks, "deadline_jumps": jumps,
            "slot_occupancy": srv._exemplar_loop.sched.occupancy,
            "launch_reasons": {k: getattr(st, k) for k in (
                "full_waves", "deadline_waves", "resident_waves", "cheap_waves", "refill_waves")},
            "last_cost_price_s": srv.exemplar_admission.last_cost_price_s,
            "prefetch": pf.stats.snapshot(), "refits": len(refits), "timer_calls": timer.calls,
            "plan_qerror": srv.last_wave_stats["plan_qerror"],
            "tiers": stack.tier_counters(), "launches": launches}


def aggregate_plan(store, queries, seed: int, device: str = "cuda") -> list[dict]:
    """Eight aggregate requests over the wave's first 8 predicate sets
    (measure 0, k 20,000, α 0.3, seeds ``seed + i``), with each request's
    solo stream on a fresh engine on ``device`` for ``AGG_SERVE_ROUNDS``
    rounds and its chunks' prices: six error SLOs at the solo half-width of
    round ``AGG_SERVE_CI_ROUNDS[i]``, one modeled-I/O deadline two and a
    half chunks past its first, one without an SLO."""
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.online_agg import AggregateQuery, OnlineAggregator
    from repro_torch.storage.prefetch import effective_block_cost

    plans = []
    for i, q in enumerate(queries[:8]):
        eng = NeedleTailEngine(store, device=device)
        aq = AggregateQuery(q.predicates, 0, AGG_K, AGG_SERVE_ALPHA, op=q.op, seed=seed + i)
        agg = OnlineAggregator(eng, aq, chunk_blocks=AGG_CHUNK)
        stream, widths, prices = [], [], []
        for _ in range(AGG_SERVE_ROUNDS):
            prices.append(effective_block_cost(eng, agg.next_blocks()))
            stream.append(agg.fold())
            widths.append(agg.halfwidth())
            if agg.exhausted:
                break
        agg.close()
        plan = {"query": aq, "stream": stream, "widths": widths, "error_slo": None,
                "deadline_s": None}
        if i < len(AGG_SERVE_CI_ROUNDS):
            plan["error_slo"] = widths[min(AGG_SERVE_CI_ROUNDS[i], len(widths)) - 1]
        elif i == len(AGG_SERVE_CI_ROUNDS):
            plan["deadline_s"] = prices[0] + 2.5 * max(prices[1:3], default=prices[0])
        plans.append(plan)
    return plans


def submit_aggregates(srv, plans) -> list:
    return [srv.submit_aggregate_request(
        p["query"].predicates, 0, AGG_K, op=p["query"].op, error_slo=p["error_slo"],
        deadline_s=p["deadline_s"], alpha=AGG_SERVE_ALPHA, seed=p["query"].seed,
        chunk_blocks=AGG_CHUNK, max_rounds=AGG_SERVE_ROUNDS) for p in plans]


def check_aggregate_streams(reqs, plans, what: str) -> None:
    for r, p in zip(reqs, plans):
        if not r.done or r.stream != p["stream"][:r.rounds] or r.result is not r.stream[-1]:
            raise AssertionError(f"{what}: request {r.rid}'s stream differs from its solo run")
        if p["deadline_s"] is not None and r.spent_io_s > p["deadline_s"]:
            raise AssertionError(f"{what}: request {r.rid} spent past its deadline")


def serve_aggregate_check(store, cpu_store, queries, run, seed: int,
                          device: str = "cuda") -> dict:
    """Eight aggregate requests (:func:`aggregate_plan`) through the
    continuous aggregate pool of 4 slots (``run_continuous``): each
    request's per-round stream equals its solo run on a fresh card engine
    (``==``) and on the CPU copy (within ``RTOL``); the error SLOs answer
    ``"ci"``, one mid-wave (its slot refilled), and the deadline request
    never spends past its budget."""
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.online_agg import OnlineAggregator
    from repro_torch.serving import AdmissionPolicy, ServeEngine

    plans = aggregate_plan(store, queries, seed, device)
    eng = NeedleTailEngine(store, device=device)
    srv = ServeEngine(None, None, max_slots=AGG_SERVE_SLOTS, device=device, clock=FakeClock(),
                      aggregate_policy=AdmissionPolicy(slo_s=SERVE_SLO_S, max_wave=AGG_SERVE_SLOTS))
    reqs = submit_aggregates(srv, plans)

    def go():
        t0 = time.perf_counter()
        done = srv.run_continuous(eng)["aggregate"]
        sync(device)
        return done, time.perf_counter() - t0

    (done, secs), wall, launches = run("serve_aggregate", go)
    if sorted(r.rid for r in done) != [r.rid for r in reqs]:
        raise AssertionError("serve_aggregate: not every request was answered")
    check_aggregate_streams(reqs, plans, "serve_aggregate")
    ci = [r for r, p in zip(reqs, plans) if p["error_slo"] is not None]
    if any(r.reason != "ci" for r in ci):
        raise AssertionError(f"serve_aggregate: error SLOs answered {[r.reason for r in ci]}")
    if srv.aggregate_admission.stats.refill_waves < 1:
        raise AssertionError("serve_aggregate: no slot was freed and refilled mid-wave")
    cpu = NeedleTailEngine(cpu_store, device="cpu")
    bit_equal = 0
    for r, p in zip(reqs, plans):
        agg = OnlineAggregator(cpu, p["query"], chunk_blocks=AGG_CHUNK)
        cstream = [agg.fold() for _ in range(r.rounds)]
        agg.close()
        for a, b in zip(r.stream, cstream):
            if not all(np.isclose(getattr(a, f), getattr(b, f), rtol=RTOL, atol=0.0)
                       for f in ("total", "mean", "var_total", "var_mean")):
                raise AssertionError(f"serve_aggregate: request {r.rid} differs from the CPU")
        bit_equal += r.stream == cstream
    return {"wall_s": secs, "ticks": srv._aggregate_loop.sched.rounds,
            "slot_occupancy": srv._aggregate_loop.sched.occupancy,
            "answers": [{"rid": r.rid, "reason": r.reason, "rounds": r.rounds,
                         "halfwidth": r.result.ci_halfwidth(), "mean": r.result.mean,
                         "spent_io_s": r.spent_io_s, "error_slo": p["error_slo"],
                         "deadline_s": p["deadline_s"]} for r, p in zip(reqs, plans)],
            "admission": dataclasses.asdict(srv.aggregate_admission.stats),
            "cpu_bit_equal": bit_equal, "plans": plans, "launches": launches}


def lm_join_run(model, join: dict, prompts, impl: str):
    """A first prompt prefilled alone, then the others submitted: each joins
    the live wave when a slot is free and its prompt fits ``pos``.  The
    second joins the next tick, at ``pos`` equal to its length."""
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(model.cfg, model, max_slots=2, max_seq=join["max_seq"], impl=impl,
                      device=model.device)
    first = eng.submit(prompts[0], max_new_tokens=join["max_new"][0])
    eng.lm_tick()
    rest = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts[1:], join["max_new"][1:])]
    eng.run_continuous()
    joins = [t["joiners"] for t in eng.lm_tick_stats[1:] if t["joiners"]]
    if eng.lm_tick_stats[1]["joiners"] != 1 or len(joins) < len(rest):
        raise AssertionError(f"{model.cfg.name}: joiners seated at ticks {joins}, not one each")
    return eng, [first, *rest]


def lm_prefills(eng) -> int:
    """Prefills of a continuous run: the first wave's and each joiners'."""
    return sum(1 for t in eng.lm_tick_stats if t["joiners"])


def lm_tick_times(eng, wall: float) -> dict:
    pre = [t["prefill_s"] for t in eng.lm_tick_stats if t["joiners"]]
    dec = [t["decode_s"] for t in eng.lm_tick_stats if t["active"]]
    new = sum(t["active"] for t in eng.lm_tick_stats) + sum(
        t["joiners"] for t in eng.lm_tick_stats)
    return {"ticks": len(eng.lm_tick_stats), "prefills": len(pre),
            "prefill_s_per_tick": float(np.mean(pre)) if pre else 0.0,
            "decode_s_per_tick": float(np.mean(dec)) if dec else 0.0,
            "tokens": new, "tokens_per_s": new / wall if wall > 0 else None}


def lm_continuous_check(model, join: dict, seed: int, run, phase: str,
                        traffic: dict | None = None) -> dict:
    """``run_continuous`` on ``model`` through ``run`` as ``phase``, with the
    kernels: ``traffic`` (the launcher's) when given, and the join run
    (:func:`lm_join_run`); each again with ``impl="plain"``, tokens equal
    but for counted near-ties.  #8 and #9 launch once per attention and
    Mamba sublayer a prefill.  The joiner whose prompt length equals
    ``pos`` gives its solo wave's tokens.  A MoE model's streams are
    compared before each request's first routing flip (each run's routing
    recorded apart, :func:`routing_flips`)."""
    cfg = model.cfg
    prompts = serve_prompts(cfg, traffic, seed) if traffic else []
    rng = np.random.default_rng(seed + 1)
    jp = [rng.integers(0, cfg.vocab, n) for n in join["plens"]]
    logs = {}

    def continuous(impl):
        out = {}
        if traffic:
            from repro_torch.serving import ServeEngine

            eng = ServeEngine(cfg, model, max_slots=traffic["slots"], max_seq=traffic["max_seq"],
                              impl=impl, device=model.device)
            reqs = [eng.submit(p, max_new_tokens=traffic["max_new"]) for p in prompts]
            t0 = time.perf_counter()
            with logs.setdefault((impl, "traffic"), RouterLog()).record():
                eng.run_continuous()
            sync(model.device)
            out["traffic"] = (eng, reqs, time.perf_counter() - t0)
        t0 = time.perf_counter()
        with logs.setdefault((impl, "join"), RouterLog()).record():
            jeng, jreqs = lm_join_run(model, join, jp, impl)
        sync(model.device)
        out["join"] = (jeng, jreqs, time.perf_counter() - t0)
        return out

    import torch

    with torch.inference_mode():
        kern, wall, launches = run(phase, lambda: continuous("kernel"))
        prefills = sum(lm_prefills(e) for e, _, _ in kern.values())
        check_launches(launches, {k: n * prefills for k, n in lm_layer_counts(cfg).items()}, phase)
        plain = continuous("plain")
        from repro_torch.serving import ServeEngine

        solo = ServeEngine(cfg, model, max_slots=2, max_seq=join["max_seq"], device=model.device)
        solo.submit(jp[1], max_new_tokens=join["max_new"][1])
        solo_req = solo.run_until_drained()[0]
    res = {"wall_s": wall, "launches": launches, "prefills": prefills}
    for name, (eng, reqs, secs) in kern.items():
        routing = routing_flips(logs["kernel", name], logs["plain", name])
        res[name] = {"kernel": lm_tick_times(eng, secs),
                     "plain": lm_tick_times(plain[name][0], plain[name][2]),
                     "streams": compare_streams(reqs, plain[name][1], LM_ATOL,
                                                routing["first_token"]),
                     "routing": {k: v for k, v in routing.items()
                                 if k not in ("first_pos", "first_token")}}
    res["join"]["joiner_vs_solo"] = compare_streams([kern["join"][1][1]], [solo_req], LM_ATOL)
    res["join"]["joiners_at_ticks"] = [i for i, t in enumerate(kern["join"][0].lm_tick_stats)
                                       if i and t["joiners"]]
    return res


def obs_check(store, queries, plans, run, device: str = "cuda") -> dict:
    """One continuous run of the 64 exemplar requests and the 8 aggregate
    requests traced by a ``TraceRecorder``, beside the same run untraced:
    records, streams, reasons and rounds identical.  The export goes
    through the unchanged ``tools/trace_report.py`` (a subprocess, exit 0),
    which must reconstruct one completed path per request."""
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.obs import TraceRecorder
    from repro_torch.serving import AdmissionPolicy

    auto = auto_wave(queries)
    repo = Path(__file__).resolve().parent

    def serve(rec):
        eng = NeedleTailEngine(store, device=device)
        srv = exemplar_server(device, exemplar_device=True, obs=rec,
                              aggregate_policy=AdmissionPolicy(slo_s=SERVE_SLO_S,
                                                               max_wave=SERVE_SLOTS))
        ex = [srv.submit_exemplar_request(q.predicates, q.k, q.op) for q in auto]
        ag = submit_aggregates(srv, plans)
        t0 = time.perf_counter()
        srv.run_continuous(eng)
        sync(device)
        return srv, ex, ag, time.perf_counter() - t0

    rec = TraceRecorder()
    (srv, ex, ag, secs), wall, launches = run("obs", lambda: serve(rec))
    _, pex, pag, psecs = serve(None)
    for i, (a, b) in enumerate(zip(ex, pex)):
        compare_results(a.result, b.result, f"obs exemplar {i} traced vs untraced")
    for a, b in zip(ag, pag):
        if (a.stream, a.reason, a.rounds) != (b.stream, b.reason, b.rounds):
            raise AssertionError(f"obs: aggregate {a.rid} traced differs from untraced")
    check_aggregate_streams(ag, plans, "obs")
    sys.path.insert(0, str(repo))
    from tools.trace_report import load_events, request_paths

    with tempfile.TemporaryDirectory() as tmp:
        path = rec.export_jsonl(str(Path(tmp) / "trace.jsonl"))
        report = subprocess.run([sys.executable, str(repo / "tools" / "trace_report.py"), path,
                                 "--requests", "4"], capture_output=True, text=True, timeout=300)
        if report.returncode != 0:
            raise AssertionError(f"trace_report exited {report.returncode}: {report.stderr}")
        head = report.stdout.splitlines()[0]
        paths = request_paths(load_events(path))
    want = len(ex) + len(ag)
    if head != f"trace: {len(rec.events)} events, {want} completed requests" or \
            sorted(paths) != sorted(r.rid for r in ex + ag) or rec.dropped:
        raise AssertionError(f"trace_report: {head!r} for {want} requests, {rec.dropped} dropped")
    cov = [p["coverage"] for p in paths.values()]
    return {"traced_s": secs, "untraced_s": psecs, "events": len(rec.events),
            "dropped": rec.dropped, "report": head,
            "coverage": {q: float(np.quantile(cov, q)) for q in (0.0, 0.5, 0.99)},
            "prometheus_lines": len(rec.metrics.render_prometheus().splitlines()),
            "wait_p50_s": rec.metrics.quantile("admission.wait_s", 0.5),
            "wait_p99_s": rec.metrics.quantile("admission.wait_s", 0.99),
            "report_lines": report.stdout.splitlines()[:12], "launches": launches}


def lm_continuous_phase(model, phase: str, join: dict, seed: int, phase_launches: dict,
                        traffic: dict | None = None) -> None:
    """:func:`lm_continuous_check` on ``model``, logged."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = lm_continuous_check(model, join, seed, run_phase, phase, traffic)
    add_launches(phase_launches, phase, res.pop("launches"))
    for name in ("traffic", "join"):
        if name in res:
            log(f"{phase} {model.cfg.name} {name}: {res.pop(name)}")
    log(f"{phase}: {res}; kernel tokens == plain but for counted near-ties, the joiner at pos "
        f"== its solo wave; peak {peak_gb('cuda'):.2f} GB; {time.perf_counter() - t0:.1f} s "
        "in all")


# ---------------------------------------------------------------------------
# Training on one card: the NeedleTail-filtered pipeline, the launcher with a
# crash and a restart, the learnable pattern, one step of every family.
# ---------------------------------------------------------------------------

class TrainCrash(Exception):
    """Raised into the launcher to stop a run as a crash would."""


def timed(fn, sink: list, dev):
    """``fn`` with each call's host-clock seconds appended to ``sink``, the
    device synchronised before and after."""
    def call(*args, **kwargs):
        sync(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(dev)
        sink.append(time.perf_counter() - t0)
        return out
    return call


def train_stream_check(store, tokens, cpu_store, cpu_tokens, run, batches: int = TRAIN_STREAM_BATCHES,
                       cap: int = TRAIN_STREAM_CAP) -> dict:
    """``FilteredBatchStream`` on the card under each of ``TRAIN_FILTERS``
    beside the same stream on the CPU copy: ``batches`` batches of
    ``TRAIN_BATCH``, the last filter on past its first epoch reset (asserted)
    and ``batches`` more.  Every batch's ``record_ids`` equal the CPU
    stream's, every record matches its filter on the host table, the first
    batches' tokens are the CPU's, and the host state (consumed mask, round,
    rng counter, buffer) equals the CPU stream's at the end."""
    from repro_torch.data.pipeline import FilteredBatchStream, parse_filter

    dev = store.device
    dims = cpu_store.dims.reshape(-1, cpu_store.dims.shape[-1]).numpy()
    out = {}

    def drive():
        for i, expr in enumerate(TRAIN_FILTERS):
            preds = parse_filter(expr)
            card = FilteredBatchStream(store, tokens, preds, TRAIN_BATCH, seed=i)
            cpu = FilteredBatchStream(cpu_store, cpu_tokens, preds, TRAIN_BATCH, seed=i)
            last = i == len(TRAIN_FILTERS) - 1
            n, reset_at, secs = 0, None, []
            while n < batches or (last and (reset_at is None or n < reset_at + batches)):
                if n >= cap:
                    raise AssertionError(f"{expr}: no epoch reset in {cap} batches")
                sync(dev)
                t0 = time.perf_counter()
                a = next(card)
                sync(dev)
                secs.append(time.perf_counter() - t0)
                b = next(cpu)
                if not np.array_equal(a["record_ids"], b["record_ids"]):
                    raise AssertionError(f"{expr} batch {n}: record ids differ from the CPU's")
                for attr, val in preds:
                    if not np.all(dims[a["record_ids"], attr] == val):
                        raise AssertionError(f"{expr} batch {n}: a record misses the filter")
                if n < 4 and not (np.array_equal(a["tokens"].cpu().numpy(), b["tokens"].numpy())
                                  and np.array_equal(a["labels"].cpu().numpy(),
                                                     b["labels"].numpy())):
                    raise AssertionError(f"{expr} batch {n}: tokens differ from the CPU's")
                if reset_at is None and card.state.round >= 1:
                    reset_at = n
                n += 1
            if last and reset_at is None:
                raise AssertionError(f"{expr}: no epoch reset")
            same = (np.array_equal(card.state.consumed, cpu.state.consumed)
                    and (card.state.round, card.state.rng_counter, card._buffer)
                    == (cpu.state.round, cpu.state.rng_counter, cpu._buffer))
            if not same:
                raise AssertionError(f"{expr}: the pipeline state differs from the CPU's")
            out[expr] = {"batches": n, "epoch_reset_at": reset_at, "rounds": card.state.round,
                         "refills": card.state.rng_counter,
                         "s_per_batch_median": float(np.median(secs)),
                         "s_all_batches": float(np.sum(secs))}
        return out

    res, wall, launches = run("train_stream", drive)
    return {"filters": res, "wall_s": wall, "launches": launches}


def train_check(run, device: str = "cuda", arch: str = TRAIN_ARCH, reduced: bool = False,
                corpus_seqs: int = TRAIN_CORPUS["num_seqs"], batch: int = TRAIN_BATCH,
                steps: int = TRAIN_RUN["steps"], every: int = TRAIN_RUN["ckpt_every"],
                seq: int = TRAIN_RUN["seq"], expr: str = TRAIN_RUN["filter"]) -> dict:
    """``repro_torch.launch.train.main`` for ``steps`` steps with a
    checkpoint every ``every`` into one directory; then into a second
    directory a run that crashes after its step-``every`` commit
    (``TrainCrash`` raised from the stream's next call) and a resumed run to
    ``steps``.  The resumed loss equals the uninterrupted one within
    ``TRAIN_RESTART_RTOL``, and the pipeline state both saved at ``steps``
    is identical.  Timed in the uninterrupted run (host clock, synchronised):
    each ``next(stream)``, its refills and each train step."""
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.data.pipeline import FilteredBatchStream
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as T

    dev = torch.device(device)
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--filter", expr, "--corpus-seqs", str(corpus_seqs), "--ckpt-every", str(every),
            "--log-every", str(every), "--seed", "0", "--device", device]
    argv += ["--reduced"] if reduced else []
    t = {"next": [], "refill": [], "step": []}

    def timed_factory(make):
        return lambda *a, **k: timed(make(*a, **k), t["step"], dev)

    def crash_after(n: int):
        calls = {"n": 0}

        def make(fn):
            def nxt(stream):
                calls["n"] += 1
                if calls["n"] > n:
                    raise TrainCrash(f"crashed after {n} batches")
                return fn(stream)
            return nxt
        return make

    with tempfile.TemporaryDirectory() as tmp:
        a, b = f"{tmp}/a", f"{tmp}/b"
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with patched(FilteredBatchStream, "__next__", lambda fn: timed(fn, t["next"], dev)), \
                patched(FilteredBatchStream, "_refill", lambda fn: timed(fn, t["refill"], dev)), \
                patched(S, "make_train_step", timed_factory):
            loss, wall, launches = run("train", lambda: T.main(argv + ["--ckpt-dir", a]))
        peak = peak_gb(dev)
        with patched(FilteredBatchStream, "__next__", crash_after(every)):
            try:
                T.main(argv + ["--ckpt-dir", b])
                raise AssertionError("the crash run did not crash")
            except TrainCrash:
                pass
        if latest_step(b) != every:
            raise AssertionError(f"the crash run committed step {latest_step(b)}, not {every}")
        resumed, rwall, rlaunches = run("train", lambda: T.main(argv + ["--ckpt-dir", b]))
        ea, eb = CheckpointManager(a).extra(steps), CheckpointManager(b).extra(steps)
    rel = abs(resumed - loss) / abs(loss)
    if not (np.isfinite(loss) and rel <= TRAIN_RESTART_RTOL):
        raise AssertionError(f"resumed loss {resumed} vs uninterrupted {loss}: rel {rel}")
    if ea != eb:
        raise AssertionError("the pipeline state at the last step differs after the restart")
    step_s = [n + s for n, s in zip(t["next"], t["step"])]
    steady = step_s[1:] or step_s
    return {"loss": loss, "resumed_loss": resumed, "rel": rel, "wall_s": wall,
            "resumed_wall_s": rwall, "first_step_s": step_s[0],
            "s_per_step": float(np.mean(steady)), "s_per_step_median": float(np.median(steady)),
            "refill_share": float(np.sum(t["refill"]) / np.sum(step_s)),
            "refills": len(t["refill"]), "tokens_per_s": batch * seq / float(np.mean(steady)),
            "peak_gb": peak, "pipeline_round": ea["pipeline"]["round"],
            "pipeline_rng_counter": ea["pipeline"]["rng_counter"],
            "launches": launches, "resumed_launches": rlaunches}


def train_learns_check(cfg, run, seed: int, device: str = "cuda") -> dict:
    """``make_train_step(cfg, peak_lr=3e-3, warmup=2, total_steps=60)`` for
    30 steps on ``tests/test_models.py``'s learnable batch (a tiled
    ``arange(16)``, ``[4, 47]``): the last loss below 0.6 × the first."""
    import torch

    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.models import init_params

    lr = {k: TRAIN_LEARN[k] for k in ("peak_lr", "warmup", "total_steps")}

    def drive():
        state = make_train_state(init_params(cfg, seed, device=device))
        step_fn = make_train_step(cfg, **lr)
        toks = torch.arange(16, dtype=torch.int32, device=device).tile(4, 4)[:, :48]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        losses = []
        for _ in range(TRAIN_LEARN["steps"]):
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
        return losses

    losses, wall, launches = run("train_learns", drive)
    if not losses[-1] < TRAIN_LEARN["ratio"] * losses[0]:
        raise AssertionError(f"the loss fell from {losses[0]} only to {losses[-1]}")
    return {"first": losses[0], "last": losses[-1], "every_6th": losses[::6], "wall_s": wall,
            "s_per_step": wall / len(losses)}


def train_profile(cfg, seed: int) -> None:
    """One train step of ``cfg`` at ``[TRAIN_BATCH, TRAIN_RUN["seq"]]`` on
    seeded tokens, after two warm steps, under ``torch.profiler``
    (``--profile``): device time by operator and the device's busy share."""
    import torch

    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.models import init_params

    state = make_train_state(init_params(cfg, seed, device="cuda"))
    step_fn = make_train_step(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_RUN["seq"] + 1), generator=g,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for _ in range(2):
        state, _ = step_fn(state, batch)
    profile_wave(lambda: step_fn(state, batch),
                 f"train step {cfg.name} {list(batch['tokens'].shape)}")


def train_archs_check(run, seed: int, device: str = "cuda", ref_device: str = "cpu") -> dict:
    """One ``make_train_step`` step of every configuration at ``reduced()``
    on ``device`` beside the same step on ``ref_device`` from the same
    parameters and batch: loss and grad norm finite, the loss within
    ``TRAIN_ARCHS_LOSS_RTOL``, every updated parameter within
    ``TRAIN_ARCHS_PARAM_RTOL·|p| + TRAIN_ARCHS_PARAM_LR·lr``, or ``2·lr``
    more where its gradient lies at its leaf's rounding floor (counted)."""
    import copy

    import torch

    from repro_torch.configs import get_config, list_archs, reduced
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.models import init_params

    b, s, lr = TRAIN_ARCHS["batch"], TRAIN_ARCHS["seq"], TRAIN_ARCHS["peak_lr"]

    def drive():
        out = {}
        for arch in list_archs():
            cfg = reduced(get_config(arch))
            ref = init_params(cfg, seed, device=ref_device)
            states = {d: make_train_state(copy.deepcopy(ref).to(d)) for d in (device, ref_device)}
            rng = np.random.default_rng(seed)
            arrays = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
                      "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
            if cfg.family == "encdec":
                arrays["enc_frames"] = (rng.normal(size=(b, cfg.enc_seq, cfg.d_model)) * 0.02
                                        ).astype(np.float32)
            if cfg.family == "vlm":
                arrays["patch_embeds"] = (rng.normal(size=(b, cfg.num_patches, cfg.d_model))
                                          * 0.02).astype(np.float32)
            step = make_train_step(cfg, peak_lr=lr, warmup=0, total_steps=10)
            mets = {}
            for d, st in states.items():
                states[d], m = step(st, {k: torch.from_numpy(v).to(d) for k, v in arrays.items()})
                mets[d] = {k: float(v) for k, v in m.items()}
            got, want = mets[device], mets[ref_device]
            if not all(np.isfinite(v) for m in mets.values() for v in m.values()):
                raise AssertionError(f"{arch}: a non-finite loss or grad norm: {mets}")
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            if rel > TRAIN_ARCHS_LOSS_RTOL or got["lr"] != float(np.float32(lr)):
                raise AssertionError(f"{arch}: loss {got['loss']} vs {want['loss']} (rel {rel})")
            worst, worst_floor, floor = 0.0, 0.0, 0
            pa = dict(states[device].model.named_parameters())
            for n, p in states[ref_device].model.named_parameters():
                q, p = pa[n].detach().cpu(), p.detach()
                m = states[ref_device].opt.m[n].abs()  # (1 − b1)·g after one step
                at_floor = (m <= TRAIN_ARCHS_FLOOR * m.max()) & (m > 0)
                tol = (TRAIN_ARCHS_PARAM_RTOL * p.abs() + TRAIN_ARCHS_PARAM_LR * lr
                       + 2 * lr * at_floor)
                err = (q - p).abs()
                if bool((err > tol).any()):
                    raise AssertionError(f"{arch} {n}: updated parameter off by {float(err.max())}")
                over = (err - TRAIN_ARCHS_PARAM_RTOL * p.abs()) / lr
                worst = max(worst, float(torch.where(at_floor, 0.0, over).max()))
                worst_floor = max(worst_floor, float(torch.where(at_floor, over, 0.0).max()))
                floor += int(at_floor.sum())
            out[arch] = {"loss": got["loss"], "loss_rel": rel, "grad_norm": got["grad_norm"],
                         "grad_norm_rel": abs(got["grad_norm"] - want["grad_norm"])
                         / want["grad_norm"], "param_err_over_lr": worst, "at_floor": floor,
                         "at_floor_err_over_lr": worst_floor}
        return out

    res, wall, launches = run("train_archs", drive)
    return {"archs": res, "wall_s": wall}


def train_phases(args, card: str, phase_launches: dict) -> None:
    """The training phases on the card, each logged beside the card's name
    and power limit: train_stream, train, train_learns, train_archs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_token_corpus

    t0 = time.perf_counter()
    cstore, ctokens = make_token_corpus(**TRAIN_CORPUS, vocab=get_config(TRAIN_ARCH).vocab,
                                        seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"train corpus: {TRAIN_CORPUS['num_seqs']} sequences of {TRAIN_CORPUS['seq_len']} "
        f"tokens, λ={cstore.num_blocks}, {ctokens.numel() * 4 / 1e9:.2f} GB of tokens on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ts = train_stream_check(cstore, ctokens, cstore.to("cpu"), ctokens.cpu(), run_phase)
    phase_launches["train_stream"] = ts.pop("launches")
    for expr, r in ts.pop("filters").items():
        log(f"train_stream {expr!r}: {r}")
    log(f"train_stream: {ts}; every batch's record ids == the CPU stream's, every record "
        f"matches its filter; {time.perf_counter() - t0:.1f} s in all ({card})")
    del cstore, ctokens
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tr = train_check(run_phase)
    phase_launches["train"] = tr.pop("launches")
    add_launches(phase_launches, "train", tr.pop("resumed_launches"))
    log(f"train {TRAIN_ARCH} full width [{TRAIN_BATCH}, {TRAIN_RUN['seq']}], "
        f"{TRAIN_RUN['steps']} steps, filter {TRAIN_RUN['filter']!r}: {tr}; resumed == "
        f"uninterrupted within {TRAIN_RESTART_RTOL}, pipeline state identical; "
        f"{time.perf_counter() - t0:.1f} s in all ({card})")
    if args.profile:
        train_profile(get_config(TRAIN_ARCH), args.seed)
    t0 = time.perf_counter()
    tl = train_learns_check(get_config(TRAIN_ARCH), run_phase, args.seed)
    log(f"train_learns {TRAIN_ARCH} full width: {tl}; {time.perf_counter() - t0:.1f} s in all "
        f"({card})")
    t0 = time.perf_counter()
    ta = train_archs_check(run_phase, args.seed)
    for arch, r in ta.pop("archs").items():
        log(f"train_archs {arch}: {r}")
    log(f"train_archs: {ta}; loss within {TRAIN_ARCHS_LOSS_RTOL} of the CPU step's, every "
        f"parameter within tolerance; {time.perf_counter() - t0:.1f} s in all ({card})")
    torch.cuda.empty_cache()


def shard_plan(device: str = "cuda", small: bool = False) -> SimpleNamespace:
    """What the sharded LM phases run: the card's configurations, or
    ``small`` ones for a rehearsal of the phases on the CPU (reduced
    configs, a short batch, ``impl="kernel"`` taking the plain branches)."""
    from repro_torch.configs import get_config, reduced

    if small:
        zcfg = reduced(get_config(LM_ARCH))
        return SimpleNamespace(
            device=device, small=True, train_cfg=reduced(get_config(TRAIN_ARCH)), batch=4,
            seq=32, serve_cfg=zcfg, cut_cfg=zcfg,
            traffic={"requests": 4, "plen": (4, 10), "max_new": 4, "slots": 4, "max_seq": 24},
            dryrun_cell=(TRAIN_ARCH, "decode_32k"))
    return SimpleNamespace(
        device=device, small=False, train_cfg=get_config(TRAIN_ARCH),
        batch=SHARD_TRAIN["batch"], seq=SHARD_TRAIN["seq"], serve_cfg=get_config(LM_ARCH),
        cut_cfg=dataclasses.replace(get_config(LM_ARCH), num_layers=SHARD_ZAMBA_LAYERS),
        traffic=SERVE_TRAFFIC["launcher"], dryrun_cell=(TRAIN_ARCH, "train_4k"))


def on_card(dev) -> bool:
    import torch

    return torch.device(dev).type == "cuda"


def reset_peak(dev) -> None:
    import torch

    if on_card(dev):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def shard_train_step(plan, seed: int, mesh=None, layout: str = "tp_sp", count=False):
    """One train step of ``plan.train_cfg`` (parameters from ``seed``) on a
    seeded ``[batch, seq]`` draw, sharded on ``mesh`` by ``layout`` when
    given.  Returns ``(state, metrics, seconds, collectives)``; ``count``
    runs the step under the dry run's dispatch counter (collective counts
    and bytes)."""
    import torch

    from repro_torch.distributed import sharding as S
    from repro_torch.launch import steps as ST
    from repro_torch.launch.dryrun import DeviceCounter
    from repro_torch.models import init_params

    cfg, dev = plan.train_cfg, plan.device
    model = init_params(cfg, seed, device=dev)
    rules = None
    if mesh is not None:
        S.distribute_params(model, mesh, S.param_specs(model, mesh, layout))
        rules = S.make_rules(mesh, layout)
    state = ST.make_train_state(model)
    step = ST.make_train_step(cfg, peak_lr=SHARD_TRAIN["peak_lr"], warmup=0, rules=rules)
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    toks = torch.randint(0, cfg.vocab, (plan.batch, plan.seq + 1), generator=g, device=dev)
    counter = DeviceCounter()
    sync(dev)
    t0 = time.perf_counter()
    with counter if count else contextlib.nullcontext():
        state, m = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    sync(dev)
    return state, m, time.perf_counter() - t0, counter.collectives


def whole(t):
    """``t``, gathered when a DTensor."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()


def param_errors(state, ref: dict) -> dict:
    """``state``'s updated parameters against the unsharded step's
    (``ref``: its parameters and first moments, whole): the worst error over
    lr of ordinary elements and of the elements whose gradient lies at its
    leaf's rounding floor, and how many lie there."""
    import torch

    lr = SHARD_TRAIN["peak_lr"]
    worst, worst_floor, floor = 0.0, 0.0, 0
    for n, p in state.model.named_parameters():
        p = whole(p)
        m = ref["m"][n].to(p.device).abs()  # (1 − b1)·g after one step
        at_floor = (m <= TRAIN_ARCHS_FLOOR * m.max()) & (m > 0)
        over = (p - ref["params"][n].to(p.device)).abs() / lr
        worst = max(worst, float(torch.where(at_floor, 0.0, over).max()))
        worst_floor = max(worst_floor, float(torch.where(at_floor, over, 0.0).max()))
        floor += int(at_floor.sum())
    return {"param_err_over_lr": worst, "at_floor": floor, "at_floor_err_over_lr": worst_floor}


def params_ok(e: dict) -> bool:
    return (e["param_err_over_lr"] <= SHARD_PARAM_LR
            and e["at_floor_err_over_lr"] <= 2 + SHARD_PARAM_LR)


def requests_json(done) -> list[dict]:
    return [{"rid": r.rid, "out_tokens": r.out_tokens, "top2_gap": r.top2_gap} for r in done]


def sharded_engine(model, cfg, traffic: dict, prompts, dev, rules):
    """``prompts`` drained through ``ServeEngine(rules=...)`` with the kernels."""
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(cfg, model, max_slots=traffic["slots"], max_seq=traffic["max_seq"],
                      impl="kernel", device=dev, rules=rules)
    for p in prompts:
        eng.submit(p, max_new_tokens=traffic["max_new"])
    return eng, eng.run_until_drained()


def lm_sharded_check(args, run, tmp: Path, plan) -> dict:
    """The lm_sharded phase in a world of one (NCCL on the card); writes what
    the ranks compare with under ``tmp`` (the unsharded step's loss and
    parameters, the depth-cut zamba2's requests)."""
    import torch

    from repro_torch.distributed import sharding as S
    from repro_torch.models import init_params

    dev = plan.device
    tokens = plan.batch * plan.seq
    m0, ref, secs = train_reference(plan, args.seed, tmp)
    out = {"train": {"plain": {"loss": float(m0["loss"]), "s": secs,
                               "tokens_per_s": tokens / secs, "peak_gb": peak_gb(dev)}}}
    with world_of_one(dev) as mesh:  # (1, 1) ("data", "model")
        for layout in ("tp_sp", "fsdp"):
            reset_peak(dev)
            (state, m, _, coll), _, _ = run(
                "lm_sharded_train", lambda: shard_train_step(plan, args.seed, mesh, layout,
                                                             count=True))
            errs = param_errors(state, ref)
            del state
            # the same step again, the counter off: its time
            _, _, secs, _ = shard_train_step(plan, args.seed, mesh, layout)
            loss_err = abs(float(m["loss"]) - float(m0["loss"]))
            if loss_err > SHARD_LOSS_RTOL * abs(float(m0["loss"])) or not params_ok(errs):
                raise AssertionError(f"lm_sharded {layout}: loss {float(m['loss'])} vs "
                                     f"{float(m0['loss'])}, parameters {errs}")
            out["train"][layout] = {
                "loss": float(m["loss"]), "loss_err": loss_err, **errs,
                "s": secs, "tokens_per_s": tokens / secs, "peak_gb": peak_gb(dev),
                "collectives": coll}
        del ref
        # zamba2-7b whole, served unsharded and then under rules
        zcfg, traffic = plan.serve_cfg, plan.traffic
        prompts = serve_prompts(zcfg, traffic, args.seed)
        model = build_lm(zcfg, args.seed) if on_card(dev) else init_params(zcfg, args.seed,
                                                                            device=dev)
        (eng0, plain_done), _, plain_launches = run(
            "lm_sharded_plain", lambda: run_engine(model, traffic, prompts, "kernel"))
        S.distribute_params(model, mesh, S.param_specs(model, mesh))
        rules = S.make_rules(mesh)
        reset_peak(dev)
        (eng, done), wall, launches = run(
            "lm_sharded", lambda: sharded_engine(model, zcfg, traffic, prompts, dev, rules))
        streams = compare_streams(done, plain_done, LM_ATOL)
        if streams["tokens_equal"] != streams["tokens"]:
            raise AssertionError(f"lm_sharded: tokens under rules differ: {streams}")
        for k in LM_KERNELS:
            if launches[k] != plain_launches[k]:
                raise AssertionError(f"lm_sharded: {k} launched {launches[k]} times under "
                                     f"rules, {plain_launches[k]} without")
        w = eng.wave_stats
        out["serve"] = {"wall_s": wall, "tokens_per_s": sum(x["new_tokens"] for x in w) / wall,
                        "prefill_s": [x["prefill_s"] for x in w],
                        "decode_s_per_step": [x["decode_s"] / max(x["decode_steps"], 1)
                                              for x in w],
                        "plain_prefill_s": [x["prefill_s"] for x in eng0.wave_stats],
                        "plain_decode_s_per_step": [x["decode_s"] / max(x["decode_steps"], 1)
                                                    for x in eng0.wave_stats],
                        "streams": streams, "peak_gb": peak_gb(dev),
                        "launches": {k: launches[k] for k in LM_KERNELS}}
        out["launches"] = launches
    del model
    reset_peak(dev)
    cut_reference(plan, args.seed, tmp)
    return out


def train_reference(plan, seed: int, tmp: Path):
    """The unsharded train step the ranks compare with: ``(metrics, its
    parameters and first moments after it, seconds)``, all of them written
    under ``tmp``."""
    import torch

    shard_train_step(plan, seed)  # warm-up: cuBLAS, the allocator
    reset_peak(plan.device)
    plain, m0, secs, _ = shard_train_step(plan, seed)
    ref = {"params": {n: p.detach().cpu() for n, p in plain.model.named_parameters()},
           "m": {n: t.cpu() for n, t in plain.opt.m.items()}}
    (tmp / "train_ref.json").write_text(json.dumps(
        {"loss": float(m0["loss"]), "grad_norm": float(m0["grad_norm"])}))
    torch.save(ref, tmp / "train_ref.pt")
    return m0, ref, secs


def cut_reference(plan, seed: int, tmp: Path) -> None:
    """The ranks' zamba2 depth cut served unsharded: the requests they must
    give, written under ``tmp``."""
    from repro_torch.models import init_params

    cut = init_params(plan.cut_cfg, seed, device=plan.device)
    _, done = run_engine(cut, plan.traffic, serve_prompts(plan.cut_cfg, plan.traffic, seed),
                         "kernel")
    (tmp / "zamba_ref.json").write_text(json.dumps(requests_json(done)))


# the collectives DTensor issues, probed in this order in one launch: a crash
# ends the launch, so the one known to crash ranks on CUDA tensors goes last
GLOO_PROBES = ("reduce_scatter_tensor", "all_to_all_single", "all_gather_into_tensor")


def gloo_probe(name: str, world: int, rank: int, dev) -> str:
    """Whether gloo carries collective ``name`` (one DTensor issues) on
    ``dev``'s tensors: ``"ok"``, or what went wrong, the result checked.  A
    crash of the process is caught by the parent (:func:`gloo_limits`)."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    group = dist.group.WORLD
    x = torch.full((world, 3), float(rank), device=dev)
    ranks = torch.arange(world, dtype=torch.float32, device=dev)
    cases = {
        "all_gather_into_tensor": (
            lambda: funcol.all_gather_tensor(x, 0, group),
            lambda y: torch.equal(y, ranks.repeat_interleave(world * 3).reshape(-1, 3))),
        "reduce_scatter_tensor": (
            lambda: funcol.reduce_scatter_tensor(x, "sum", 0, group),
            lambda y: torch.equal(y, torch.full((1, 3), float(ranks.sum()), device=dev))),
        "all_to_all_single": (
            lambda: funcol.all_to_all_single(x, None, None, group),
            lambda y: torch.equal(y[:, 0], ranks)),
    }
    call, check = cases[name]
    try:
        y = call()
        y = y.wait() if hasattr(y, "wait") else y
        sync(dev)
        return "ok" if y.device == x.device and check(y) else f"wrong result {y.tolist()}"
    except Exception as e:  # the gloo limit is the finding: recorded, not hidden
        return f"{type(e).__name__}: {str(e)[:200]}"


def lm_rank_main(args) -> int:
    """One rank of lm_sharded_ranks: a gloo probe (``--probe``), or
    mamba2-130m's sharded train steps and the depth-cut zamba2 served under
    rules; prints ``RANK {json}``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.distributed import sharding as S
    from repro_torch.kernels import _lib
    from repro_torch.models import init_params

    faulthandler.enable()  # a crash prints its stack into the rank's log
    plan = shard_plan(args.device, args.small)
    dev = plan.device
    if on_card(dev):  # gloo: every rank on card 0; nccl: a card a rank
        torch.cuda.set_device(args.rank % torch.cuda.device_count()
                              if args.backend == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = plan.device = f"cuda:{torch.cuda.current_device()}"
    dist.init_process_group(args.backend, init_method=args.init, world_size=args.world,
                            rank=args.rank,
                            timeout=datetime.timedelta(seconds=SHARD_RANK_TIMEOUT_S))
    tmp = Path(args.io)
    try:
        if args.probe:  # one line a collective, flushed before the next may crash
            for name in GLOO_PROBES:
                print("PROBE " + json.dumps({name: gloo_probe(name, args.world, args.rank, dev)}),
                      flush=True)
            print("RANK " + json.dumps({"rank": args.rank}), flush=True)
            dist.barrier()
            return 0
        ref = json.loads((tmp / "train_ref.json").read_text())
        ref_params = torch.load(tmp / "train_ref.pt")
        kind = torch.device(dev).type
        meshes = {"tp_sp": DeviceMesh(kind, torch.arange(args.world).reshape(2, -1),
                                      mesh_dim_names=("data", "model")),
                  "fsdp": DeviceMesh(kind, torch.arange(args.world), mesh_dim_names=("data",))}
        res = {"rank": args.rank, "train": {}}
        for layout, mesh in meshes.items():
            reset_peak(dev)
            state, m, _, coll = shard_train_step(plan, args.seed, mesh, layout, count=True)
            errs = param_errors(state, ref_params)
            del state
            _, _, secs, _ = shard_train_step(plan, args.seed, mesh, layout)  # its time
            res["train"][layout] = {
                "loss": float(m["loss"]), "loss_ref": ref["loss"],
                "grad_norm": float(m["grad_norm"]), "grad_norm_ref": ref["grad_norm"],
                **errs, "s": secs,
                "tokens_per_s": plan.batch * plan.seq / secs, "peak_gb": peak_gb(dev),
                "collectives": coll}
        del ref_params
        model = init_params(plan.cut_cfg, args.seed, device=dev)
        mesh = meshes["tp_sp"]
        S.distribute_params(model, mesh, S.param_specs(model, mesh))
        prompts = serve_prompts(plan.cut_cfg, plan.traffic, args.seed)
        _lib.reset_launches()
        t0 = time.perf_counter()
        eng, done = sharded_engine(model, plan.cut_cfg, plan.traffic, prompts, dev,
                                   S.make_rules(mesh))
        sync(dev)
        res["serve"] = {"wall_s": time.perf_counter() - t0, "waves": eng.wave_stats,
                        "launches": {k: _lib.LAUNCHES[k] for k in LM_KERNELS},
                        "requests": requests_json(done)}
        print("RANK " + json.dumps(res), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def launch_lm_ranks(args, plan, tmp: Path, tag: str, extra=(), timeout=SHARD_RANK_TIMEOUT_S
                    ) -> list[tuple[int, str, dict | None]]:
    """Start the lm_sharded_ranks ranks (``extra`` arguments, a rendezvous
    and logs named by ``tag``); each one's ``(exit code, log, result)``.
    Every rank is killed when the launch ends or outlives ``timeout``."""
    logs = [open(tmp / f"lm_{tag}_rank{r}.log", "w+") for r in range(SHARD_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--world",
         str(SHARD_RANKS), "--init", f"file://{tmp}/lm_{tag}_rendezvous", "--seed",
         str(args.seed), "--rank-phase", "lm", "--io", str(tmp), "--device", plan.device,
         *(["--small"] if plan.small else []), *extra],
        stdout=logs[r], stderr=subprocess.STDOUT, text=True) for r in range(SHARD_RANKS)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            p.kill()
            p.wait()
    out = []
    for p, f in zip(procs, logs):
        f.seek(0)
        text = f.read()
        f.close()
        lines = [ln[5:] for ln in text.splitlines() if ln.startswith("RANK ")]
        out.append((p.returncode, text, json.loads(lines[-1]) if lines else None))
    return out


def gloo_limits(args, plan, tmp: Path) -> dict:
    """``GLOO_PROBES`` in one launch of the ranks: ``{name: "ok" | what
    happened}``.  A collective gloo cannot carry may crash its ranks; the
    ones after it are then not probed."""
    got = launch_lm_ranks(args, plan, tmp, "probe", ["--probe"], timeout=120)
    out = {}
    for name in GLOO_PROBES:
        why = []
        for r, (rc, text, _) in enumerate(got):
            seen = [json.loads(ln[6:]) for ln in text.splitlines() if ln.startswith("PROBE ")]
            res = next((p[name] for p in seen if name in p), None)
            if res is None and len(seen) == GLOO_PROBES.index(name) and rc != 0:
                tail = " | ".join(text.strip().splitlines()[-2:])
                why.append(f"rank {r} exited {rc}{' (SIGSEGV)' if rc == -11 else ''}: {tail}")
            elif res is None:
                why.append(f"rank {r}: not probed (exit {rc})")
            elif res != "ok":
                why.append(f"rank {r}: {res}")
        out[name] = "; ".join(why)[:400] if why else "ok"
    return out


def lm_sharded_ranks_check(args, tmp: Path, plan) -> dict:
    """The ranks against the world of one: loss, grad norm and parameters of
    both layouts, the depth-cut zamba2's tokens, #8 and #9 on every rank."""
    t0 = time.perf_counter()
    probe = gloo_limits(args, plan, tmp)
    if any(v != "ok" for v in probe.values()):
        log(f"lm_sharded_ranks: GLOO LIMIT on {plan.device} tensors: {probe}; the ranks stop "
            "after the probe, the multi-rank proof stays with the CPU tests "
            "(tests/test_torch_distributed.py)")
        return {"gloo_limit": probe, "wall_s": time.perf_counter() - t0}
    out = check_lm_ranks(launch_lm_ranks(args, plan, tmp, "main"), tmp, plan)
    return {"wall_s": time.perf_counter() - t0, "probe": probe, **out}


def check_lm_ranks(got, tmp: Path, plan) -> dict:
    """Each launched rank's results against the world of one's (under
    ``tmp``): loss, grad norm and parameters of both layouts, the depth-cut
    zamba2's tokens, #8 and #9 on every rank."""
    for r, (rc, text, res) in enumerate(got):
        if rc != 0 or res is None:
            raise AssertionError(f"lm rank {r} exited {rc}:\n{text[-3000:]}")
    ranks = [res for _, _, res in got]
    ref = [SimpleNamespace(**r) for r in json.loads((tmp / "zamba_ref.json").read_text())]
    for r in ranks:
        for layout, t in r["train"].items():
            if abs(t["loss"] - t["loss_ref"]) > SHARD_LOSS_RTOL * abs(t["loss_ref"]) or \
                    not params_ok(t):
                raise AssertionError(f"rank {r['rank']} {layout}: {t}")
        streams = compare_streams([SimpleNamespace(**q) for q in r["serve"]["requests"]], ref,
                                  LM_ATOL)
        if streams["tokens_equal"] != streams["tokens"]:
            raise AssertionError(f"rank {r['rank']}: tokens differ from the world of one's "
                                 f"{streams}")
        # #8 and #9 once a layer a prefill, on the rank's half of the heads
        # (the CPU branch of a wrapper launches nothing)
        waves = len(r["serve"]["waves"])
        want = {k: n * waves if on_card(plan.device) else 0
                for k, n in lm_layer_counts(plan.cut_cfg).items()}
        if r["serve"]["launches"] != want:
            raise AssertionError(f"rank {r['rank']}: launches {r['serve']['launches']}, "
                                 f"want {want}")
    return {"ranks": [
        {"rank": r["rank"], "train": r["train"], "serve_s": r["serve"]["wall_s"],
         "prefill_s": [w["prefill_s"] for w in r["serve"]["waves"]],
         "decode_s_per_step": [w["decode_s"] / max(w["decode_steps"], 1)
                               for w in r["serve"]["waves"]],
         "launches": r["serve"]["launches"]} for r in ranks]}


def dryrun_check(tmp: Path, cell: tuple[str, str]) -> dict:
    """The two dry runs as a user runs them, in two subprocesses side by side
    (``cell`` the LM one's arch and shape); their artifacts read back."""
    repo = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(repo / "src")}
    arch, shape = cell
    runs = {"dryrun": (["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                        "--mesh", "single"], f"{arch}__{shape}__single.json"),
            "dryrun_engine": (["-m", "repro_torch.launch.dryrun_engine"],
                              "needletail-engine__anyk__single.json")}
    t0 = time.perf_counter()
    logs = {name: open(tmp / f"{name}.log", "w+") for name in runs}
    procs = {name: subprocess.Popen([sys.executable, *cmd, "--out", str(tmp)], cwd=repo,
                                    env=env, stdout=logs[name], stderr=subprocess.STDOUT)
             for name, (cmd, _) in runs.items()}
    walls, out = {}, {}
    try:
        while len(walls) < len(procs):  # each one's own wall: poll both
            if time.perf_counter() - t0 > DRYRUN_TIMEOUT_S:
                raise AssertionError(f"the dry runs outlived {DRYRUN_TIMEOUT_S} s")
            for name, p in procs.items():
                if name not in walls and p.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            time.sleep(0.1)
        for name, p in procs.items():
            logs[name].seek(0)
            if p.returncode != 0:
                raise AssertionError(f"{name} exited {p.returncode}:\n{logs[name].read()[-3000:]}")
            res = json.loads((tmp / runs[name][1]).read_text())
            if res["status"] != "ok":
                raise AssertionError(f"{name}: {res['status']}")
            out[name] = {"wall_s": walls[name], "memory": res["memory"],
                         "flops_per_device": res["analyzer"]["flops_per_device"],
                         "collective_bytes_per_device":
                             res["analyzer"]["collective_bytes_per_device"],
                         "per_collective": res["analyzer"]["per_collective"],
                         "num_devices": res["num_devices"]}
    finally:
        for name, p in procs.items():
            p.kill()
            p.wait()
            logs[name].close()
    return out


def sharded_lm_phases(args, card: str, phase_launches: dict, plan=None, run=None) -> dict:
    """lm_sharded, lm_sharded_ranks and dryrun, each logged beside the card;
    ``plan`` and ``run`` are the card's unless a rehearsal gives its own.
    Returns the three phases' results."""
    plan = plan or shard_plan()
    run = run or run_phase
    cfg = plan.train_cfg
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        ls = lm_sharded_check(args, run, tmp, plan)
        phase_launches["lm_sharded"] = ls.pop("launches")
        for layout, t in ls["train"].items():
            log(f"lm_sharded train {cfg.name} [{plan.batch}, {plan.seq}] {layout}: {t} ({card})")
        log(f"lm_sharded serve {plan.serve_cfg.name} (rules on (1, 1), launcher traffic): "
            f"{ls['serve']} ({card})")
        log(f"lm_sharded: {time.perf_counter() - t0:.1f} s in all")
        lr = lm_sharded_ranks_check(args, tmp, plan)
        for r in lr.get("ranks", []):
            log(f"lm_sharded_ranks rank {r['rank']}: {r} ({card})")
        log(f"lm_sharded_ranks: {SHARD_RANKS} gloo ranks on one card, probe "
            f"{lr.get('probe', lr.get('gloo_limit'))}, {lr['wall_s']:.1f} s in all")
        dr, wall, _ = run("dryrun", lambda: dryrun_check(tmp, plan.dryrun_cell))
        for name, r in dr.items():
            log(f"{name}: {r}")
        log(f"dryrun: both artifacts written, {wall:.1f} s in all")
    return {"lm_sharded": ls, "lm_sharded_ranks": lr, "dryrun": dr}


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
                         "warm wave, one warm sharded wave, one LM serving wave of each "
                         "traffic and one full-width train step; print device and host "
                         "time by operator, and the kernels "
                         "scaled_dot_product_attention launches in f32")
    # one rank of the sharded_ranks phase (the script starts these itself)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=SHARDS, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    # one rank of the lm_sharded_ranks phase, and its exchange directory
    ap.add_argument("--rank-phase", default="engine", choices=["engine", "lm"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--io", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--small", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    started = time.perf_counter()

    import torch

    if args.rank is not None:
        return lm_rank_main(args) if args.rank_phase == "lm" else rank_main(args)

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
    with world_of_one("cuda") as mesh:
        sh = sharded_check(store, queries, batch, warm, rows, run_phase, profile=args.profile)
        # -- serve_exemplar: the wave's queries as requests through ServeEngine,
        # the mesh variant on this world of one
        t0 = time.perf_counter()
        se = serve_exemplar_check(store, queries, batch, run_phase, mesh=mesh)
        serve_wall = time.perf_counter() - t0
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
    auto_ref = se.pop("ref")
    phase_launches.update(se.pop("launches"))
    for name in ("serve_exemplar", "serve_exemplar_host", "serve_exemplar_drain",
                 "serve_exemplar_mesh"):
        log(f"{name}: {se.pop(name)}")
    log(f"serve_exemplar real clock (SLO {SERVE_REAL_SLO_S} s, one arrival a tick): "
        f"{se.pop('real_clock')}")
    log(f"serve_exemplar: {Q} requests, {SERVE_SLOTS} slots, each loop == the all-auto wave "
        f"(the wave phase's auto queries, 8 solo any_k); {serve_wall:.1f} s in all")

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
    t0 = time.perf_counter()
    sa = serve_aggregate_check(store, cpu_store, queries, run_phase, args.seed)
    phase_launches["serve_aggregate"] = sa.pop("launches")
    plans = sa.pop("plans")
    log(f"serve_aggregate: {sa}; each stream == its solo run on a fresh card engine (==) and "
        f"the CPU copy's (rtol {RTOL}); {time.perf_counter() - t0:.1f} s in all")
    t0 = time.perf_counter()
    ob = obs_check(store, queries, plans, run_phase)
    phase_launches["obs"] = ob.pop("launches")
    for line in ob.pop("report_lines"):
        log(f"  {line}")
    log(f"obs: {ob}; traced == untraced (records, streams, reasons); trace_report rebuilt "
        f"every request; {time.perf_counter() - t0:.1f} s in all")
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
    lm_continuous_phase(model, "serve_lm_continuous", LM_JOIN, args.seed, phase_launches,
                        SERVE_TRAFFIC["launcher"])
    del model
    torch.cuda.empty_cache()

    # -- 19. lm_forward_swa and 20. lm_serve_swa: gemma3-12b at full width
    model = build_lm(scfg, args.seed)
    swa_seq = lm_phases(model, "lm_forward_swa", "lm_serve_swa", args, phase_launches)
    lm_continuous_phase(model, "serve_lm_continuous_swa", SWA_JOIN, args.seed, phase_launches)
    del model
    torch.cuda.empty_cache()

    # -- lm_moe, lm_encdec and lm_vlm: the remaining families, one at a time
    families = family_phases(args, phase_launches)

    # -- train_stream, train, train_learns, train_archs: training on the card
    train_phases(args, card, phase_launches)

    # -- lm_sharded, lm_sharded_ranks, dryrun: the multi-GPU LM and the dry run
    sharded_lm_phases(args, card, phase_launches)

    entries = kernel_phase(store, queries, batch, phase_launches, rows)
    for e in entries:
        if e["name"] in redesigned:
            e["ptxas"] = redesigned[e["name"]]
    entries += lm_kernel_rows(cfg, phase_launches, long_seq, args.seed, torch.device("cuda"),
                              swa=(scfg, swa_seq), profile=args.profile,
                              encdec=(get_config(ENCDEC_ARCH), families["lm_encdec"]))

    # -- 25-28. tiered storage on the same table, the LMs freed
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
    del tier_engine, tier_stack
    t0 = time.perf_counter()
    pf = prefetch_check(store, queries, run_phase)
    phase_launches["prefetch"] = pf.pop("launches")
    log(f"prefetch: {pf}; round 0 read 0 store blocks in both modes, async admissions == "
        f"sync; {time.perf_counter() - t0:.1f} s in all")
    # -- 29. peer: the cooperative peer-memory tier over four in-process shards
    t0 = time.perf_counter()
    pe = peer_check(table, store, cpu_store, queries, batch,
                    {"cold": ti["walls"]["tiered_cold"], "warm": ti["walls"]["tiered_warm"]},
                    run_phase, args.seed)
    phase_launches["peer"] = pe.pop("launches")
    log(f"peer ici fit: {pe.pop('ici')}")
    log(f"peer: {pe}; every wave == the flat wave, the peer-served one read 0 store blocks "
        f"and its counters == the CPU run's; a raising and a missing shard fell through to "
        f"the store; rebalance moved the union to shard 0; the mesh routed through "
        f"fetch_remote; the raced append aborted the read; {time.perf_counter() - t0:.1f} s "
        "in all")
    del cpu_store
    t0 = time.perf_counter()
    st = serve_tiered_check(store, queries, auto_ref, run_phase)
    phase_launches["serve_tiered"] = st.pop("launches")
    log(f"serve_tiered: {st}; == the all-auto wave; {time.perf_counter() - t0:.1f} s in all")
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
