#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of NeedleTail on one NVIDIA card, end to end.

    python3 chip_smoke.py [--records N] [--seed S]

Phases, each of which fails the run (non-zero exit) on any fault:

1. card   — print the card's name and power limit (``nvidia-smi``).
2. build  — compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   ``sm_90a``) and print the build time and ptxas report.
3. path   — build an airline-like table (``make_real_like_table("airline")``,
   10⁸ records by default, the size of the public on-time dataset it
   imitates) in blocks of 8192 records (the paper's 256 KB block at 32-byte
   records), move it to the card and run a wave of 64 any-k queries through
   ``NeedleTailEngine(store, device="cuda").any_k_batch(..., device=True)``.
   The kernels' launch counters are zeroed just before and read just after:
   each kernel must have run.  Every returned record is re-checked against
   the host table, ``num_records >= k`` unless a full scan counts fewer
   matches or ``max_refills`` ran out, ``device_transfers <= rounds + 1``,
   and the same wave run by the port on the CPU (plain versions) must give
   identical per-query results.  Round-0 TWO-PRONG windows are held against
   the float64 ``two_prong_faithful`` under the planner contract.
4. kernels — each kernel at the path's shapes against its plain PyTorch
   version on the card (exact for the combine, the gather and the θ-counts,
   ``rtol=1e-5`` for the θ-sums), timed with CUDA events (median of 25)
   beside the plain version, a library call where one computes the same
   function, and the least time the card could take (``bound_ms``).

The last lines are the ``{"kernels": [...]}`` JSON, the ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RPB = 8192
Q = 64
TIMING_RUNS = 25

KERNELS = {
    "density_combine_batch": ("csrc/density_combine.cu", "src/repro/kernels/density_combine.py:142"),
    "theta_stats_batch": ("csrc/theta_stats.cu", "src/repro/kernels/theta_stats.py:132"),
    "block_gather": ("csrc/block_gather.cu", "src/repro/kernels/plan_wave.py:325"),
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


def assert_same(a, b, what: str) -> None:
    if not np.array_equal(a, b):
        raise AssertionError(f"{what} differ")


def check_records(table, store, queries, batch, max_refills: int) -> dict:
    """Every returned record satisfies its predicates on the host table and
    carries its measures; ``num_records >= k`` unless the data or the refill
    budget runs out.  Returns the shortfall reasons by count."""
    reasons = {"full_scan_short": 0, "max_refills": 0}
    for q, r in zip(queries, batch.results):
        idx = r.record_block * store.records_per_block + r.record_row
        if idx.size and idx.max() >= table.num_records:
            raise AssertionError("a returned record lies in block padding")
        sub = table.dims[idx]
        hits = [sub[:, a] == v for a, v in q.predicates]
        ok = np.logical_and.reduce(hits) if q.op == "and" else np.logical_or.reduce(hits)
        if not ok.all():
            raise AssertionError(f"{(~ok).sum()} returned records fail {q.predicates} {q.op}")
        if idx.size:
            assert_same(r.measures, table.measures[idx], "returned measures")
        if r.num_records < q.k:
            if int(table.valid_mask(q.predicates, q.op).sum()) < q.k:
                reasons["full_scan_short"] += 1
            elif r.plan_rounds >= max_refills:
                reasons["max_refills"] += 1
            else:
                raise AssertionError(f"query {q} returned {r.num_records} < k records")
    return reasons


def compare_waves(a, b) -> None:
    for i, (x, y) in enumerate(zip(a.results, b.results)):
        assert_same(x.record_block, y.record_block, f"query {i} record_block")
        assert_same(x.record_row, y.record_row, f"query {i} record_row")
        assert_same(x.measures, y.measures, f"query {i} measures")
        assert_same(np.sort(x.blocks_fetched), np.sort(y.blocks_fetched), f"query {i} blocks")
        if (x.plan_rounds, x.algo) != (y.plan_rounds, y.algo):
            raise AssertionError(f"query {i}: rounds/algo differ")


def window_contract(store, queries) -> dict:
    """Round-0 TWO-PRONG windows of the card against float64 Algorithm 2.
    A window may differ only where the f64 record mass of the card's window
    or of the faithful one lies within ε = λ·2⁻²⁴·(total mass) of the need
    (the f32 prefix-sum error bound); such boundary cases are counted."""
    import torch

    from repro_torch.core.density_map import pack_row_matrix
    from repro_torch.core.two_prong import two_prong_faithful, two_prong_select_batch
    from repro_torch.kernels.plan_wave import combine_wave

    lam, rpb = store.num_blocks, store.records_per_block
    rows = torch.empty((len(queries), lam), dtype=torch.float32, device=store.device)
    for op in ("and", "or"):
        idx = [i for i, q in enumerate(queries) if q.op == op]
        if idx:
            rm = pack_row_matrix(store.index.vocab, [queries[i].predicates for i in idx])
            rows[idx] = combine_wave(store.index.densities, rm, op)
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


def profile_wave(engine, queries) -> None:
    """Trace one warm wave: device busy time by operator and the share of
    the wave's wall time the device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.any_k_batch(queries, device=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side entries only (kernels, copies): the host ops that launched
    # them report the same device time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"profile: wall {wall * 1e3:.3f} ms under the profiler, device busy "
        f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%), {sum(r[2] for r in rows)} device ops")
    for key, ms, n in rows[:12]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")


def kernel_phase(store, queries, batch, launches: dict) -> list[dict]:
    import torch

    from repro_torch.core.density_map import pack_row_matrix
    from repro_torch.kernels.density_combine import (
        density_combine_batch, density_combine_batch_plain,
    )
    from repro_torch.kernels.plan_wave import (
        THETA_FANOUT, block_gather, block_gather_plain, plan_wave_from_combined,
    )
    from repro_torch.kernels.theta_stats import theta_stats_batch, theta_stats_batch_plain

    dev = store.device
    lam, rpb = store.num_blocks, store.records_per_block
    dens = store.index.densities
    entries = []

    def entry(name, err, ms, plain, lib, nbytes, ops):
        b, by = bound_ms(nbytes, ops)
        src, rep = KERNELS[name]
        row = {"name": name, "route": "cuda", "source": f"src/repro_torch/{src}",
               "replaces": rep, "launches": launches[name], "max_abs_err": err,
               "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": b,
               "bound_by": by, "library_ms": lib}
        log(f"kernel {name}: {ms:.4f} ms (plain {plain:.4f}, library "
            f"{'n/a' if lib is None else f'{lib:.4f}'}, bound {b:.4f} by {by}), "
            f"max_abs_err {err}")
        entries.append(row)

    # ⊕-combine: the wave's [64, γ<=3] row matrix, both ops checked, AND timed
    rm_np = pack_row_matrix(store.index.vocab, [q.predicates for q in queries])
    rm = torch.from_numpy(rm_np).to(dev)
    for op in ("and", "or"):
        k_out = density_combine_batch(dens, rm, op)
        p_out = density_combine_batch_plain(dens, rm, op)
        if not torch.equal(k_out, p_out):
            raise AssertionError(f"density_combine_batch ({op}) differs from its plain version")
    rmc, valid = rm.long().clamp(min=0), (rm >= 0)[..., None]
    n_rows = int(np.unique(rm_np[rm_np >= 0]).size)
    entry(
        "density_combine_batch", 0.0,
        time_ms(lambda: density_combine_batch(dens, rm, "and")),
        time_ms(lambda: density_combine_batch_plain(dens, rm, "and")),
        time_ms(lambda: torch.prod(torch.where(valid, dens[rmc], 1.0), dim=1)),
        (n_rows * lam + Q * lam) * 4 + rm.numel() * 4,
        float(int((rm_np >= 0).sum()) * lam),
    )

    # θ-stats: round 0's masked rows and thresholds θ, 2θ, ..., 8θ
    combined = density_combine_batch(dens, rm, "and")
    needs = torch.tensor([float(q.k) for q in queries], device=dev)
    excl = torch.zeros_like(combined, dtype=torch.bool)
    plan = plan_wave_from_combined(combined, excl, needs, rpb)
    if not bool((plan.theta_count >= plan.n_sel.float()).all()):
        raise AssertionError("θ invariant broken: fewer blocks clear θ than the prefix holds")
    steps = 1.0 + torch.arange(THETA_FANOUT, dtype=torch.float32, device=dev)
    thetas = (plan.theta[:, None] * steps[None, :]).contiguous()
    kc, ks = theta_stats_batch(combined, thetas)
    pc, ps = theta_stats_batch_plain(combined, thetas)
    if not torch.equal(kc, pc):
        raise AssertionError("theta_stats_batch counts differ from the plain version")
    if not torch.allclose(ks, ps, rtol=1e-5, atol=0.0):
        raise AssertionError("theta_stats_batch sums differ beyond rtol=1e-5")
    entry(
        "theta_stats_batch", float((ks - ps).abs().max()),
        time_ms(lambda: theta_stats_batch(combined, thetas)),
        time_ms(lambda: theta_stats_batch_plain(combined, thetas)),
        None,
        (Q * lam + 3 * Q * THETA_FANOUT) * 4,
        float(2 * Q * THETA_FANOUT * lam),
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
        f"T={THETA_FANOUT} U={ids.numel()} R={rpb} d={store.dims.shape[2]}")
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm wave with torch.profiler and print "
                         "the device's busy time by operator")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
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
    for line in (_lib.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "==" in line:
            log(f"  {line.strip()}")

    t0 = time.perf_counter()
    table = make_real_like_table("airline", num_records=args.records, seed=args.seed)
    t1 = time.perf_counter()
    store = build_block_store(table, RPB, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"data: {args.records} records in {t1 - t0:.1f} s; store λ={store.num_blocks} "
        f"({store.data_nbytes() / 1e9:.2f} GB of slabs) on the card in {t2 - t1:.1f} s")

    queries = make_wave(table.cards, Q, args.seed)
    engine = NeedleTailEngine(store, device="cuda")
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = engine.any_k_batch(queries, device=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    log(f"path launches: {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the wave launched no {missing}")
    t0 = time.perf_counter()
    warm = engine.any_k_batch(queries, device=True)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    compare_waves(batch, warm)
    if args.profile:
        profile_wave(engine, queries)
    log(f"wave: Q={Q} wall {wall:.4f} s (second run {warm_wall:.4f} s), rounds "
        f"{batch.rounds}, transfers {batch.device_transfers}, unique blocks "
        f"{batch.unique_blocks_fetched.size}, blocks gathered {batch.store_blocks_fetched}, "
        f"records {sum(r.num_records for r in batch.results)}")
    log(f"round seconds: {[round(s, 4) for s in batch.round_seconds]}; second run "
        f"{[round(s, 4) for s in warm.round_seconds]}")
    if not batch.device_transfers <= batch.rounds + 1:
        raise AssertionError("more than one plan transfer per round")
    reasons = check_records(table, store, queries, batch, engine.max_refills)
    log(f"records re-checked on the host table; short of k: {reasons}")

    cpu_store = store.to("cpu")
    t0 = time.perf_counter()
    cpu = NeedleTailEngine(cpu_store, device="cpu").any_k_batch(queries, device=True)
    log(f"cpu wave: {time.perf_counter() - t0:.1f} s")
    compare_waves(batch, cpu)
    log("card wave == cpu wave on every query (boundary cases: 0)")
    del cpu_store
    log(f"two-prong contract at round 0: {window_contract(store, queries)}")

    entries = kernel_phase(store, queries, batch, launches)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
