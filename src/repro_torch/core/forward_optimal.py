"""FORWARD-OPTIMAL — globally I/O-optimal any-k selection (paper §4.3, Algorithm 3).

Counterpart of ``repro/core/forward_optimal.py``.  DP over (s = records
collected, i = last block fetched):

  C(s,i)   = min cost to hold s estimated valid records with block i fetched last,
  Opt(s,i) = min cost over the first i blocks,

  C(s,i)   = min( min_{j in [i-t, i-1]} C(s - s_i, j) + RandIO(j, i),
                  Opt(s - s_i, i - t - 1) + far_cost )
  Opt(s,i) = min( C(s,i), Opt(s, i-1) )

Complexity O(λ·k·t): the DP's CPU cost outweighs its I/O savings on large λ;
it is the optimality yardstick, not the production path.

:func:`forward_optimal_faithful` is the reference's host DP with parent
pointers, its loop order and its strict ``<`` ties, in numpy: the engine
plans ``algo="forward_optimal"`` with it, and its input row crosses to the
host once.  :func:`forward_optimal_scan` is the reference's ``lax.scan``
form on the card: a loop over the λ blocks with the s axis vectorised and
the same carry (the last t columns of C and the Opt columns up to t + 1
back, here as ring buffers).  Every value is a min or one f32 add, so its
``opt_table`` equals the reference's bit for bit.  Each keeps its own
``s_i``: the faithful DP rounds ``combined·rpb`` in f64, the scan in f32
(``torch.round`` rounds half to even, as ``jnp.rint``), and the two may
differ at a half, in the reference too.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel

_INF = np.float64(1e18)


def _block_records(combined: np.ndarray, records_per_block: int, k: int) -> np.ndarray:
    """s_i = estimated valid records per block, clipped to [0, k] ints."""
    s = np.rint(np.asarray(combined, dtype=np.float64) * records_per_block)
    return np.clip(s, 0, k).astype(np.int64)


def forward_optimal_faithful(
    combined, k: int, records_per_block: int, cost: CostModel
) -> tuple[list[int], float]:
    """Algorithm 3 with parent pointers, on the host.  ``combined`` is a
    ``[λ]`` row (numpy, or a tensor on any device, copied to the host once).
    Returns (selected block ids, optimal cost)."""
    if isinstance(combined, torch.Tensor):
        combined = combined.cpu().numpy()
    s_blk = _block_records(combined, records_per_block, k)
    lam = s_blk.shape[0]
    t = cost.max_dist
    rio = cost.rand_io_table()  # rio[d], d=0..t
    kappa = cost.first_block_cost

    # C[s, i], Opt[s, i]; parent[s, i] = previous block id (or -1 if i is first)
    C = np.full((k + 1, lam), _INF)
    Opt = np.full((k + 1, lam), _INF)
    parent = np.full((k + 1, lam), -2, dtype=np.int64)
    # Opt_arg[s, i] = block achieving Opt(s, i)
    opt_arg = np.full((k + 1, lam), -2, dtype=np.int64)

    for i in range(lam):
        si = int(s_blk[i])
        for s in range(0, k + 1):
            rem = max(s - si, 0)
            best, par = _INF, -2
            if rem == 0:
                best, par = kappa, -1  # i can be the first block fetched
            lo = max(i - t, 0)
            for j in range(lo, i):
                if C[rem, j] + rio[i - j] < best:
                    best, par = C[rem, j] + rio[i - j], j
            if i - t - 1 >= 0 and Opt[rem, i - t - 1] + cost.far_cost < best:
                best, par = Opt[rem, i - t - 1] + cost.far_cost, opt_arg[rem, i - t - 1]
            C[s, i] = best
            parent[s, i] = par
            if i > 0 and Opt[s, i - 1] <= best:
                Opt[s, i] = Opt[s, i - 1]
                opt_arg[s, i] = opt_arg[s, i - 1]
            else:
                Opt[s, i] = best
                opt_arg[s, i] = i

    total = float(Opt[k, lam - 1])
    if total >= _INF:  # fewer than k records exist in the whole table
        return [int(b) for b in np.nonzero(s_blk > 0)[0]], float("inf")
    # reconstruct: follow parent pointers from Opt(k, λ-1)
    sel: list[int] = []
    s, i = k, int(opt_arg[k, lam - 1])
    while i >= 0:
        sel.append(i)
        j = int(parent[s, i])
        s = max(s - int(s_blk[i]), 0)
        i = j
    sel.reverse()
    return sel, total


class ForwardOptimalResult(NamedTuple):
    opt_cost: torch.Tensor  # [] f32 — Opt(k, λ)
    opt_table: torch.Tensor  # [k+1] f32 — Opt(·, λ) (cost frontier)


def forward_optimal_scan(
    combined: torch.Tensor, k: int, records_per_block: int, cost: CostModel
) -> ForwardOptimalResult:
    """Opt(k, λ) by a loop over the blocks on ``combined``'s device, the s
    axis vectorised.  The carry is the reference's: the last t columns of C
    (a ring, slot ``j % t`` holding C(:, j)) and the Opt columns i-1-t..i-1
    (a ring, slot ``j % (t+1)`` holding Opt(:, j)); no step reads back to
    the host."""
    dev = combined.device
    lam = combined.shape[0]
    t = cost.max_dist
    s_blk = torch.clamp(torch.round(combined * records_per_block), 0, k).to(torch.int32)
    rio = torch.as_tensor(cost.rand_io_table(), dtype=torch.float32)  # [t+1]
    # ring_rio[i % t, m]: RandIO distance of the column in C-slot m from block i
    m = np.arange(t)
    ring_rio = torch.stack([rio[((r - 1 - m) % t) + 1] for r in range(t)]).to(dev)
    far = torch.tensor(cost.far_cost, dtype=torch.float32, device=dev)
    kappa = torch.tensor(cost.first_block_cost, dtype=torch.float32, device=dev)
    inf = torch.tensor(1e18, dtype=torch.float32, device=dev)
    s_ax = torch.arange(k + 1, dtype=torch.int32, device=dev)

    cwin = torch.full((t, k + 1), 1e18, dtype=torch.float32, device=dev)
    opt = torch.full((k + 1,), 1e18, dtype=torch.float32, device=dev)
    opt[0] = 0.0
    opt_lag = torch.full((t + 1, k + 1), 1e18, dtype=torch.float32, device=dev)
    opt_lag[:, 0] = 0.0
    for i in range(lam):
        short = s_ax - s_blk[i]
        rem_idx = short.clamp(0, k).long()
        base = torch.where(short <= 0, kappa, inf)  # i as the first fetched block
        # near candidates: C(rem, j) + rio(i-j), j = i-t .. i-1
        near_best = (cwin[:, rem_idx] + ring_rio[i % t][:, None]).amin(dim=0)
        # far candidate: Opt(rem, i-t-1) + far (the ring slot about to be overwritten)
        lag = i % (t + 1)
        far_best = opt_lag[lag][rem_idx] + far
        c_col = torch.minimum(torch.minimum(near_best, far_best), base)
        opt = torch.minimum(opt, c_col)
        cwin[i % t] = c_col
        opt_lag[lag] = opt
    return ForwardOptimalResult(opt_cost=opt[k], opt_table=opt)
