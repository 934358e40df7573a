"""The paper's §7.1 synthetic table (Anh–Moffat clustered bit vectors), generated
on the device from the seed.

Each binary dimension gets runs of 1s, of geometric length with mean
``mean_run`` rows, at uniform offsets, until ``density`` of the rows are set;
the last run is cut to the rows still missing, as
``make_clustered_table`` cuts it.  Runs are painted in bulk (a difference
array and a prefix sum) and the number of runs is found by bisection, so the
table is built in a few dozen device passes.  Measures are Normal(100, 20).
"""
from __future__ import annotations

import torch


def _paint(n: int, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """``[n]`` bool: the union of the half-open runs ``[starts, ends)``."""
    diff = torch.zeros(n + 1, dtype=torch.int32, device=starts.device)
    one = torch.ones_like(starts, dtype=torch.int32)
    diff.index_add_(0, starts, one)
    diff.index_add_(0, ends, -one)
    return torch.cumsum(diff[:n], dim=0, dtype=torch.int32) > 0


def clustered_bits(n: int, density: float, mean_run: int, gen: torch.Generator,
                   device) -> torch.Tensor:
    target = int(density * n)
    runs = int(2 * target / mean_run) + 64
    while True:
        length = torch.empty(runs, device=device, dtype=torch.float64).geometric_(
            1.0 / mean_run, generator=gen).long() + 1
        length = length.clamp(max=max(target, 1))
        u = torch.rand(runs, generator=gen, device=device, dtype=torch.float64)
        starts = torch.floor(u * (n - length).clamp(min=1)).long()
        ends = torch.minimum(starts + length, torch.tensor(n, device=device))
        if int(_paint(n, starts, ends).sum()) >= target:
            break
        runs *= 2  # too few runs drawn for the density: draw a larger set
    lo, hi = 0, runs  # smallest prefix of runs that reaches the target
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if int(_paint(n, starts[:mid], ends[:mid]).sum()) >= target:
            hi = mid
        else:
            lo = mid
    short = target - int(_paint(n, starts[:hi - 1], ends[:hi - 1]).sum())
    ends[hi - 1] = torch.minimum(ends[hi - 1], starts[hi - 1] + max(short, 0))
    return _paint(n, starts[:hi], ends[:hi])


def generate(n: int, gen: torch.Generator, device, num_dims: int, num_measures: int,
             density: float, mean_run: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dims [n, num_dims] int32 in {0, 1}, measures [n, num_measures] f32)``."""
    dims = torch.stack([clustered_bits(n, density, mean_run, gen, device).to(torch.int32)
                        for _ in range(num_dims)], dim=1)
    meas = torch.randn((n, num_measures), generator=gen, device=device, dtype=torch.float32)
    return dims, meas * 20.0 + 100.0
