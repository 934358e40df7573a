"""Work counts of the port's plan and gather kernels, from each launch's shapes.

Each input is counted as read once and each output as written once, whatever
the kernel reads again, so a later rewrite of a kernel leaves these counts
alone.  The least time of a launch is the larger of its bytes over the card's
memory rate and its operations over its f32 rate; a kernel's roofline share
is the least time of its launches over their profiled device time.  Peaks:
one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet), as
``chip_smoke.py`` takes them.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

F32 = 4
I32 = 4


def least_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def density_combine_wave(gammas: list[int], lam: int) -> tuple[float, float]:
    """#2, one launch over the joiners of a round: each query reads its own
    γ rows of the ``[rows, λ]`` index and writes its ``[λ]`` row (joiners
    bring no exclusions); γ − 1 products or sums an element."""
    reads = sum(gammas) * lam * F32 + sum(gammas) * I32
    writes = len(gammas) * lam * F32
    return reads + writes, sum(max(g - 1, 0) for g in gammas) * lam


def prefix_sum(rows: int, lam: int) -> tuple[float, float]:
    """#6 over a ``[rows, λ]`` f32 matrix: read it, write its scan; one add
    an element."""
    return 2 * rows * lam * F32, rows * lam


def theta_wave(rows: int, lam: int) -> tuple[float, float]:
    """#5's wave round: read each ``[λ]`` masked row, the last element of its
    sorted prefix and its cut, write θ, the count and the mass; one compare
    and one add an element."""
    return rows * lam * F32 + rows * (F32 + I32) + 3 * rows * F32, 2 * rows * lam


def plan_round(rows: int, lam: int, joiner_gammas: list[int]) -> float:
    """Least seconds of one device plan round's hand-written launches: #2
    for the joiners (when there are any), two #6 scans (THRESHOLD's sorted
    prefix and TWO-PRONG's masses) and one #5 θ-round."""
    t = 2 * least_s(*prefix_sum(rows, lam)) + least_s(*theta_wave(rows, lam))
    if joiner_gammas:
        t += least_s(*density_combine_wave(joiner_gammas, lam))
    return t


def block_gather(blocks: int, block_bytes: int) -> float:
    """#7: least seconds to read ``blocks`` slabs of ``block_bytes`` and
    write them out."""
    return least_s(2.0 * blocks * block_bytes, 0.0)
