"""Hybrid sampling (paper §5.1).

Counterpart of ``repro/core/hybrid.py``.  Collect (1-α)·k samples from the any-k chosen blocks S_c and α·k from uniformly
random blocks S_r drawn from the remaining valid blocks S_v \\ S_c.  The inclusion
probabilities π_i / π_ij (paper §5.2.1) feed the estimators.

The design is host data of O(blocks) size (block ids and one probability),
drawn on the host from one ``[λ]`` copy of the combined row with the
caller's ``numpy.random.Generator``, exactly as the reference draws it, so
S_c, S_r and π_r equal the reference's block for block.  A
``torch.Generator`` on the card would draw another valid sample, one that no
test could hold against the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class HybridPlan:
    """Block-level sampling plan with inclusion probabilities."""

    sc: np.ndarray  # any-k chosen block ids (π = 1)
    sr: np.ndarray  # random block ids (π = |S_r| / (|S_v| - |S_c|))
    num_valid_blocks: int  # |S_v|
    pi_r: float  # inclusion probability of each S_r block

    @property
    def blocks(self) -> np.ndarray:
        return np.concatenate([self.sc, self.sr]).astype(np.int64)

    def pi(self, block_ids: np.ndarray) -> np.ndarray:
        """π_i per §5.2.1 for blocks in the sample."""
        in_sc = np.isin(block_ids, self.sc)
        return np.where(in_sc, 1.0, self.pi_r)

    def pi_joint(self, i_in_sc: np.ndarray, j_in_sc: np.ndarray) -> np.ndarray:
        """π_ij per §5.2.1 (vectorized over pairs)."""
        nr, rem = len(self.sr), self.num_valid_blocks - len(self.sc)
        p1 = nr / rem if rem > 0 else 0.0
        p2 = p1 * (nr - 1) / (rem - 1) if rem > 1 else 0.0
        both_sc = i_in_sc & j_in_sc
        one_sc = i_in_sc ^ j_in_sc
        return np.where(both_sc, 1.0, np.where(one_sc, p1, p2))


def plan_hybrid(
    anyk_blocks: np.ndarray,
    combined: np.ndarray,
    k: int,
    alpha: float,
    records_per_block: int,
    rng: np.random.Generator,
) -> HybridPlan:
    """Build the two-step plan of §5.1.

    Step 1 trims the any-k selection to the densest blocks holding (1-α)k expected
    records; step 2 uniformly samples blocks from the remaining valid set until
    α·k expected records are covered.  ``combined`` is the ``[λ]`` row, numpy
    or a tensor on any device (copied to the host once).
    """
    if isinstance(combined, torch.Tensor):
        combined = combined.cpu().numpy()
    combined = np.asarray(combined, dtype=np.float64)
    valid_blocks = np.nonzero(combined > 0)[0]
    anyk_blocks = np.asarray(anyk_blocks, dtype=np.int64)

    target_c = (1.0 - alpha) * k
    got, sc = 0.0, []
    for b in anyk_blocks:
        if got >= target_c:
            break
        sc.append(int(b))
        got += combined[b] * records_per_block
    sc = np.asarray(sc, dtype=np.int64)

    remaining = np.setdiff1d(valid_blocks, sc, assume_unique=False)
    target_r = alpha * k
    if target_r <= 0 or remaining.size == 0:
        sr = np.asarray([], dtype=np.int64)
    else:
        mean_d = float(np.mean(combined[remaining]))
        want = int(np.ceil(target_r / max(mean_d * records_per_block, 1e-9)))
        want = min(want, remaining.size)
        sr = rng.choice(remaining, size=want, replace=False).astype(np.int64)

    pi_r = len(sr) / max(len(remaining), 1)
    return HybridPlan(
        sc=sc, sr=np.sort(sr), num_valid_blocks=int(valid_blocks.size), pi_r=pi_r
    )
