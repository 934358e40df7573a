"""Multi-threshold statistics (paper §4.1).

Counterpart of ``repro/kernels/theta_stats.py``: for ``[Q, λ]`` combined rows
and ``[Q, T]`` per-query thresholds,

    counts[q, t] = #{b : x[q, b] >= θ[q, t]}
    recsum[q, t] = Σ_{b : x[q, b] >= θ[q, t]} x[q, b]

and :func:`theta_stats`, the same for one ``[λ]`` row and ``[T]``
thresholds (the statistics of the θ-bisection ``ops.threshold_bisect``).
:func:`theta_bisect` is that whole bisection: its rounds, each of
``fanout`` thresholds, and the bracket steps between them.

On CUDA these are the kernels in ``csrc/theta_stats.cu``: batched, one
block per query; single row, one thread block cluster of 8 holding the row
in shared memory, which runs one round of statistics (:func:`theta_stats`)
or all the rounds of the bisection (:func:`theta_bisect`) in one launch;
fixed-order reductions, no atomics.  On the CPU they are
:func:`theta_stats_batch_plain`, :func:`theta_stats_plain` and
:func:`bisect_steps` over :func:`theta_stats_plain`.  ``counts`` agree
exactly.  ``recsum`` adds the same f32 terms in another order than the
reference, so it agrees to rounding only: the tests hold it with
``rtol=1e-5``.  The bisection's thresholds and bracket are the same f32
operations in the same order on both, so they agree bit for bit wherever
the rounds' ``recsum·rpb >= k`` tests agree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _lib

MAX_T = 8  # the kernel keeps T thresholds in registers


def theta_stats_batch_plain(
    combined: torch.Tensor, thetas: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the form of ``repro.kernels.ref.
    theta_stats_batch_ref``; any device."""
    m = combined[:, None, :] >= thetas[:, :, None]  # [Q, T, λ]
    counts = m.sum(dim=2).to(torch.float32)
    recsum = torch.where(m, combined[:, None, :], 0.0).sum(dim=2)
    return counts, recsum


def theta_stats_batch(
    combined: torch.Tensor,  # [Q, λ] f32
    thetas: torch.Tensor,  # [Q, T] f32, T <= 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts [Q, T], recsum [Q, T])``, both float32."""
    if combined.dtype != torch.float32 or combined.dim() != 2:
        raise ValueError("combined must be a [Q, λ] float32 tensor")
    if thetas.dtype != torch.float32 or thetas.dim() != 2:
        raise ValueError("thetas must be a [Q, T] float32 tensor")
    nq, lam = combined.shape
    if thetas.shape[0] != nq:
        raise ValueError("combined and thetas disagree on Q")
    if combined.device.type == "cpu" and thetas.device.type == "cpu":
        return theta_stats_batch_plain(combined, thetas)
    _lib.require_cuda("theta_stats_batch", combined, thetas)
    T = thetas.shape[1]
    if not 1 <= T <= MAX_T:
        raise ValueError(f"theta_stats_batch takes 1..{MAX_T} thresholds, got {T}")
    counts = torch.empty((nq, T), dtype=torch.float32, device=combined.device)
    recsum = torch.empty((nq, T), dtype=torch.float32, device=combined.device)
    if nq == 0:
        return counts, recsum
    lib = _lib.load()
    with torch.cuda.device(combined.device):
        rc = lib.nt_theta_stats_batch(
            combined.data_ptr(), nq, lam, thetas.data_ptr(), T,
            counts.data_ptr(), recsum.data_ptr(), _lib.stream_of(combined),
        )
    _lib.launched("theta_stats_batch", rc)
    return counts, recsum


def theta_stats_plain(
    combined: torch.Tensor, thetas: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch single-row version; any device."""
    counts, recsum = theta_stats_batch_plain(combined[None, :], thetas[None, :])
    return counts[0], recsum[0]


def theta_stats(
    combined: torch.Tensor,  # [λ] f32
    thetas: torch.Tensor,  # [T] f32, any T >= 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts [T], recsum [T])``, both float32, of one row: one launch."""
    if combined.dtype != torch.float32 or combined.dim() != 1:
        raise ValueError("combined must be a [λ] float32 tensor")
    if thetas.dtype != torch.float32 or thetas.dim() != 1 or thetas.shape[0] < 1:
        raise ValueError("thetas must be a [T] float32 tensor with T >= 1")
    if combined.device.type == "cpu" and thetas.device.type == "cpu":
        return theta_stats_plain(combined, thetas)
    _lib.require_cuda("theta_stats", combined, thetas)
    lam, T = combined.shape[0], thetas.shape[0]
    counts = torch.empty((T,), dtype=torch.float32, device=combined.device)
    recsum = torch.empty((T,), dtype=torch.float32, device=combined.device)
    lib = _lib.load()
    with torch.cuda.device(combined.device):
        rc = lib.nt_theta_stats(
            combined.data_ptr(), lam, thetas.data_ptr(), T, counts.data_ptr(),
            recsum.data_ptr(), _lib.stream_of(combined),
        )
    _lib.launched("theta_stats", rc)
    return counts, recsum


Trace = list[tuple[torch.Tensor, torch.Tensor]]


def bisect_steps(
    combined: torch.Tensor, k, records_per_block: int, rounds: int = 3, fanout: int = 16,
    stats=theta_stats_plain,
) -> tuple[torch.Tensor, torch.Tensor, Trace]:
    """The θ-bisection step by step over ``stats``, the plain version of
    :func:`theta_bisect`: every step is the reference's f32 operation in its
    order, on ``combined``'s device (no host round trip between rounds)."""
    dev = combined.device
    f32 = torch.float32
    k = torch.as_tensor(k, dtype=f32, device=dev)
    lo = torch.zeros((), dtype=f32, device=dev)
    # jnp.float32(1.0) + 1e-6: the Python float is rounded to f32 first
    hi = torch.tensor(np.float32(1.0) + np.float32(1e-6), dtype=f32, device=dev)
    steps = torch.arange(fanout, dtype=f32, device=dev) + 1.0
    # a tensor divisor: CUDA divides by a Python number as a multiply by its
    # reciprocal, which rounds differently unless fanout is a power of two
    fan = torch.tensor(float(fanout), dtype=f32, device=dev)
    pos = torch.arange(fanout, device=dev)
    trace = []
    for _ in range(rounds):
        ths = lo + (hi - lo) * steps / fan
        _, recsum = stats(combined, ths)
        trace.append((ths, recsum))
        ok = recsum * records_per_block >= k  # θ small enough to reach k
        any_ok = ok.any()
        # the largest θ that still reaches k
        idx = torch.where(any_ok, torch.where(ok, pos, -1).argmax(), 0)
        new_lo = torch.where(any_ok, ths[idx], lo)
        new_hi = torch.where(
            any_ok, torch.minimum(ths[torch.clamp(idx + 1, max=fanout - 1)], hi), ths[0]
        )
        lo, hi = new_lo, torch.where(idx == fanout - 1, hi, new_hi)
    return lo, hi, trace


def theta_bisect(
    combined: torch.Tensor,  # [λ] f32
    k: float,
    records_per_block: int,
    rounds: int = 3,
    fanout: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, Trace]:
    """The θ-bisection of ``ops.threshold_bisect`` on one row: ``(lo, hi,
    [(thresholds [fanout], recsum [fanout])] per round)``, where ``lo`` is
    θ* and ``[lo, hi)`` the final bracket.  On CUDA one launch of the
    cluster kernel runs every round; on the CPU :func:`bisect_steps` over
    :func:`theta_stats_plain`.  ``k`` and ``records_per_block`` are taken
    in f32, as the reference takes them."""
    if combined.dtype != torch.float32 or combined.dim() != 1:
        raise ValueError("combined must be a [λ] float32 tensor")
    if fanout < 1:
        raise ValueError(f"the bisection needs fanout >= 1, got {fanout}")
    if combined.device.type == "cpu":
        return bisect_steps(combined, k, records_per_block, rounds, fanout)
    _lib.require_cuda("theta_bisect", combined)
    dev = combined.device
    rounds = max(int(rounds), 0)
    ths = torch.empty((rounds, fanout), dtype=torch.float32, device=dev)
    recsum = torch.empty((rounds, fanout), dtype=torch.float32, device=dev)
    if rounds == 0:  # no round: the first bracket, and nothing to launch
        lo = torch.zeros((), dtype=torch.float32, device=dev)
        hi = torch.tensor(np.float32(1.0) + np.float32(1e-6), dtype=torch.float32, device=dev)
        return lo, hi, []
    lohi = torch.empty((2,), dtype=torch.float32, device=dev)
    lib = _lib.load()
    with torch.cuda.device(dev):
        rc = lib.nt_theta_bisect(
            combined.data_ptr(), combined.shape[0], rounds, fanout, float(np.float32(float(k))),
            float(np.float32(records_per_block)), ths.data_ptr(), recsum.data_ptr(),
            lohi.data_ptr(), _lib.stream_of(combined),
        )
    _lib.launched("theta_stats", rc)
    return lohi[0], lohi[1], list(zip(ths, recsum))
