"""Multi-threshold statistics (paper §4.1).

Counterpart of ``repro/kernels/theta_stats.py``: for ``[Q, λ]`` combined rows
and ``[Q, T]`` per-query thresholds,

    counts[q, t] = #{b : x[q, b] >= θ[q, t]}
    recsum[q, t] = Σ_{b : x[q, b] >= θ[q, t]} x[q, b]

and :func:`theta_stats`, the same for one ``[λ]`` row and ``[T]``
thresholds (the statistics of the θ-bisection ``ops.threshold_bisect``).
:func:`theta_bisect` is that whole bisection: its rounds, each of
``fanout`` thresholds, and the bracket steps between them.

The batched statistics also carry the steps around them on both of their
paths: :func:`theta_wave` is the device wave's θ-round (θ_q from the cut,
then ``theta_count`` and ``expected_records``), and
:func:`bisect_round_batch` one round of the sharded θ-bisection (the
previous round's bracket step, then this round's statistics into the
buffer the ranks all-reduce).

On CUDA these are the kernels in ``csrc/theta_stats.cu``: batched, a
thread block cluster of 1–8 blocks a row (so the wave's blocks cover the
card), any T in one launch; single row, one cluster of 8 holding the row
in shared memory, which runs one round of statistics (:func:`theta_stats`)
or all the rounds of the bisection (:func:`theta_bisect`) in one launch;
fixed-order reductions, no atomics.  On the CPU they are the ``*_plain``
functions and :func:`bisect_steps` over :func:`theta_stats_plain`: the
same steps one tensor operation at a time.  ``counts`` agree exactly.
``recsum`` adds the same f32 terms in another order than the reference,
so it agrees to rounding only: the tests hold it with ``rtol=1e-5``.  The
thresholds and brackets are the same f32 operations in the same order on
both, so they agree bit for bit wherever the rounds' ``recsum·rpb >= k``
tests agree.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _lib


def theta_stats_batch_plain(
    combined: torch.Tensor, thetas: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the form of ``repro.kernels.ref.
    theta_stats_batch_ref``; any device."""
    m = combined[:, None, :] >= thetas[:, :, None]  # [Q, T, λ]
    counts = m.sum(dim=2).to(torch.float32)
    recsum = torch.where(m, combined[:, None, :], 0.0).sum(dim=2)
    return counts, recsum


@_lib.no_gradient
def theta_stats_batch(
    combined: torch.Tensor,  # [Q, λ] f32
    thetas: torch.Tensor,  # [Q, T] f32, any T >= 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts [Q, T], recsum [Q, T])``, both float32: one launch."""
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
    if T < 1:
        raise ValueError("theta_stats_batch needs T >= 1 thresholds")
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


def theta_wave_plain(
    masked: torch.Tensor, sorted_d: torch.Tensor, n_sel: torch.Tensor, records_per_block: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`theta_wave`, the device wave's steps
    one operation at a time; any device."""
    has_cut = n_sel > 0
    last = torch.gather(sorted_d, 1, (n_sel.long() - 1).clamp(min=0)[:, None])[:, 0]
    theta = torch.where(has_cut, last, 0.0)
    counts, recsum = theta_stats_batch_plain(masked, theta[:, None] * 1.0)  # θ·1 only
    theta_count = torch.where(has_cut, counts[:, 0], 0.0)
    expected = torch.where(has_cut, recsum[:, 0] * float(records_per_block), 0.0)
    return theta, theta_count, expected


@_lib.no_gradient
def theta_wave(
    masked: torch.Tensor,  # [Q, λ] f32 exclusion-masked combined rows
    sorted_d: torch.Tensor,  # [Q, λ] f32 the same rows sorted descending
    n_sel: torch.Tensor,  # [Q] int32 each row's THRESHOLD prefix length
    records_per_block: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The device wave's θ-round: ``(theta, theta_count, expected)``, each
    ``[Q]`` f32.  θ_q is the density of the last block of row q's prefix
    (0 without one); ``theta_count`` is how many blocks clear θ_q and
    ``expected`` the record mass they hold (both 0 without a prefix), as
    ``repro.kernels.plan_wave.plan_wave_from_combined`` computes them.  On
    CUDA one launch of the batched kernel."""
    for t, what in ((masked, "masked"), (sorted_d, "sorted_d")):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{what} must be a [Q, λ] float32 tensor")
    if sorted_d.shape != masked.shape:
        raise ValueError("masked and sorted_d differ in shape")
    if n_sel.dtype != torch.int32 or n_sel.shape != masked.shape[:1]:
        raise ValueError("n_sel must be a [Q] int32 tensor")
    if all(t.device.type == "cpu" for t in (masked, sorted_d, n_sel)):
        return theta_wave_plain(masked, sorted_d, n_sel, records_per_block)
    _lib.require_cuda("theta_wave", masked, sorted_d, n_sel)
    nq, lam = masked.shape
    out = torch.empty((3, nq), dtype=torch.float32, device=masked.device)
    if nq == 0:
        return out[0], out[1], out[2]
    lib = _lib.load()
    with torch.cuda.device(masked.device):
        rc = lib.nt_theta_wave(
            masked.data_ptr(), sorted_d.data_ptr(), n_sel.data_ptr(), nq, lam,
            float(np.float32(records_per_block)), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), _lib.stream_of(masked),
        )
    _lib.launched("theta_stats_batch", rc)
    return out[0], out[1], out[2]


# --------------------------------------------------------------------------
# One round of the batched (sharded) θ-bisection.
# --------------------------------------------------------------------------

# the first bracket's top: the reference's jnp.full((Q,), 1.0 + 1e-6, f32)
BISECT_HI0 = float(np.float32(1.0 + 1e-6))


class BisectCarry(NamedTuple):
    """What a round of the batched θ-bisection hands the next: the bracket
    ``[lo, hi)`` of its thresholds, the selection so far, and its
    statistics (``[counts | recsum]``, all-reduced by the caller between
    rounds).  On CUDA views of one buffer, updated in place."""

    lo: torch.Tensor  # [Q] f32
    hi: torch.Tensor  # [Q] f32
    n_sel: torch.Tensor  # [Q] int32
    exp: torch.Tensor  # [Q] f32
    stats: torch.Tensor  # [Q, 2T] f32


def bisect_carry(nq: int, fanout: int, device) -> BisectCarry:
    """An unfilled carry for ``nq`` rows (the first round fills it)."""
    buf = torch.empty((nq * (4 + 2 * fanout),), dtype=torch.float32, device=device)
    return BisectCarry(buf[:nq], buf[nq:2 * nq], buf[3 * nq:4 * nq].view(torch.int32),
                       buf[2 * nq:3 * nq], buf[4 * nq:].view(nq, 2 * fanout))


def _bisect_thresholds(lo, hi, fanout: int) -> torch.Tensor:
    dev = lo.device
    # a tensor divisor: CUDA divides by a Python number as a multiply by
    # its reciprocal, which rounds otherwise for most fanouts
    steps = ((torch.arange(fanout, dtype=torch.float32, device=dev) + 1.0)
             / torch.tensor(float(fanout), device=dev))
    return lo[:, None] + (hi - lo)[:, None] * steps[None, :]  # [Q, T]


def bisect_round_batch_plain(
    combined: torch.Tensor, ks: torch.Tensor, records_per_block: int, carry: BisectCarry,
    first: bool, stats: bool = True,
) -> BisectCarry:
    """Plain PyTorch version of :func:`bisect_round_batch`: the step and the
    statistics one tensor operation at a time; any device."""
    nq = combined.shape[0]
    fanout = carry.stats.shape[1] // 2
    dev = combined.device
    if first:
        lo = torch.zeros((nq,), dtype=torch.float32, device=dev)
        hi = torch.full((nq,), BISECT_HI0, dtype=torch.float32, device=dev)
        n_sel = torch.zeros((nq,), dtype=torch.int32, device=dev)
        exp = torch.zeros((nq,), dtype=torch.float32, device=dev)
    else:
        lo, hi, n_sel, exp, st = carry
        ths = _bisect_thresholds(lo, hi, fanout)
        counts, recsum = st[:, :fanout], st[:, fanout:]
        pos = torch.arange(fanout, device=dev)[None, :]

        def take(a, idx):
            return torch.gather(a, 1, idx[:, None])[:, 0]

        ok = recsum * records_per_block >= ks[:, None]
        any_ok = ok.any(dim=1)
        idx = torch.where(any_ok, torch.where(ok, pos, -1).max(dim=1).values, 0)
        n_sel = torch.where(any_ok, take(counts, idx), n_sel.float()).to(torch.int32)
        exp = torch.where(any_ok, take(recsum, idx) * records_per_block, exp)
        th_at = take(ths, idx)
        th_next = take(ths, (idx + 1).clamp(max=fanout - 1))
        new_hi = torch.where(any_ok & (idx < fanout - 1), th_next, hi)
        lo, hi = torch.where(any_ok, th_at, lo), torch.where(any_ok, new_hi, ths[:, 0])
    st = carry.stats
    if stats:
        st = torch.cat(theta_stats_batch_plain(combined, _bisect_thresholds(lo, hi, fanout)),
                       dim=1)
    return BisectCarry(lo, hi, n_sel, exp, st)


@_lib.no_gradient
def bisect_round_batch(
    combined: torch.Tensor,  # [Q, λ] f32 (a rank's slab)
    ks: torch.Tensor,  # [Q] f32 record targets
    records_per_block: int,
    carry: BisectCarry,
    first: bool,
    stats: bool = True,
) -> BisectCarry:
    """One round of the batched θ-bisection (``repro.core.sharded.
    sharded_threshold_bisect_batch``'s loop body, in its f32 order): unless
    ``first``, the bracket step of the previous round from ``carry`` (whose
    ``stats`` the caller has all-reduced), then, with ``stats``, this
    round's ``fanout`` thresholds and their local statistics in the new
    carry's ``stats``.  A last call with ``stats=False`` applies the final
    step.  On CUDA one launch of the batched kernel, the carry updated in
    place; on the CPU :func:`bisect_round_batch_plain`."""
    if combined.dtype != torch.float32 or combined.dim() != 2:
        raise ValueError("combined must be a [Q, λ] float32 tensor")
    nq, lam = combined.shape
    if carry.stats.dim() != 2 or carry.stats.shape[0] != nq or carry.stats.shape[1] < 2 \
            or carry.stats.shape[1] % 2:
        raise ValueError("the carry's statistics must be [Q, 2·fanout]")
    if combined.device.type == "cpu" and ks.device.type == "cpu":
        return bisect_round_batch_plain(combined, ks, records_per_block, carry, first, stats)
    _lib.require_cuda("bisect_round_batch", combined, ks, *carry)
    if nq == 0:
        return carry
    lib = _lib.load()
    with torch.cuda.device(combined.device):
        rc = lib.nt_theta_bisect_batch(
            combined.data_ptr(), nq, lam, ks.data_ptr(), carry.stats.shape[1] // 2,
            float(np.float32(records_per_block)), BISECT_HI0, int(first), int(stats),
            carry.lo.data_ptr(), carry.hi.data_ptr(), carry.n_sel.data_ptr(),
            carry.exp.data_ptr(), carry.stats.data_ptr(), _lib.stream_of(combined),
        )
    _lib.launched("theta_stats_batch", rc)
    return carry


def theta_stats_plain(
    combined: torch.Tensor, thetas: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch single-row version; any device."""
    counts, recsum = theta_stats_batch_plain(combined[None, :], thetas[None, :])
    return counts[0], recsum[0]


@_lib.no_gradient
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


@_lib.no_gradient
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
