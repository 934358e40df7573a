"""The port's θ-bisection against the JAX package's, on the CPU.

``ops.threshold_bisect`` (``threshold_bisect`` of ``repro.kernels.ops``,
its statistics in Pallas interpret mode, as the reference's tests run it)
and the port's bisection (the plain steps on the CPU; on CUDA one launch of
the ``theta_stats`` kernel, held against these steps by
``tests/test_torch_cuda.py``) take the same seeded rows.

The port computes each round's thresholds ``lo + (hi − lo)·(t + 1) /
fanout`` as written, with an IEEE division.  XLA compiles the reference's
division by the constant ``fanout`` into a multiply by its f32 reciprocal
(and folds the first round's constants), so for a fanout that is not a
power of two the reference's grid points can lie one f32 ulp away from the
quotient, and a round's lo carries that into the next round's grid.  So
θ* is held bit for bit at fanout 16 and to one ulp a round, with the same
selected blocks ``combined >= θ*``, at 10, 12 and 33; and the port's
steps are held bit for bit, thresholds and θ* in every round, against a
numpy model of the reference's source arithmetic (f32, IEEE division).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import _lib
from repro_torch.kernels import ops as tops
from repro_torch.kernels.theta_stats import theta_bisect, theta_stats

RPB = 10


def _rows(seed: int, lam: int = 1000, n: int = 3):
    rng = np.random.default_rng(seed)
    return [(rng.random(lam) * (rng.random(lam) < 0.3)).astype(np.float32) for _ in range(n)]


def _ks(x: np.ndarray) -> tuple[float, ...]:
    total = float(x.astype(np.float64).sum()) * RPB
    return (1.0, 0.01 * total, 0.2 * total, 0.7 * total, 2 * total + 1)


@pytest.mark.parametrize("rounds", [1, 3, 5])
@pytest.mark.parametrize("fanout", [10, 12, 16, 33])
def test_threshold_bisect_against_the_reference(fanout, rounds):
    exact = 0
    for x in _rows(fanout + rounds):
        for k in _ks(x):
            mine = np.float32(tops.threshold_bisect(torch.from_numpy(x), k, RPB, rounds, fanout))
            ref = np.float32(ops.threshold_bisect(jnp.asarray(x), k, RPB, rounds, fanout))
            if fanout == 16:  # a power of two: the reciprocal multiply is exact
                assert mine == ref
            assert abs(mine - ref) <= rounds * np.spacing(ref)
            np.testing.assert_array_equal(x >= mine, x >= ref)
            exact += mine == ref
    assert exact > 0


def _model(x: np.ndarray, k: float, rounds: int, fanout: int):
    """The reference's ``threshold_bisect`` as written, in numpy f32: each
    round's thresholds, the ``recsum·rpb >= k`` tests, then lo."""
    f32 = np.float32
    lo, hi = f32(0.0), f32(1.0) + f32(1e-6)
    steps = np.arange(fanout, dtype=f32) + f32(1.0)
    out = []
    for _ in range(rounds):
        ths = lo + (hi - lo) * steps / f32(fanout)
        recsum = np.asarray([x[x >= t].sum(dtype=np.float64) for t in ths], np.float32)
        ok = recsum * f32(RPB) >= f32(k)
        idx = int(np.flatnonzero(ok)[-1]) if ok.any() else 0
        new_lo = ths[idx] if ok.any() else lo
        new_hi = min(ths[min(idx + 1, fanout - 1)], hi) if ok.any() else ths[0]
        lo, hi = new_lo, hi if idx == fanout - 1 else new_hi
        out.append((ths, ok))
    return lo, hi, out


@pytest.mark.parametrize("rounds", [1, 3, 5])
@pytest.mark.parametrize("fanout", [1, 10, 12, 16, 33])
def test_plain_steps_are_the_reference_arithmetic(fanout, rounds):
    """Thresholds and tests in every round, then θ* and the bracket, bit for
    bit the numpy model (no round here has a sum within rounding of k)."""
    for x in _rows(100 + fanout + rounds):
        for k in _ks(x):
            lo, hi, trace = tops.bisect_rounds(torch.from_numpy(x), k, RPB, rounds, fanout)
            mlo, mhi, model = _model(x, k, rounds, fanout)
            assert len(trace) == rounds
            for (ths, rs), (mths, mok) in zip(trace, model):
                np.testing.assert_array_equal(ths.numpy().view(np.int32), mths.view(np.int32))
                np.testing.assert_array_equal(rs.numpy() * np.float32(RPB) >= np.float32(k), mok)
            assert (lo.item(), hi.item()) == (float(mlo), float(mhi))


def test_cpu_bisection_paths_agree_and_launch_nothing():
    """On the CPU ``stats=None`` (``theta_bisect``, the plain steps) and the
    step-by-step loop over the one-round wrapper give the same bracket and
    trace; no launch is counted; no round leaves the first bracket."""
    x = _rows(7)[0]
    before = dict(_lib.LAUNCHES)
    lo, hi, trace = tops.bisect_rounds(torch.from_numpy(x), 50.0, RPB)
    slo, shi, strace = tops.bisect_rounds(torch.from_numpy(x), 50.0, RPB, stats=theta_stats)
    assert (lo.item(), hi.item()) == (slo.item(), shi.item())
    for (a, b), (c, d) in zip(trace, strace):
        assert torch.equal(a, c) and torch.equal(b, d)
    lo0, hi0, trace0 = theta_bisect(torch.from_numpy(x), 50.0, RPB, rounds=0)
    assert trace0 == [] and lo0.item() == 0.0
    assert hi0.item() == float(np.float32(1.0) + np.float32(1e-6))
    assert _lib.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda: theta_bisect(torch.zeros((2, 8)), 1.0, RPB),
    lambda: theta_bisect(torch.zeros(8, dtype=torch.float64), 1.0, RPB),
    lambda: theta_bisect(torch.zeros(8), 1.0, RPB, fanout=0),
])
def test_theta_bisect_rejects_bad_arguments(call):
    with pytest.raises(ValueError):
        call()


def test_theta_bisect_refuses_devices_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="no kernel"):
        theta_bisect(torch.empty((8,), device="meta"), 1.0, RPB)
