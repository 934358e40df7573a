"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

The kernels have no CPU or interpret mode, so every case here carries the
``cuda`` marker and skips where there is no card.  The file imports neither
JAX nor the JAX package, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The combines, the gather and the prefix scan must match bit for bit, the
θ-counts exactly and the θ-sums to ``rtol=1e-5`` (the same f32 terms in
another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ops
from repro_torch.kernels.density_combine import (
    density_combine, density_combine_batch, density_combine_batch_plain, density_combine_plain,
)
from repro_torch.kernels.plan_wave import block_gather, block_gather_plain
from repro_torch.kernels.theta_stats import (
    theta_stats, theta_stats_batch, theta_stats_batch_plain, theta_stats_plain,
)
from repro_torch.kernels.window_scan import prefix_sum, prefix_sum_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _combine_inputs(seed: int, q: int, gamma: int, lam: int, rows: int = 12):
    rng = np.random.default_rng(seed)
    dens = (rng.random((rows, lam)) ** 2).astype(np.float32)
    dens[rng.random((rows, lam)) < 0.2] = 0.0
    rm = rng.integers(0, rows, (q, gamma)).astype(np.int32)
    for i in range(q):
        rm[i, rng.integers(1, gamma + 1):] = -1
    return torch.from_numpy(dens), torch.from_numpy(rm)


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("seed,q,gamma,lam", [(0, 8, 3, 1000), (1, 5, 2, 512), (2, 1, 1, 37),
                                              (3, 64, 3, 12208)])
def test_combine_kernel_bit_identical_to_plain(cuda, op, seed, q, gamma, lam):
    dens, rm = _combine_inputs(seed, q, gamma, lam)
    n0 = _lib.LAUNCHES["density_combine_batch"]
    out = density_combine_batch(dens.to(cuda), rm.to(cuda), op)
    assert _lib.LAUNCHES["density_combine_batch"] == n0 + 1
    assert torch.equal(out, density_combine_batch_plain(dens.to(cuda), rm.to(cuda), op))
    assert torch.equal(out.cpu(), density_combine_batch_plain(dens, rm, op))


@pytest.mark.parametrize("seed,q,lam", [(0, 8, 1000), (1, 64, 12208), (2, 1, 7), (3, 3, 0)])
def test_theta_kernel_against_plain(cuda, seed, q, lam):
    rng = np.random.default_rng(seed)
    x = (rng.random((q, lam)) ** 3).astype(np.float32)
    x[rng.random((q, lam)) < 0.3] = 0.0
    th = np.sort(rng.random((q, 8)).astype(np.float32), axis=1)
    th[0] = 0.0
    xc, tc = torch.from_numpy(x).to(cuda), torch.from_numpy(th).to(cuda)
    counts, recsum = theta_stats_batch(xc, tc)
    pc, ps = theta_stats_batch_plain(xc, tc)
    assert torch.equal(counts, pc)
    torch.testing.assert_close(recsum, ps, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype,d", [(torch.int32, 5), (torch.float32, 3), (torch.int8, 0)])
@pytest.mark.parametrize("r", [50, 8192])
def test_gather_kernel_bit_identical_to_plain(cuda, dtype, d, r):
    g = torch.Generator().manual_seed(r)
    shape = (12, r, d) if d else (12, r)
    slab = torch.randint(-100, 100, shape, generator=g).to(dtype).to(cuda)
    for ids in ([3, 0, 7], [2, 2, 5, 2], list(range(11, -1, -1))):
        i = torch.tensor(ids, dtype=torch.int32, device=cuda)
        assert torch.equal(block_gather(slab, i), block_gather_plain(slab, i))
    n0 = _lib.LAUNCHES["block_gather"]
    empty = block_gather(slab, torch.zeros((0,), dtype=torch.int32, device=cuda))
    assert empty.shape == (0, *slab.shape[1:]) and _lib.LAUNCHES["block_gather"] == n0


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("gamma,lam", [(1, 37), (2, 1000), (3, 12208), (5, 4096)])
def test_single_combine_kernel_bit_identical_to_plain(cuda, op, gamma, lam):
    dens, _ = _combine_inputs(gamma, 1, 1, lam)
    rows = torch.from_numpy(np.random.default_rng(lam).integers(0, 12, gamma).astype(np.int32))
    n0 = _lib.LAUNCHES["density_combine"]
    out = density_combine(dens.to(cuda), rows.to(cuda), op)
    assert _lib.LAUNCHES["density_combine"] == n0 + 1
    assert torch.equal(out.cpu(), density_combine_plain(dens, rows, op))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 65537, 12208])
def test_prefix_sum_kernel_bit_identical_to_plain(cuda, n):
    rng = np.random.default_rng(n)
    x = (rng.random(n) ** 4).astype(np.float32)
    x[rng.random(n) < 0.3] = 0.0
    n0 = _lib.LAUNCHES["prefix_sum"]
    out = prefix_sum(torch.from_numpy(x).to(cuda))
    assert _lib.LAUNCHES["prefix_sum"] == n0 + 1
    assert torch.equal(out.cpu(), prefix_sum_plain(torch.from_numpy(x)))


@pytest.mark.parametrize("q,n", [(64, 12208), (3, 17), (5, 4097), (2, 0)])
def test_batched_prefix_sum_kernel_bit_identical_to_plain(cuda, q, n):
    rng = np.random.default_rng(q * n)
    x = torch.from_numpy((rng.normal(size=(q, n)) * 100).astype(np.float32))
    out = prefix_sum(x.to(cuda))
    assert torch.equal(out.cpu(), prefix_sum_plain(x))
    assert torch.equal(out, prefix_sum_plain(x.to(cuda)))


@pytest.mark.parametrize("lam,T", [(12208, 16), (1000, 1), (7, 9), (5000, 32)])
def test_single_theta_kernel_against_plain(cuda, lam, T):
    rng = np.random.default_rng(lam + T)
    x = (rng.random(lam) ** 3).astype(np.float32)
    x[rng.random(lam) < 0.3] = 0.0
    th = np.sort(rng.random(T).astype(np.float32))
    th[0] = 0.0
    xc, tc = torch.from_numpy(x).to(cuda), torch.from_numpy(th).to(cuda)
    n0 = _lib.LAUNCHES["theta_stats"]
    counts, recsum = theta_stats(xc, tc)
    assert _lib.LAUNCHES["theta_stats"] == n0 + 1
    pc, ps = theta_stats_plain(xc, tc)
    assert torch.equal(counts, pc)
    torch.testing.assert_close(recsum, ps, rtol=1e-5, atol=0)
    again = theta_stats(xc, tc)[1]
    assert torch.equal(again, recsum)  # a fixed order: the same bits every run


def test_threshold_bisect_on_the_kernel_matches_the_plain_steps(cuda):
    rng = np.random.default_rng(0)
    x = (rng.random(12208) * (rng.random(12208) < 0.3)).astype(np.float32)
    xc = torch.from_numpy(x).to(cuda)
    for k in (10.0, 200.0, 3000.0, 1e9):
        n0 = _lib.LAUNCHES["theta_stats"]
        theta = ops.threshold_bisect(xc, k, 10)
        assert _lib.LAUNCHES["theta_stats"] == n0 + 3
        assert float(theta) == float(ops.threshold_bisect_plain(xc, k, 10))
