"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

The kernels have no CPU or interpret mode, so every case here carries the
``cuda`` marker and skips where there is no card.  The file imports neither
JAX nor the JAX package, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The combine and the gather must match bit for bit, the θ-counts exactly
and the θ-sums to ``rtol=1e-5`` (the same f32 terms in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.density_combine import (
    density_combine_batch, density_combine_batch_plain,
)
from repro_torch.kernels.plan_wave import block_gather, block_gather_plain
from repro_torch.kernels.theta_stats import theta_stats_batch, theta_stats_batch_plain

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
