"""The port's three kernels against the JAX package's.

Inputs come from numpy with a seed and go through both packages.  On the CPU
each wrapper runs its plain PyTorch version, held here against the Pallas
kernel in interpret mode (``repro.kernels.ops``) and the reference's jnp
forms: the ⊕-combine and the gather bit for bit, the θ-counts exactly and
the θ-sums to ``rtol=1e-5`` (the same f32 terms added in another order;
at λ ≤ 1024 the observed gap is far smaller).  The CUDA kernels themselves
are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.density_map import combine_densities_batch_np
from repro.kernels import ops
from repro.kernels.density_combine import _combine_local
from repro.kernels.ref import theta_stats_batch_ref
from repro_torch.kernels import _lib
from repro_torch.kernels.density_combine import density_combine_batch
from repro_torch.kernels.plan_wave import block_gather
from repro_torch.kernels.theta_stats import theta_stats_batch


def _combine_inputs(seed: int, q: int, gamma: int, lam: int, rows: int = 12):
    rng = np.random.default_rng(seed)
    dens = (rng.random((rows, lam)) ** 2).astype(np.float32)
    dens[rng.random((rows, lam)) < 0.2] = 0.0  # empty blocks
    rm = rng.integers(0, rows, (q, gamma)).astype(np.int32)
    for i in range(q):  # ragged: pad a random tail with -1
        rm[i, rng.integers(1, gamma + 1):] = -1
    return dens, rm


COMBINE_CASES = [(0, 8, 3, 1000), (1, 5, 2, 512), (2, 1, 1, 37), (3, 8, 3, 1024)]


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("seed,q,gamma,lam", COMBINE_CASES)
def test_combine_plain_bit_identical_to_pallas_and_reference_folds(op, seed, q, gamma, lam):
    dens, rm = _combine_inputs(seed, q, gamma, lam)
    mine = density_combine_batch(torch.from_numpy(dens), torch.from_numpy(rm), op).numpy()
    np.testing.assert_array_equal(mine, np.asarray(ops.density_combine_batch(
        jnp.asarray(dens), jnp.asarray(rm), op)))
    np.testing.assert_array_equal(mine, np.asarray(_combine_local(
        jnp.asarray(dens), jnp.asarray(rm), op)))
    np.testing.assert_array_equal(mine, combine_densities_batch_np(dens, rm, op))


def _theta_inputs(seed: int, q: int, lam: int, t: int = 8):
    rng = np.random.default_rng(seed)
    x = (rng.random((q, lam)) ** 3).astype(np.float32)
    x[rng.random((q, lam)) < 0.3] = 0.0
    base = np.sort(x, axis=1)[:, ::-1][:, min(lam - 1, 5)]  # a θ near the top
    thetas = (base[:, None] * (1.0 + np.arange(t, dtype=np.float32))[None, :]).astype(np.float32)
    thetas[0] = 0.0  # θ = 0: every block clears it, zeros included
    return x, thetas


@pytest.mark.parametrize("seed,q,lam", [(0, 8, 1000), (1, 3, 2048), (2, 1, 7), (3, 5, 1024)])
def test_theta_stats_plain_against_pallas_and_oracle(seed, q, lam):
    x, th = _theta_inputs(seed, q, lam)
    counts, recsum = theta_stats_batch(torch.from_numpy(x), torch.from_numpy(th))
    for rc, rs in (ops.theta_stats_batch(jnp.asarray(x), jnp.asarray(th)),
                   theta_stats_batch_ref(jnp.asarray(x), jnp.asarray(th))):
        np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
        np.testing.assert_allclose(recsum.numpy(), np.asarray(rs), rtol=1e-5, atol=0)


def _slab(kind: str, lam: int, r: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "i32_3d":
        return rng.integers(-1, 40, (lam, r, 5)).astype(np.int32)
    if kind == "f32_3d":
        return rng.normal(size=(lam, r, 3)).astype(np.float32)
    if kind == "i8_2d":
        return (rng.random((lam, r)) < 0.9).astype(np.int8)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["i32_3d", "f32_3d", "i8_2d"])
@pytest.mark.parametrize("ids", [[3, 0, 7], [2, 2, 5, 2], [], list(range(9, -1, -1))],
                         ids=["ascending_union", "repeated", "empty", "all_reversed"])
def test_gather_plain_bit_identical_to_pallas(kind, ids):
    slab = _slab(kind, lam=10, r=50, seed=len(ids))
    ids_np = np.asarray(ids, dtype=np.int32)
    mine = block_gather(torch.from_numpy(slab), torch.from_numpy(ids_np)).numpy()
    ref = np.asarray(ops.block_gather(jnp.asarray(slab), jnp.asarray(ids_np)))
    assert mine.shape == ref.shape == (len(ids), *slab.shape[1:])
    assert mine.dtype == slab.dtype
    np.testing.assert_array_equal(mine, ref)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: no kernel launch
    is counted."""
    before = dict(_lib.LAUNCHES)
    dens, rm = _combine_inputs(0, 4, 2, 64)
    density_combine_batch(torch.from_numpy(dens), torch.from_numpy(rm))
    x, th = _theta_inputs(0, 4, 64)
    theta_stats_batch(torch.from_numpy(x), torch.from_numpy(th))
    block_gather(torch.from_numpy(_slab("i8_2d", 10, 8, 0)), torch.tensor([1, 2], dtype=torch.int32))
    assert _lib.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda: density_combine_batch(torch.zeros((4, 8), dtype=torch.float64),
                                  torch.zeros((2, 2), dtype=torch.int32)),
    lambda: density_combine_batch(torch.zeros((4, 8)), torch.zeros((2, 2), dtype=torch.int64)),
    lambda: density_combine_batch(torch.zeros((4, 8)), torch.zeros((2, 2), dtype=torch.int32), "xor"),
    lambda: theta_stats_batch(torch.zeros((2, 8)), torch.zeros((3, 8))),
    lambda: theta_stats_batch(torch.zeros((2, 8), dtype=torch.float16), torch.zeros((2, 8))),
    lambda: block_gather(torch.zeros((4, 3, 2), dtype=torch.int64), torch.zeros((1,), dtype=torch.int32)),
    lambda: block_gather(torch.zeros((4, 3, 2), dtype=torch.int32), torch.zeros((1,), dtype=torch.int64)),
    lambda: block_gather(torch.zeros((4,), dtype=torch.int32), torch.zeros((1,), dtype=torch.int32)),
], ids=["combine_f64", "combine_i64_rows", "combine_op", "theta_q_mismatch",
        "theta_f16", "gather_i64_slab", "gather_i64_ids", "gather_1d_slab"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()
