"""The port's optimiser pieces against the JAX package's, on the CPU.

``warmup_cosine``, ``clip_by_global_norm``, ``adamw_update`` (several steps,
f32 and bf16 moments) and the int8 gradient compression run on the same
numpy inputs in both packages.  The port keeps the reference's arithmetic
and order of operations; its f32 results are held to rtol 1e-6 (the two
frameworks' ``pow`` and their sums over leaves may round differently in
the last place), bf16 moments to one bf16 rounding (2^-8 relative), and
the quantised ``q`` exactly (both round half to even).  The last four
tests mirror ``tests/test_substrate.py:117-157`` on the port alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro.optim import compress as RC
from repro_torch import optim as T
from repro_torch.optim import compress as TC

SHAPES = {"embed": (12, 8), "layers.0.mamba.w_x": (8, 16), "final_norm.w": (8,)}


def _tree(rng, scale=1.0):
    return {n: (rng.normal(0.0, scale, s)).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 57, 100, 140])
def test_warmup_cosine_matches_reference(step):
    ref = float(R.warmup_cosine(step, 3e-4, 10, 100))
    got = T.warmup_cosine(step, 3e-4, 10, 100)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(ref, rel=1e-6, abs=0.0)
    # a step held as a tensor gives the same value on its device
    assert float(T.warmup_cosine(torch.tensor(step, dtype=torch.int32), 3e-4, 10, 100)) == \
        float(got)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(1))
    rc, rn = R.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    tc, tn = T.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    assert float(tn) == pytest.approx(float(rn), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_reference(state_dtype):
    """Five steps on random gradients under the warm-up and cosine rates."""
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rs = R.adamw_init(rp, getattr(jnp, state_dtype))
    ts = T.adamw_init(tp, getattr(torch, state_dtype))
    for step in range(5):
        g = _tree(rng, scale=0.1)
        lr_r = R.warmup_cosine(rs.step, 1e-2, 2, 8)
        lr_t = T.warmup_cosine(ts.step, 1e-2, 2, 8)
        rp, rs = R.adamw_update(rp, {k: jnp.asarray(v) for k, v in g.items()}, rs, lr_r)
        tp_out, ts = T.adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, lr_t)
        assert tp_out is tp  # updated in place
    assert int(ts.step) == int(rs.step) == 5 and ts.step.dtype == torch.int32
    mom_rtol = 1e-6 if state_dtype == "float32" else 2.0**-8
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]), rtol=1e-6, atol=1e-9)
        assert ts.m[k].dtype == getattr(torch, state_dtype)
        np.testing.assert_allclose(ts.m[k].float().numpy(), np.asarray(rs.m[k], np.float32),
                                   rtol=mom_rtol, atol=1e-12)
        np.testing.assert_allclose(ts.v[k].float().numpy(), np.asarray(rs.v[k], np.float32),
                                   rtol=mom_rtol, atol=1e-12)


def test_compression_round_trip_matches_reference():
    """q exact, scale and residual to f32 rounding, over steps with error
    feedback."""
    rng = np.random.default_rng(3)
    g0 = _tree(rng)
    rs = RC.compress_init({k: jnp.asarray(v) for k, v in g0.items()})
    ts = TC.compress_init({k: torch.from_numpy(v) for k, v in g0.items()})
    for _ in range(4):
        g = _tree(rng)
        rq, rs = RC.compress_grads({k: jnp.asarray(v) for k, v in g.items()}, rs)
        tq, ts = TC.compress_grads({k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in g:
            assert tq[k][0].dtype == torch.int8
            np.testing.assert_array_equal(tq[k][0].numpy(), np.asarray(rq[k][0]))
            assert float(tq[k][1]) == pytest.approx(float(rq[k][1]), rel=1e-7)
            np.testing.assert_allclose(ts.error[k].numpy(), np.asarray(rs.error[k]),
                                       rtol=1e-6, atol=1e-7)
        rd, td = RC.decompress_grads(rq), TC.decompress_grads(tq)
        for k in g:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(rd[k]), rtol=1e-6, atol=0)


def test_quantize_rounds_half_to_even_as_reference():
    """Values that land on .5 steps of the scale: q equal to the reference's."""
    g = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 0.0], np.float32)
    err = np.zeros_like(g)
    rq, rsc, re = RC.quantize(jnp.asarray(g), jnp.asarray(err))
    tq, tsc, te = TC.quantize(torch.from_numpy(g), torch.from_numpy(err))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(tq.numpy(), [127, 0, 2, 2, 0, -2, 4, 0])
    np.testing.assert_allclose(te.numpy(), np.asarray(re), rtol=0, atol=1e-7)


# ---- tests/test_substrate.py:117-157 on the port


def test_adamw_descends_quadratic():
    w = torch.tensor([5.0, -3.0])
    p = {"w": w}
    st = T.adamw_init(p)
    for _ in range(200):
        g = {"w": 2 * p["w"]}
        p, st = T.adamw_update(p, g, st, lr=0.05, weight_decay=0.0)
    assert p["w"] is w
    assert float(p["w"].abs().max()) < 0.3


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = T.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)


def test_warmup_cosine_shape():
    assert float(T.warmup_cosine(0, 1e-3, 10, 100)) == 0.0
    assert float(T.warmup_cosine(10, 1e-3, 10, 100)) == pytest.approx(1e-3)
    assert float(T.warmup_cosine(100, 1e-3, 10, 100)) == pytest.approx(1e-4, rel=0.01)


def test_gradient_compression_error_feedback():
    """Accumulated dequantized grads converge to accumulated true grads."""
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.normal(0, 1, 256).astype(np.float32))}
    st = TC.compress_init(g_true)
    acc_q = np.zeros(256)
    steps = 50
    for _ in range(steps):
        q, st = TC.compress_grads(g_true, st)
        acc_q += TC.decompress_grads(q)["w"].numpy()
    rel = np.abs(acc_q / steps - g_true["w"].numpy()).max()
    assert rel < 0.01  # error feedback keeps long-run average unbiased
