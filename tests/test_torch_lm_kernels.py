"""The LM substrate's kernels (#8 flash attention, #9 the SSD scan) and the
pure-tensor forms beside them, against the JAX package's.

Inputs come from numpy with a seed and go through both packages.  On the CPU
each wrapper runs its plain PyTorch version: ``flash_attention``'s is a port
of ``repro.kernels.ref.attention_ref``, held against it on the reference
sweep's cases (``tests/test_kernels.py:160-178``: padding, right-aligned
decode-style, window, cross, GQA) at D ∈ {64, 112, 128}, f32 at 2e-3 and
bf16 at 3e-2, the reference's own tolerances, and against the Pallas
kernel in interpret mode, also at gemma3-12b's D = 240.  ``ssd_scan``'s is ``ssd_chunked``, the port of
``models.layers.ssd_chunked``, held against it and ``ref.ssd_ref`` (outputs
and final state) at atol 2e-3 / rtol 1e-2, also where the decay is slow
enough that the state carried from chunk to chunk dominates the output;
``ssd_scan(return_state=True)`` returns the same final state.  The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref
from repro.models import layers as jlayers
from repro_torch.kernels import _lib
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import attention_plain, flash_attention
from repro_torch.kernels.ssd_chunk import CHUNK, ssd_chunked, ssd_scan
from repro_torch.models import layers as tlayers

TOL = {"float32": 2e-3, "bfloat16": 3e-2}
ATTN_CASES = [
    (1, 2, 1, 128, 128, True, None),
    (2, 4, 4, 100, 100, True, None),  # padding
    (1, 4, 2, 128, 256, True, None),  # decode-style (q shorter, right-aligned)
    (1, 2, 1, 200, 200, True, 64),  # sliding window
    (1, 2, 2, 64, 192, False, None),  # cross-attention
]


def _attn_inputs(seed, b, hq, hkv, s, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("b,hq,hkv,s,t,causal,win", ATTN_CASES)
def test_attention_plain_matches_reference_oracle(b, hq, hkv, s, t, causal, win, d, dtype):
    q, k, v = _attn_inputs(s + t + d, b, hq, hkv, s, t, d)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    mine = flash_attention(tq, tk, tv, causal=causal, window=win)
    assert mine.dtype == tdt and tuple(mine.shape) == q.shape
    assert torch.equal(mine, attention_plain(tq, tk, tv, causal, win))  # CPU: the plain version
    want = ref.attention_ref(*(jnp.asarray(x).astype(dtype) for x in (q, k, v)),
                             causal=causal, window=win)
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_attention_plain_matches_pallas_kernel_in_interpret_mode():
    q, k, v = _attn_inputs(7, 1, 2, 1, 200, 200, 64)
    mine = tops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=64)
    want = ops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), window=64)
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("win", [None, 48], ids=["global", "window"])
def test_attention_plain_at_gemma3_head_dim_matches_oracle_and_pallas_kernel(win):
    """gemma3-12b's head dim D = 3840 / 16 = 240, past the old 128-column
    limit of the CUDA kernel: GQA 4:2, S = T = 150 (three 64-row tiles, the
    last ragged), causal, globally and with a window; against ``attention_ref``
    and the Pallas kernel in interpret mode."""
    q, k, v = _attn_inputs(240, 1, 4, 2, 150, 150, 240)
    mine = tops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=win)
    assert tuple(mine.shape) == (1, 4, 150, 240)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for want in (ref.attention_ref(jq, jk, jv, causal=True, window=win),
                 ops.flash_attention(jq, jk, jv, window=win)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


def _ssd_inputs(seed, b, h, s, dh, ds):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((b, h, s, dh)) * 0.1).astype(np.float32)
    ld = -np.abs(rng.standard_normal((b, h, s)) * 0.1).astype(np.float32)
    bm = (rng.standard_normal((b, h, s, ds)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, h, s, ds)) * 0.3).astype(np.float32)
    return u, ld, bm, cm


SSD_CASES = [(1, 1, 128, 32, 16), (2, 3, 256, 64, 32), (1, 2, 384, 16, 16), (1, 2, 256, 64, 128)]


@pytest.mark.parametrize("b,h,s,dh,ds", SSD_CASES)
def test_ssd_plain_matches_reference_recurrence_and_chunked_form(b, h, s, dh, ds):
    xs = _ssd_inputs(b * 100 + s + dh + ds, b, h, s, dh, ds)
    y, state = ssd_chunked(*(torch.from_numpy(x) for x in xs), CHUNK, return_state=True)
    assert torch.equal(ssd_scan(*(torch.from_numpy(x) for x in xs)), y)
    yref, href = ref.ssd_ref(*(jnp.asarray(x) for x in xs))
    np.testing.assert_allclose(y.numpy(), np.asarray(yref), atol=2e-3, rtol=1e-2)
    np.testing.assert_allclose(state.numpy(), np.asarray(href), atol=2e-3, rtol=1e-2)
    ych, hch = jlayers.ssd_chunked(*(jnp.asarray(x) for x in xs), CHUNK, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ych), atol=2e-3, rtol=1e-2)
    np.testing.assert_allclose(state.numpy(), np.asarray(hch), atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("b,h,s,dh,ds", SSD_CASES)
def test_ssd_scan_returns_the_final_state_of_the_chunked_forms(b, h, s, dh, ds):
    """``ssd_scan(return_state=True)`` on CPU tensors is the plain
    ``ssd_chunked(return_state=True)``, and its state the reference's
    ``ssd_chunked`` state and the recurrence's."""
    xs = _ssd_inputs(b * 10 + s + ds, b, h, s, dh, ds)
    y, hfin = ssd_scan(*(torch.from_numpy(x) for x in xs), return_state=True)
    y_p, h_p = ssd_chunked(*(torch.from_numpy(x) for x in xs), CHUNK, return_state=True)
    assert torch.equal(y, y_p) and torch.equal(hfin, h_p)
    assert hfin.dtype == torch.float32 and tuple(hfin.shape) == (b, h, ds, dh)
    _, hch = jlayers.ssd_chunked(*(jnp.asarray(x) for x in xs), CHUNK, return_state=True)
    np.testing.assert_allclose(hfin.numpy(), np.asarray(hch), atol=1e-5, rtol=1e-5)
    _, href = ref.ssd_ref(*(jnp.asarray(x) for x in xs))
    np.testing.assert_allclose(hfin.numpy(), np.asarray(href), atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("b,h,s,dh,ds", SSD_CASES[:3])
def test_ported_ssd_chunked_matches_reference_chunked(b, h, s, dh, ds):
    xs = _ssd_inputs(s + dh, b, h, s, dh, ds)
    y, hfin = tlayers.ssd_chunked(*(torch.from_numpy(x) for x in xs), CHUNK, return_state=True)
    ych, hch = jlayers.ssd_chunked(*(jnp.asarray(x) for x in xs), CHUNK, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ych), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hfin.numpy(), np.asarray(hch), atol=1e-5, rtol=1e-5)


def test_ssd_plain_takes_head_broadcast_b_and_c():
    """mamba_block hands B and C over as ``[B, S, ds]`` expanded to every head."""
    u, ld, bm, cm = _ssd_inputs(3, 2, 3, 256, 16, 16)
    b1 = torch.from_numpy(bm[:, 0])[:, None].expand(2, 3, 256, 16)
    c1 = torch.from_numpy(cm[:, 0])[:, None].expand(2, 3, 256, 16)
    got = ssd_scan(torch.from_numpy(u), torch.from_numpy(ld), b1, c1)
    want = ssd_chunked(torch.from_numpy(u), torch.from_numpy(ld), b1.contiguous(),
                       c1.contiguous(), CHUNK)
    assert torch.equal(got, want)


def _chunks_alone(u, ld, bm, cm):
    """The SSD with the state reset at every chunk boundary: each chunk run
    as a sequence of its own."""
    b, h, s, dh = u.shape
    nc = s // CHUNK

    def split(t):
        return t.reshape(b, h * nc, CHUNK, *t.shape[3:])

    y = ssd_chunked(split(u), split(ld), split(bm), split(cm), CHUNK)
    return y.reshape(b, h, s, dh)


@pytest.mark.parametrize("b,h,s,dh,ds", [(1, 2, 512, 16, 16), (2, 2, 384, 64, 64)])
def test_ssd_plain_carries_state_across_chunks_under_slow_decay(b, h, s, dh, ds):
    """Log-decays of about −1e-3 a step, as trained Mamba2 heads have: a
    chunk keeps ~90% of the state it is handed, so the carried term is most
    of the output.  The check would catch a scan that dropped or mis-decayed
    the carry: the answer without it lies far outside the tolerance."""
    u, _, bm, cm = _ssd_inputs(s + ds, b, h, s, dh, ds)
    ld = -np.abs(np.random.default_rng(s).standard_normal((b, h, s)) * 1e-3).astype(np.float32)
    xs = (u, ld, bm, cm)
    yref, href = ref.ssd_ref(*(jnp.asarray(x) for x in xs))
    y, state = ssd_chunked(*(torch.from_numpy(x) for x in xs), CHUNK, return_state=True)
    assert torch.equal(ssd_scan(*(torch.from_numpy(x) for x in xs)), y)
    np.testing.assert_allclose(y.numpy(), np.asarray(yref), atol=2e-3, rtol=1e-2)
    np.testing.assert_allclose(state.numpy(), np.asarray(href), atol=2e-3, rtol=1e-2)
    alone = _chunks_alone(*(torch.from_numpy(x) for x in xs))
    assert float((alone - y).abs().max()) > 50 * 2e-3


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("kv_chunk", [1024, 8])
def test_ported_xla_flash_attention_matches_reference(window, kv_chunk):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)  # [B, S, H, hd]
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    kpos = np.where(np.arange(20) <= 15, np.arange(20), -(10**9))[None].repeat(2, 0)
    qpos = np.full((2, 12), 15)
    for extra in ({}, {"k_positions": kpos, "q_positions": qpos}):
        mine = tlayers.xla_flash_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=True, window=window,
            kv_chunk=kv_chunk, **{n: torch.from_numpy(x) for n, x in extra.items()})
        want = jlayers.xla_flash_attention(
            *(jnp.asarray(x) for x in (q, k, v)), causal=True, window=window,
            kv_chunk=kv_chunk, **{n: jnp.asarray(x) for n, x in extra.items()})
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_lm_kernel_wrappers_on_cpu_launch_nothing_and_refuse_other_devices():
    before = dict(_lib.LAUNCHES)
    q, k, v = (torch.from_numpy(x) for x in _attn_inputs(0, 1, 2, 1, 16, 16, 8))
    flash_attention(q, k, v)
    u, ld, bm, cm = (torch.from_numpy(x) for x in _ssd_inputs(0, 1, 1, 128, 8, 8))
    ssd_scan(u, ld, bm, cm)
    assert _lib.LAUNCHES == before
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to(meta), k.to(meta), v.to(meta))
    with pytest.raises(ValueError, match="no kernel"):
        ssd_scan(u.to(meta), ld.to(meta), bm.to(meta), cm.to(meta))


@pytest.mark.parametrize("call", [
    lambda: flash_attention(torch.zeros(1, 3, 4, 8), torch.zeros(1, 2, 4, 8),
                            torch.zeros(1, 2, 4, 8)),  # Hq not a multiple of Hkv
    lambda: flash_attention(torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 5, 8),
                            torch.zeros(1, 2, 4, 8)),  # k and v disagree
    lambda: ssd_scan(torch.zeros(1, 1, 100, 8), torch.zeros(1, 1, 100),
                     torch.zeros(1, 1, 100, 8), torch.zeros(1, 1, 100, 8)),  # S % 128
    lambda: ssd_scan(torch.zeros(1, 1, 128, 8), torch.zeros(1, 2, 128),
                     torch.zeros(1, 1, 128, 8), torch.zeros(1, 1, 128, 8)),  # ldecay shape
], ids=["gqa_ratio", "kv_shapes", "chunk_multiple", "ldecay_shape"])
def test_lm_kernel_wrappers_reject_shapes_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_ssd_plain_stays_finite_where_the_reference_chunked_form_overflows():
    """A chunk whose log-decays sum below −88 (here −1 a step, as a long run
    of identical pad tokens with a large dt gives): the reference's
    ``ssd_chunked`` takes ``exp`` of the full square, ``inf·0`` turns into
    NaN; the port masks the upper triangle first and keeps the sequential
    recurrence's values."""
    u, _, bm, cm = _ssd_inputs(5, 1, 2, 256, 16, 16)
    ld = np.full((1, 2, 256), -1.0, np.float32)
    xs = (u, ld, bm, cm)
    yref, href = ref.ssd_ref(*(jnp.asarray(x) for x in xs))
    assert np.isnan(np.asarray(jlayers.ssd_chunked(*(jnp.asarray(x) for x in xs), CHUNK))).any()
    y, h = tlayers.ssd_chunked(*(torch.from_numpy(x) for x in xs), CHUNK, return_state=True)
    assert torch.equal(ssd_scan(*(torch.from_numpy(x) for x in xs)), y)
    np.testing.assert_allclose(y.numpy(), np.asarray(yref), atol=2e-3, rtol=1e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(href), atol=2e-3, rtol=1e-2)
