"""The 3xTF32 arithmetic of flash attention (#8) and the SSD scan (#9) on the
card, pinned on the CPU.

``csrc/flash_attention.cu`` computes every f32 product on the tensor cores
as three TF32 products: each operand x is split as ``hi = tf32(x)`` and
``lo = tf32(x − hi)`` (round to nearest on 10 mantissa bits, ties away from
zero, as ``cvt.rna.tf32.f32``), and each 8-deep step of a product adds
``a_lo·b_hi``, then ``a_hi·b_lo``, then ``a_hi·b_hi`` to f32 accumulators.
The kernel itself runs only on the card; this file models its arithmetic in
numpy (its 64-query and 32-key tiles, the tile skip, the online softmax
in base 2 with m from −1e30, the split of P before PV) and holds the model against
the JAX package's ``attention_ref`` within 1e-5 on the inputs of
``test_attention_plain_matches_reference_oracle``.  It also shows why the
split is there: one TF32 product alone misses 1e-5 at gemma3-12b's D = 240.

``csrc/ssd_chunk.cu`` (#9) runs its products the same way in three phases:
chunk states ``(w ⊙ B)ᵀ U``, the state passed across chunks, and chunk
outputs by warps of 16 rows (``C·H`` scaled by ``exp(ca)``, then the masked
scores ``C Bᵀ ⊙ L`` over the columns up to the warp's last row, times U,
into the same accumulator).  Its model here takes the kernel's one-warp scan
for ``ca`` and holds output and final state against the sequential
recurrence ``ref.ssd_ref`` within 1e-5; one TF32 product alone misses it.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref

BQ, BKV, KSTEP = 64, 32, 8  # the kernel's tiles and the mma's depth
TOL = 1e-5
ATTN_CASES = [  # tests/test_torch_lm_kernels.py's, from the reference's sweep
    (1, 2, 1, 128, 128, True, None),
    (2, 4, 4, 100, 100, True, None),  # padding
    (1, 4, 2, 128, 256, True, None),  # decode-style (q shorter, right-aligned)
    (1, 2, 1, 200, 200, True, 64),  # sliding window
    (1, 2, 2, 64, 192, False, None),  # cross-attention
]


def tf32(x: np.ndarray) -> np.ndarray:
    """f32 rounded to TF32: to nearest on 10 mantissa bits, ties away from
    zero, the 13 low bits cleared (``cvt.rna.tf32.f32`` on finite values)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray, terms: int):
    """(hi, lo) of the kernel's split; lo is 0 when only one product is taken."""
    hi = tf32(x)
    return hi, (tf32(x - hi) if terms == 3 else np.zeros_like(hi))


def product(a: np.ndarray, b: np.ndarray, terms: int, acc=None) -> np.ndarray:
    """``acc`` (default 0) + Σ_k a[..., i, k]·b[..., k, j] in f32, step by
    8-deep step, each step as the kernel's three TF32 products
    (``terms=3``) or one (``terms=1``)."""
    ah, al = split(a, terms)
    bh, bl = split(b, terms)
    if acc is None:
        acc = np.zeros((*a.shape[:-1], b.shape[-1]), np.float32)
    for k0 in range(0, a.shape[-1], KSTEP):
        ks = slice(k0, k0 + KSTEP)
        if terms == 3:
            acc = acc + al[..., ks] @ bh[..., ks, :]
            acc = acc + ah[..., ks] @ bl[..., ks, :]
        acc = acc + ah[..., ks] @ bh[..., ks, :]
    return acc


def attention_tf32(q, k, v, causal=True, window=None, terms=3):
    """The kernel's attention in numpy: q [B, Hq, S, D], k and v
    [B, Hkv, T, D] f32; queries right-aligned, masked logits at −1e30, kv
    tiles no query of a q tile sees skipped, l clamped at 1e-30."""
    b, hq, s, d = q.shape
    t = k.shape[2]
    g = hq // k.shape[1]
    k, v = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    # the kernel's softmax runs in base 2: logits scaled by scale·log2(e), exp2
    scale2 = np.float32(np.float64(np.float32(1.0 / np.sqrt(d))) * 1.4426950408889634)
    dp = -(-d // KSTEP) * KSTEP  # the head dim padded with zeros, as staged
    q = np.pad(q, ((0, 0), (0, 0), (0, 0), (0, dp - d)))
    k = np.pad(k, ((0, 0), (0, 0), (0, -(-t // BKV) * BKV - t), (0, dp - d)))
    v = np.pad(v, ((0, 0), (0, 0), (0, -(-t // BKV) * BKV - t), (0, 0)))
    off = t - s
    out = np.zeros((b, hq, s, d), np.float32)
    for q0 in range(0, s, BQ):
        rows = slice(q0, min(q0 + BQ, s))
        qpos = np.arange(q0, rows.stop)[:, None] + off
        m = np.full((b, hq, rows.stop - q0, 1), -1e30, np.float32)
        l = np.zeros_like(m)
        acc = np.zeros((b, hq, rows.stop - q0, d), np.float32)
        for k0 in range(0, t, BKV):
            if causal and not q0 + BQ - 1 + off >= k0:
                continue
            if window is not None and not (q0 + off) - (k0 + BKV - 1) < window:
                continue
            kpos = np.arange(k0, k0 + BKV)[None, :]
            keep = kpos < t
            if causal:
                keep = keep & (qpos >= kpos)
            if window is not None:
                keep = keep & (qpos - kpos < window)
            logits = product(q[:, :, rows], np.swapaxes(k[:, :, k0:k0 + BKV], 2, 3), terms)
            logits = np.where(keep, logits * scale2, np.float32(-1e30))
            m_new = np.maximum(m, logits.max(axis=-1, keepdims=True))
            corr = np.exp2(m - m_new)
            p = np.exp2(logits - m_new)
            l = l * corr + p.sum(axis=-1, keepdims=True)
            m = m_new
            acc = acc * corr + product(p, v[:, :, k0:k0 + BKV], terms)
        out[:, :, rows] = acc / np.maximum(l, np.float32(1e-30))
    return out


def _inputs(seed, b, hq, hkv, s, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32))


def _oracle(q, k, v, causal, window):
    return np.asarray(ref.attention_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                        causal=causal, window=window), np.float32)


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32's spacing at 1
    x = np.array([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-12, 1 + 3 * 2.0**-12,
                  2.0**-130, 3.0e38], np.float32)
    got = tf32(x)
    assert got[0] == one + ulp and got[1] == -(one + ulp)  # ties away from zero
    assert got[2] == one and got[3] == one + ulp  # below and above the tie
    assert got[4] == x[4]  # a subnormal with few bits is kept
    assert (got.view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    hi = tf32(x[:4])
    lo = tf32(x[:4] - hi)
    np.testing.assert_array_equal(hi + lo, x[:4])  # hi + lo carries these exactly


@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("b,hq,hkv,s,t,causal,win", ATTN_CASES)
def test_3xtf32_attention_matches_reference_oracle(b, hq, hkv, s, t, causal, win, d):
    q, k, v = _inputs(s + t + d, b, hq, hkv, s, t, d)
    mine = attention_tf32(q, k, v, causal, win)
    np.testing.assert_allclose(mine, _oracle(q, k, v, causal, win), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("win", [None, 48], ids=["global", "window"])
def test_one_tf32_product_misses_what_three_meet_at_gemma3_head_dim(win):
    """gemma3-12b's D = 240 (GQA 4:2, S = T = 150): three TF32 products a
    step stay within 1e-5 of the oracle; one alone does not."""
    q, k, v = _inputs(240, 1, 4, 2, 150, 150, 240)
    want = _oracle(q, k, v, True, win)
    np.testing.assert_allclose(attention_tf32(q, k, v, True, win), want, atol=TOL, rtol=TOL)
    one = attention_tf32(q, k, v, True, win, terms=1)
    assert float(np.abs(one - want).max()) > 10 * TOL


# -- #9, the SSD scan
Q, RT, WARP_ROWS = 128, 64, 16  # its chunk, a phase-3 block's rows, a warp's
SSD_CASES = [(1, 1, 128, 32, 16), (2, 3, 256, 64, 32), (1, 2, 384, 16, 16), (1, 2, 256, 64, 128)]
SSD_TOL = 1e-5


def chunk_cumsum(ld: np.ndarray) -> np.ndarray:
    """The kernel's ``ca`` over the last axis (Q = 128): lane l of one warp
    sums steps 4l..4l+3 in order, the 32 lane totals are scanned
    Hillis-Steele (offsets 1, 2, 4, 8, 16), and the total of the lanes
    before l is added to each of lane l's running sums."""
    v = ld.reshape(*ld.shape[:-1], 32, 4)
    runs = [v[..., 0]]
    for k in range(1, 4):
        runs.append(runs[-1] + v[..., k])
    run = np.stack(runs, axis=-1)
    incl = run[..., 3]
    for off in (1, 2, 4, 8, 16):
        incl = np.concatenate([incl[..., :off], incl[..., off:] + incl[..., :-off]], axis=-1)
    excl = np.concatenate([np.zeros_like(incl[..., :1]), incl[..., :-1]], axis=-1)
    return (excl[..., None] + run).reshape(ld.shape)


def ssd_tf32(u, ld, bm, cm, terms=3):
    """The kernel's SSD in numpy: ``(y [B, H, S, dh], h_final [B, H, ds,
    dh])`` from u [B, H, S, dh], ld [B, H, S], B and C [B, H, S, ds] f32."""
    b, h, s, dh = u.shape
    nc = s // Q

    def chunk(x, c):
        return x[:, :, c * Q:(c + 1) * Q]

    # phase 1: chunk states (w ⊙ B)ᵀ U and decays, every chunk alone
    cas, states, decays = [], [], []
    for c in range(nc):
        ca = chunk_cumsum(chunk(ld, c))
        w = np.exp(ca[..., -1:] - ca)
        wb = w[..., None] * chunk(bm, c)
        states.append(product(np.swapaxes(wb, -1, -2), chunk(u, c), terms))
        decays.append(np.exp(ca[..., -1])[..., None, None])
        cas.append(ca)
    # phase 2: each chunk's incoming state
    hin = [np.zeros_like(states[0])]
    for c in range(nc):
        hin.append(decays[c] * hin[c] + states[c])
    # phase 3: per chunk and warp of 16 rows, its scores over the columns up
    # to its last row (the kernel's warps may compute more, up to their
    # tile's last row: those columns are masked to exact zeros and add
    # nothing)
    y = np.zeros_like(u)
    for c in range(nc):
        ca, cc, bc, uc = cas[c], chunk(cm, c), chunk(bm, c), chunk(u, c)
        for r0 in range(0, Q, WARP_ROWS):
            rows = slice(r0, r0 + WARP_ROWS)
            ncol = r0 + WARP_ROWS  # score columns s < the warp's last row + 1
            acc = product(cc[:, :, rows], hin[c], terms) * np.exp(ca[:, :, rows])[..., None]
            sc = product(cc[:, :, rows], np.swapaxes(bc[:, :, :ncol], -1, -2), terms)
            t = np.arange(r0, r0 + WARP_ROWS)[:, None]
            keep = np.arange(ncol)[None, :] <= t
            diff = ca[:, :, rows, None] - ca[:, :, None, :ncol]
            sc = np.where(keep, sc * np.exp(np.where(keep, diff, 0)), np.float32(0))
            y[:, :, c * Q + r0:c * Q + r0 + WARP_ROWS] = product(sc, uc[:, :, :ncol], terms, acc)
    return y, hin[nc]


def _ssd_inputs(seed, b, h, s, dh, ds, slow=False):
    """tests/test_torch_lm_kernels.py's inputs; ``slow``: log-decays of
    about −1e-3 a step, where the carried state is most of the output."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((b, h, s, dh)) * 0.1).astype(np.float32)
    ld = -np.abs(rng.standard_normal((b, h, s)) * (1e-3 if slow else 0.1)).astype(np.float32)
    bm = (rng.standard_normal((b, h, s, ds)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, h, s, ds)) * 0.3).astype(np.float32)
    return u, ld, bm, cm


def test_chunk_cumsum_model_is_an_inclusive_scan():
    ld = -np.abs(np.random.default_rng(0).standard_normal((3, Q))).astype(np.float32)
    ca = chunk_cumsum(ld)
    np.testing.assert_allclose(ca, np.cumsum(ld.astype(np.float64), axis=-1), rtol=1e-6)
    assert (ca[:, :4] == np.cumsum(ld[:, :4], axis=-1, dtype=np.float32)).all()  # lane 0 alone


@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("b,h,s,dh,ds", SSD_CASES)
def test_3xtf32_ssd_matches_reference_recurrence(b, h, s, dh, ds, decay):
    xs = _ssd_inputs(b * 100 + s + dh + ds, b, h, s, dh, ds, slow=decay == "slow")
    y, hfin = ssd_tf32(*xs)
    yref, href = (np.asarray(x) for x in ref.ssd_ref(*(jnp.asarray(x) for x in xs)))
    np.testing.assert_allclose(y, yref, atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(hfin, href, atol=SSD_TOL, rtol=SSD_TOL)


def test_one_tf32_product_misses_what_three_meet_in_the_ssd():
    """zamba2-7b's SSD head (ds = dh = 64) over three chunks with slow decay:
    three TF32 products a step stay within 1e-5 of the recurrence; one
    alone does not, in the output or in the final state."""
    xs = _ssd_inputs(7, 1, 2, 384, 64, 64, slow=True)
    yref, href = (np.asarray(x) for x in ref.ssd_ref(*(jnp.asarray(x) for x in xs)))
    y, hfin = ssd_tf32(*xs)
    np.testing.assert_allclose(y, yref, atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(hfin, href, atol=SSD_TOL, rtol=SSD_TOL)
    y1, h1 = ssd_tf32(*xs, terms=1)
    assert float(np.abs(y1 - yref).max()) > 10 * SSD_TOL
    assert float(np.abs(h1 - href).max()) > 10 * SSD_TOL
