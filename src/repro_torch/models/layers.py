"""Model layers: norms, RoPE, GQA attention, SwiGLU/GELU MLP, the einsum MoE
and Mamba2 (chunked SSD), as functions over parameter modules.

Counterpart of ``repro/models/layers.py``, with the reference's layouts
(``[B, S, H, hd]`` inside attention, ``[B, H, S, ·]`` inside the SSD) and
parameter names, so the tests compare like with like.  ``MeshRules`` /
``cs`` are the reference's sharding constraints: on one device they are
no-ops and are left out here (the multi-GPU slice brings them).

``impl`` selects the kernels, as the reference's ``impl`` does:

* ``"kernel"`` (the default; the reference's ``"pallas"``) calls the kernel
  wrappers ``kernels.ops.flash_attention`` (#8) and ``kernels.ops.ssd_scan``
  (#9): their hand-written CUDA kernels on CUDA tensors, their plain
  versions on CPU tensors;
* ``"plain"`` (the reference's ``"xla"``) runs :func:`xla_flash_attention`
  and :func:`ssd_chunked`, the reference's pure-tensor forms, on any device.
  On the card it has three users: the tests and ``chip_smoke.py``, to
  compare, and the train step (``launch/steps.py``), which differentiates
  it with autograd.  The reference trains on its ``"xla"`` path too, outside
  any Pallas kernel, since its kernels define no VJP; so training bypasses
  no kernel of the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunk import ssd_chunked

IMPLS = ("kernel", "plain")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


# ----------------------------------------------------------------------------
# Norms / activations / RoPE
# ----------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def apply_norm(x: torch.Tensor, p, kind: str) -> torch.Tensor:
    return rms_norm(x, p.w) if kind == "rms" else layer_norm(x, p.w, p.b)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------------


def xla_flash_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, T, Kv, hd]
    v: torch.Tensor,  # [B, T, Kv, hd]
    causal: bool,
    window: int | None = None,
    kv_chunk: int = 1024,
    k_positions: torch.Tensor | None = None,  # [B, T] absolute pos (decode)
    q_positions: torch.Tensor | None = None,  # [B, S]
) -> torch.Tensor:
    """Online-softmax attention over KV chunks; never materializes [S, T].
    The reference's pure-tensor attention, on any device."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / (hd**0.5)
    dev = q.device
    if q_positions is None:
        q_positions = (torch.arange(s, device=dev) + (t - s)).expand(b, s)
    if k_positions is None:
        k_positions = torch.arange(t, device=dev).expand(b, t)
    qg = q.reshape(b, s, kv, g, hd)
    nchunks = -(-t // kv_chunk)
    pad = nchunks * kv_chunk - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = F.pad(k_positions, (0, pad), value=-(10**9))
    m = torch.full((b, s, kv, g), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s, kv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, kv, g, hd), dtype=torch.float32, device=dev)
    for c in range(nchunks):
        kb = k[:, c * kv_chunk:(c + 1) * kv_chunk]
        vb = v[:, c * kv_chunk:(c + 1) * kv_chunk]
        pb = k_positions[:, c * kv_chunk:(c + 1) * kv_chunk]
        logits = torch.einsum("bskgd,bckd->bskgc", qg, kb).to(torch.float32) * scale
        mask = pb[:, None, :] >= 0  # kv padding / unwritten cache slots
        if causal:
            mask = mask & (q_positions[:, :, None] >= pb[:, None, :])
        if window is not None:
            mask = mask & ((q_positions[:, :, None] - pb[:, None, :]) < window)
        logits = torch.where(mask[:, :, None, None, :], logits, -1e30)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        upd = torch.einsum("bskgc,bckd->bskgd", p.to(vb.dtype), vb).to(torch.float32)
        acc = acc * corr[..., None] + upd
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, s, h, hd).to(q.dtype)


def attention(
    x: torch.Tensor,  # [B, S, D]
    p,
    cfg,
    *,
    causal: bool,
    window: int | None,
    kv: tuple[torch.Tensor, torch.Tensor] | None = None,  # external KV (cross-attn)
    positions: torch.Tensor | None = None,
    impl: str = "kernel",
    return_kv: bool = False,
):
    """Self- (or, with ``kv``, cross-) attention.  ``return_kv`` also returns
    the projected, roped ``(k, v)`` ``[B, S, Kv, hd]`` that the prefill
    writes into its cache (the reference projects them a second time)."""
    check_impl(impl)
    b, s, d = x.shape
    q = torch.einsum("bsd,dhq->bshq", x, p.wq)
    if cfg.qkv_bias:
        q = q + p.bq
    if kv is None:
        k = torch.einsum("bsd,dhq->bshq", x, p.wk)
        v = torch.einsum("bsd,dhq->bshq", x, p.wv)
        if cfg.qkv_bias:
            k, v = k + p.bk, v + p.bv
        pos = positions if positions is not None else torch.arange(s, device=x.device).expand(b, s)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    else:
        k, v = kv  # already projected+roped (encoder memory)
    if impl == "kernel":
        o = ops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal, window=window,
        ).transpose(1, 2)
    else:
        o = xla_flash_attention(q, k, v, causal=causal, window=window)
    out = torch.einsum("bshq,hqd->bsd", o, p.wo)
    return (out, (k, v)) if return_kv else out


# ----------------------------------------------------------------------------
# MLP / MoE
# ----------------------------------------------------------------------------


def mlp(x: torch.Tensor, p, act: str) -> torch.Tensor:
    if hasattr(p, "w_gate"):  # SwiGLU
        gate = activation(torch.einsum("bsd,df->bsf", x, p.w_gate), act)
        up = torch.einsum("bsd,df->bsf", x, p.w_up)
        hidden = gate * up
    else:  # plain 2-matrix MLP (GELU archs)
        hidden = activation(torch.einsum("bsd,df->bsf", x, p.w_in), act)
    return torch.einsum("bsf,fd->bsd", hidden, p.w_down)


def router_probs(x: torch.Tensor, p) -> torch.Tensor:
    """The MoE router's softmax ``[B, S, E]`` in f32 (``p.router`` is f32
    whatever the model's dtype; the reference's einsum promotes ``x``)."""
    logits = torch.einsum("bsd,de->bse", x.to(p.router.dtype), p.router).to(torch.float32)
    return torch.softmax(logits, dim=-1)


def router_top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest probabilities, largest
    first, a tie in the lower expert index first (``jax.lax.top_k``'s order):
    a stable descending sort, whose tie order is defined, where
    ``torch.topk``'s is not."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(x: torch.Tensor, p, cfg) -> torch.Tensor:
    """Capacity-bounded einsum MoE in ``top_k`` top-1 rounds (the reference's
    ``layers.moe``).  Groups are sequences: a round's capacity is ``C1 =
    max(int(S / E · cf), 4)`` tokens an expert in each row, taken in order
    along S by an integer cumsum (padding tokens take capacity in their row,
    as in the reference), so a drop is exact.  The dispatch one-hot is
    ``[B, S, E, C1]``; the combine adds in f32 and casts once at the end."""
    mc = cfg.moe
    b, s, d = x.shape
    e, k_rounds = mc.num_experts, mc.top_k
    c1 = max(int(s / e * mc.capacity_factor), 4)
    topv, topi = router_top_k(router_probs(x, p), k_rounds)  # [B, S, K]
    topv = topv / torch.clamp(torch.sum(topv, dim=-1, keepdim=True), min=1e-9)
    slots = torch.arange(c1, device=x.device)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for r in range(k_rounds):
        onehot_i = F.one_hot(topi[..., r], e)  # [B, S, E] int64
        pos = torch.cumsum(onehot_i, dim=1) - onehot_i  # position in expert, an integer
        keep = ((pos < c1) & (onehot_i > 0)).to(x.dtype)
        # dispatch one-hot [B, S, E, C1]; a position past C1 has no slot, as
        # jax.nn.one_hot gives zeros where F.one_hot would raise
        disp = keep[..., None] * (pos[..., None] == slots).to(x.dtype)
        xe = torch.einsum("bsec,bsd->becd", disp, x)  # [B, E, C1, D]
        hg = activation(torch.einsum("becd,edf->becf", xe, p.w_gate), cfg.act)
        hu = torch.einsum("becd,edf->becf", xe, p.w_up)
        ye = torch.einsum("becf,efd->becd", hg * hu, p.w_down)
        w = topv[..., r][..., None] * keep  # [B, S, E] f32
        out = out + torch.einsum("bsec,becd->bsd", w[..., None] * disp, ye.to(torch.float32))
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Mamba2 (chunked SSD)
# ----------------------------------------------------------------------------


def mamba_inputs(x: torch.Tensor, p, cfg):
    """The Mamba2 input projections and causal conv: ``(z, xin, xc, bmat,
    cmat, dt)``."""
    s = x.shape[1]
    z = torch.einsum("bsd,de->bse", x, p.w_z)
    xin = torch.einsum("bsd,de->bse", x, p.w_x)
    bmat = torch.einsum("bsd,dn->bsn", x, p.w_B)  # [B,S,ds]
    cmat = torch.einsum("bsd,dn->bsn", x, p.w_C)
    dt = F.softplus(torch.einsum("bsd,dh->bsh", x, p.w_dt) + p.dt_bias)  # [B,S,nh]
    cw = cfg.ssm.conv_width
    xp = F.pad(xin, (0, 0, cw - 1, 0))  # causal depthwise conv on xin (width cw)
    xc = F.silu(sum(xp[:, i:i + s, :] * p.conv_w[i] for i in range(cw)))
    return z, xin, xc, bmat, cmat, dt


def ssd_operands(xc, bmat, cmat, dt, p, cfg):
    """``(u [B, nh, S', hd], ld [B, nh, S'], B, C [B, nh, S', ds])`` padded
    to S' = a multiple of the chunk; B and C are the ``[B, S', ds]``
    projections expanded to every head (a view, head stride 0)."""
    sc = cfg.ssm
    b, s, _ = xc.shape
    nh, hd = cfg.n_ssm_heads, sc.head_dim
    u = xc.reshape(b, s, nh, hd)
    a = -torch.exp(p.a_log)  # [nh], negative decay rates
    ld = (dt * a).transpose(1, 2)  # [B, nh, S]
    uh = (u * dt[..., None]).movedim(2, 1)  # [B, nh, S, hd] dt-scaled
    pad = (-s) % sc.chunk
    if pad:
        uh = F.pad(uh, (0, 0, 0, pad))
        ld = F.pad(ld, (0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    sp = s + pad
    bh = bmat[:, None].expand(b, nh, sp, sc.d_state)
    ch = cmat[:, None].expand(b, nh, sp, sc.d_state)
    return uh.contiguous(), ld.contiguous(), bh, ch


def mamba_block(x: torch.Tensor, p, cfg, impl: str = "kernel", return_state: bool = False):
    """The Mamba2 sublayer's output ``[B, S, d_model]``.  ``return_state``:
    ``(out, {"conv": the last cw − 1 inputs of the conv, "ssd": the SSD
    state after the last step [B, nh, ds, hd] f32})``, the decode cache
    that ``prefill`` keeps, from the same projections and the same SSD call
    (#9 under ``impl="kernel"``, ``ssd_chunked`` under ``"plain"``)."""
    check_impl(impl)
    b, s, _ = x.shape
    z, xin, xc, bmat, cmat, dt = mamba_inputs(x, p, cfg)
    uh, ld, bh, ch = ssd_operands(xc, bmat.contiguous(), cmat.contiguous(), dt, p, cfg)
    if impl == "kernel":
        res = ops.ssd_scan(uh, ld, bh, ch, return_state=return_state)
    else:
        res = ssd_chunked(uh, ld, bh, ch, cfg.ssm.chunk, return_state=return_state)
    y, hfin = res if return_state else (res, None)
    y = y[:, :, :s].movedim(1, 2).reshape(b, s, cfg.d_inner)
    if hasattr(p, "d_skip"):
        y = y + xc * p.d_skip.reshape(1, 1, -1)
    out = torch.einsum("bse,ed->bsd", y * F.silu(z), p.w_out)
    if not return_state:
        return out
    cw = cfg.ssm.conv_width
    # a copy, not a view: a view would keep the whole [B, S, d_inner] xin of
    # every Mamba layer alive for as long as the cache lives
    return out, {"conv": xin[:, s - (cw - 1):, :].clone(), "ssd": hfin}
