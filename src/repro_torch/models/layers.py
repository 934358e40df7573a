"""Model layers: norms, RoPE, GQA attention, SwiGLU/GELU MLP, the einsum MoE
and Mamba2 (chunked SSD), as functions over parameter modules.

Counterpart of ``repro/models/layers.py``, with the reference's layouts
(``[B, S, H, hd]`` inside attention, ``[B, H, S, ·]`` inside the SSD) and
parameter names, so the tests compare like with like.

``rules`` (a :class:`MeshRules`, or ``None`` on one device, where every
path is what it was without it) threads the mesh through the model, at the
reference's points.  Activations between blocks are DTensors, and
:func:`cs`, :meth:`MeshRules.hidden` and :meth:`MeshRules.heads` are
``redistribute`` calls, the counterpart of ``with_sharding_constraint``.
Inside a block each rank computes on local tensors, in the layout the
reference's constraints ask for: the block's input all-gathered over the
tensor axis (Megatron-SP), its weights all-gathered over the data axes
(FSDP), heads / the FFN dim / the experts split over ``model`` where they
divide, the batch over the data axes where it divides; the block's output
leaves as a partial sum over ``model`` that :meth:`MeshRules.hidden`
reduce-scatters.  So kernels #8 and #9 launch on each rank's own batch rows
and heads (a kernel wrapper refuses a DTensor), and the MoE's routing, its
tie order and its capacity drops run per sequence as in the reference.
Where the KV heads do not divide ``model`` but the query heads do, each
rank's KV heads are expanded to its query heads (``repeat_interleave``,
exact); where the query heads do not divide either, the heads stay whole
on every rank.

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

import dataclasses
import math
import types
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import axis_names, mesh_sizes, to_placements
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunk import ssd_chunked

IMPLS = ("kernel", "plain")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


# ----------------------------------------------------------------------------
# Sharding rules threaded through the model (None = one device / no mesh)
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Any  # a DeviceMesh
    dp: tuple[str, ...]  # batch / FSDP axes, e.g. ("pod", "data")
    tp: str | None  # tensor axis ("model"); None = pure-FSDP layout (ZeRO-3)

    def cs(self, x, *spec):
        """``x`` (a DTensor) redistributed to ``spec``."""
        return x.redistribute(self.mesh, to_placements(spec, self.mesh))

    def hidden(self, x):
        """[B, S, D]: batch over dp, sequence over tp (Megatron-SP residuals).
        Pure-FSDP layout: batch over everything, no sequence sharding."""
        if self.tp is None:
            return self.cs(x, self.dp, None, None)
        return self.cs(x, self.dp, self.tp, None)

    def heads(self, x):
        """[B, S, H, hd]: heads over tp (attention-interior layout)."""
        if self.tp is None:
            return self.cs(x, self.dp, None, None, None)
        return self.cs(x, self.dp, None, self.tp, None)

    # -- local compute ------------------------------------------------------

    def size(self, axes) -> int:
        sizes = mesh_sizes(self.mesh)
        axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
        return math.prod(sizes[a] for a in axes)

    def batch_axes(self, b: int):
        """The dp axes when they divide a batch of ``b`` rows, else ``None``
        (the rows stay whole on every rank)."""
        return self.dp if self.dp and b % self.size(self.dp) == 0 else None

    def split_axis(self, n: int):
        """The tensor axis when it divides ``n``, else ``None``."""
        return self.tp if self.tp is not None and n % self.size(self.tp) == 0 else None

    def coord(self, axis: str) -> int:
        """This rank's coordinate along mesh axis ``axis``."""
        return self.mesh.get_local_rank(axis_names(self.mesh).index(axis))

    def split(self, *entries) -> tuple[str, ...]:
        """The mesh axes a block's compute is split over (each entry an axis,
        a tuple of axes or ``None``)."""
        out = []
        for e in entries:
            out.extend(() if e is None else (e,) if isinstance(e, str) else e)
        return tuple(out)

    def local(self, x, spec, split=()) -> torch.Tensor:
        """This rank's local tensor of ``x`` (a DTensor) redistributed to
        ``spec``.  In backward its gradient is a partial sum over the mesh
        axes of ``split`` that ``spec`` replicates: the rank's compute used
        the whole of ``x`` for its share of the work."""
        from torch.distributed.tensor import Partial, Replicate

        pl = to_placements(spec, self.mesh)
        names = axis_names(self.mesh)
        grad = [Partial() if isinstance(p, Replicate) and names[i] in split else p
                for i, p in enumerate(pl)]
        return x.redistribute(self.mesh, pl).to_local(grad_placements=grad)

    def local_params(self, p, specs: dict, split=()) -> types.SimpleNamespace:
        """The local tensors of the parameters of module ``p`` named in
        ``specs``, each redistributed to its spec (those ``p`` lacks are
        left out)."""
        return types.SimpleNamespace(**{n: self.local(getattr(p, n), spec, split)
                                        for n, spec in specs.items() if hasattr(p, n)})

    def wrap(self, t: torch.Tensor, shape, spec, partial=None):
        """A DTensor of global ``shape`` from this rank's local ``t`` laid out
        by ``spec``, a partial sum over mesh axis ``partial`` if given."""
        from torch.distributed.tensor import DTensor, Partial

        pl = to_placements(spec, self.mesh)
        if partial is not None:
            pl[axis_names(self.mesh).index(partial)] = Partial()
        shape = torch.Size(shape)
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(t, self.mesh, pl, run_check=False, shape=shape, stride=stride)

    def rows(self, t: torch.Tensor, spec):
        """This rank's local rows of ``t``, a whole tensor that every rank
        holds (a batch of tokens), under ``spec``; a DTensor's own local
        tensor when ``t`` is one already."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if not isinstance(t, DTensor):
            t = distribute_tensor(t, self.mesh, to_placements(spec, self.mesh),
                                  src_data_rank=None)
            return t.to_local()
        return self.local(t, spec)


def cs(rules: MeshRules | None, x, kind: str):
    if rules is None:
        return x
    return rules.hidden(x) if kind == "hidden" else rules.heads(x)


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
    rules: MeshRules | None = None,
):
    """Self- (or, with ``kv``, cross-) attention.  ``return_kv`` also returns
    the projected, roped ``(k, v)`` ``[B, S, Kv, hd]`` that the prefill
    writes into its cache (the reference projects them a second time)."""
    check_impl(impl)
    if rules is not None:
        return _attention_sharded(x, p, cfg, causal, window, kv, positions, impl, return_kv,
                                  rules)
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
    o = attend(q, k, v, causal, window, impl)
    out = torch.einsum("bshq,hqd->bsd", o, p.wo)
    return (out, (k, v)) if return_kv else out


def attend(q, k, v, causal: bool, window: int | None, impl: str) -> torch.Tensor:
    """``[B, S, H, hd]`` attention of local tensors: #8 under
    ``impl="kernel"``, :func:`xla_flash_attention` under ``"plain"``."""
    if impl == "kernel":
        return ops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal, window=window,
        ).transpose(1, 2)
    return xla_flash_attention(q, k, v, causal=causal, window=window)


def head_layout(rules: MeshRules, b: int, h: int, kv: int):
    """``(batch axes, query-head axis, kv-head axis)`` of a block's
    attention over ``b`` rows, ``h`` query and ``kv`` kv heads: the kv heads
    are split with the query heads only where both divide the tensor axis."""
    tph = rules.split_axis(h)
    tpk = tph if tph is not None and kv % rules.size(tph) == 0 else None
    return rules.batch_axes(b), tph, tpk


def rank_kv_heads(rules: MeshRules, k: torch.Tensor, h: int, tph) -> torch.Tensor:
    """All ``Kv`` heads of ``k [B, T, Kv, hd]`` expanded to this rank's
    ``H / |tp|`` query heads (query head ``i`` reads kv head ``i // g``)."""
    hl = h // rules.size(tph)
    r = rules.coord(tph)
    return k.repeat_interleave(h // k.shape[2], dim=2)[:, :, r * hl:(r + 1) * hl]


def _attention_sharded(x, p, cfg, causal, window, kv, positions, impl, return_kv,
                       rules: MeshRules):
    """:func:`attention` under ``rules``: the block's input gathered over tp,
    its weights over dp, each rank projecting its batch rows and heads;
    the output a partial sum over tp, reduce-scattered to ``hidden``."""
    b, s, _ = x.shape
    bdp, tph, tpk = head_layout(rules, b, cfg.num_heads, cfg.num_kv_heads)
    split = rules.split(bdp, tph)
    xl = rules.local(x, (bdp, None, None), split)
    q = torch.einsum("bsd,dhq->bshq", xl, rules.local(p.wq, (None, tph, None), split))
    if cfg.qkv_bias:
        q = q + rules.local(p.bq, (tph, None), split)
    if kv is None:
        k = torch.einsum("bsd,dhq->bshq", xl, rules.local(p.wk, (None, tpk, None), split))
        v = torch.einsum("bsd,dhq->bshq", xl, rules.local(p.wv, (None, tpk, None), split))
        if cfg.qkv_bias:
            k = k + rules.local(p.bk, (tpk, None), split)
            v = v + rules.local(p.bv, (tpk, None), split)
        # every caller's positions are the same row in each batch row
        pos = (positions[:1] if positions is not None
               else torch.arange(s, device=xl.device)[None]).expand(xl.shape[0], s)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    else:
        k, v = (rules.local(t, (bdp, None, tpk, None), split) for t in kv)
    kk, vv = k, v
    if tph is not None and tpk is None:
        kk, vv = (rank_kv_heads(rules, t, cfg.num_heads, tph) for t in (k, v))
    o = attend(q, kk, vv, causal, window, impl)
    out = torch.einsum("bshq,hqd->bsd", o, rules.local(p.wo, (tph, None, None), split))
    out = rules.hidden(rules.wrap(out, x.shape, (bdp, None, None), partial=tph))
    if not return_kv:
        return out
    kv_shape = (b, k.shape[1], cfg.num_kv_heads, cfg.head_dim)
    return out, tuple(rules.wrap(t, kv_shape, (bdp, None, tpk, None)) for t in (k, v))


# ----------------------------------------------------------------------------
# MLP / MoE
# ----------------------------------------------------------------------------


def mlp(x: torch.Tensor, p, act: str, rules: MeshRules | None = None) -> torch.Tensor:
    if rules is not None:
        b = x.shape[0]
        bdp, tpf = rules.batch_axes(b), rules.split_axis(p.w_down.shape[0])
        split = rules.split(bdp, tpf)
        lp = rules.local_params(p, {"w_gate": (None, tpf), "w_up": (None, tpf),
                                    "w_in": (None, tpf), "w_down": (tpf, None)}, split)
        out = mlp(rules.local(x, (bdp, None, None), split), lp, act)
        return rules.hidden(rules.wrap(out, x.shape, (bdp, None, None), partial=tpf))
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


def moe(x: torch.Tensor, p, cfg, rules: MeshRules | None = None) -> torch.Tensor:
    """Capacity-bounded einsum MoE in ``top_k`` top-1 rounds (the reference's
    ``layers.moe``).  Groups are sequences: a round's capacity is ``C1 =
    max(int(S / E · cf), 4)`` tokens an expert in each row, taken in order
    along S by an integer cumsum (padding tokens take capacity in their row,
    as in the reference), so a drop is exact.  The dispatch one-hot is
    ``[B, S, E, C1]``; the combine adds in f32 and casts once at the end.

    Under ``rules`` each rank routes its own sequences whole (the router,
    the tie order, the cumsum along S and the drops are the reference's, row
    by row) and runs the experts it holds: experts over ``model`` (EP)
    where they divide it, else the expert FFN dim over ``model``; the
    combine is a partial sum over ``model``."""
    if rules is not None:
        return _moe_sharded(x, p, cfg, rules)
    return moe_local(x, p, cfg).to(x.dtype)


def _moe_sharded(x, p, cfg, rules: MeshRules):
    b = x.shape[0]
    mc = cfg.moe
    bdp = rules.batch_axes(b)
    tpe = rules.split_axis(mc.num_experts)
    tpf = None if tpe is not None else rules.split_axis(mc.moe_dff)
    split = rules.split(bdp, tpe, tpf)
    lp = rules.local_params(p, {"router": (None, None), "w_gate": (tpe, None, tpf),
                                "w_up": (tpe, None, tpf), "w_down": (tpe, tpf, None)}, split)
    e0 = rules.coord(tpe) * lp.w_gate.shape[0] if tpe is not None else 0
    out = moe_local(rules.local(x, (bdp, None, None), split), lp, cfg, e0)
    out = rules.hidden(rules.wrap(out, x.shape, (bdp, None, None), partial=tpe or tpf))
    return out.to(x.dtype)


def moe_local(x: torch.Tensor, p, cfg, e0: int = 0) -> torch.Tensor:
    """The f32 MoE output of local tensors, through the experts
    ``[e0, e0 + E_local)`` that ``p``'s expert weights hold (all of them on
    one device)."""
    mc = cfg.moe
    b, s, d = x.shape
    e, k_rounds = mc.num_experts, mc.top_k
    el = p.w_gate.shape[0]
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
        w = topv[..., r][..., None] * keep  # [B, S, E] f32
        if el != e:  # this rank's experts
            disp, w = disp[:, :, e0:e0 + el], w[:, :, e0:e0 + el]
        xe = torch.einsum("bsec,bsd->becd", disp, x)  # [B, E, C1, D]
        hg = activation(torch.einsum("becd,edf->becf", xe, p.w_gate), cfg.act)
        hu = torch.einsum("becd,edf->becf", xe, p.w_up)
        ye = torch.einsum("becf,efd->becd", hg * hu, p.w_down)
        out = out + torch.einsum("bsec,becd->bsd", w[..., None] * disp, ye.to(torch.float32))
    return out


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
    nh, hd = dt.shape[-1], sc.head_dim
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


# each Mamba parameter's local layout; "h" marks the dim split with the SSM heads
MAMBA_SPECS = {
    "w_z": (None, "h"), "w_x": (None, "h"), "w_B": (None, None), "w_C": (None, None),
    "w_dt": (None, "h"), "dt_bias": ("h",), "conv_w": (None, "h"), "a_log": ("h",),
    "d_skip": ("h",), "w_out": ("h", None),
}


def mamba_local_params(p, rules: MeshRules, tpd, split):
    """This rank's Mamba parameters: every tensor of the inner width or of
    the SSM heads taken on the rank's heads (``tpd``), the rest whole."""
    specs = {n: tuple(tpd if e == "h" else e for e in spec) for n, spec in MAMBA_SPECS.items()}
    return rules.local_params(p, specs, split)


def mamba_block(x: torch.Tensor, p, cfg, impl: str = "kernel", return_state: bool = False,
                rules: MeshRules | None = None):
    """The Mamba2 sublayer's output ``[B, S, d_model]``.  ``return_state``:
    ``(out, {"conv": the last cw − 1 inputs of the conv, "ssd": the SSD
    state after the last step [B, nh, ds, hd] f32})``, the decode cache
    that ``prefill`` keeps, from the same projections and the same SSD call
    (#9 under ``impl="kernel"``, ``ssd_chunked`` under ``"plain"``).

    Under ``rules`` each rank runs this on its batch rows and its SSM heads
    (the inner width split with them), so #9 scans the rank's heads only."""
    check_impl(impl)
    if rules is not None:
        return _mamba_sharded(x, p, cfg, impl, return_state, rules)
    b, s, _ = x.shape
    z, xin, xc, bmat, cmat, dt = mamba_inputs(x, p, cfg)
    uh, ld, bh, ch = ssd_operands(xc, bmat.contiguous(), cmat.contiguous(), dt, p, cfg)
    if impl == "kernel":
        res = ops.ssd_scan(uh, ld, bh, ch, return_state=return_state)
    else:
        res = ssd_chunked(uh, ld, bh, ch, cfg.ssm.chunk, return_state=return_state)
    y, hfin = res if return_state else (res, None)
    y = y[:, :, :s].movedim(1, 2).reshape(b, s, xc.shape[-1])
    if hasattr(p, "d_skip"):
        y = y + xc * p.d_skip.reshape(1, 1, -1)
    out = torch.einsum("bse,ed->bsd", y * F.silu(z), p.w_out)
    if not return_state:
        return out
    cw = cfg.ssm.conv_width
    # a copy, not a view: a view would keep the whole [B, S, d_inner] xin of
    # every Mamba layer alive for as long as the cache lives
    return out, {"conv": xin[:, s - (cw - 1):, :].clone(), "ssd": hfin}


def _mamba_sharded(x, p, cfg, impl, return_state, rules: MeshRules):
    b = x.shape[0]
    bdp, tpd = rules.batch_axes(b), rules.split_axis(cfg.n_ssm_heads)
    split = rules.split(bdp, tpd)
    res = mamba_block(rules.local(x, (bdp, None, None), split),
                      mamba_local_params(p, rules, tpd, split), cfg, impl, return_state)
    out, state = res if return_state else (res, None)
    out = rules.hidden(rules.wrap(out, x.shape, (bdp, None, None), partial=tpd))
    if not return_state:
        return out
    sc = cfg.ssm
    return out, {
        "conv": rules.wrap(state["conv"], (b, sc.conv_width - 1, cfg.d_inner), (bdp, None, tpd)),
        "ssd": rules.wrap(state["ssd"], (b, cfg.n_ssm_heads, sc.d_state, sc.head_dim),
                          (bdp, tpd, None, None)),
    }
