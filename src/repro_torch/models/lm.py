"""LMs: dense (``G`` global, ``L`` sliding-window attention), MoE, Mamba2
(``M``), the zamba2 hybrid (``M`` with the shared attention block ``A``),
the VLM prefix and the whisper-style encoder-decoder.

Counterpart of ``repro/models/lm.py``.  :class:`LM` holds one module per
layer in pattern order (the reference stacks whole cycles and scans them;
eager PyTorch has no trace to keep small, so the layers are a plain
``ModuleList``).  The ``A`` sublayers are zamba2's *shared* attention block:
one ``shared_attn`` module whose weights every ``A`` occurrence uses, while
each occurrence keeps its own norms and, in decoding, its own cache.
Parameter names and layouts are the reference's, so
``repro_torch.convert.lm_params_from_reference`` carries a reference
parameter tree across one to one.

Every family of ``configs/`` builds: dense, ssm and hybrid (qwen1.5-4b,
yi-9b, gemma3-12b, h2o-danube-3-4b, mamba2-130m, zamba2-7b); MoE
(qwen3-moe-235b-a22b, grok-1-314b: a ``G``/``L`` sublayer holds ``moe`` in
place of ``mlp``); the VLM (phi-3-vision-4.2b: ``patch_embeds [B, P, D]``
from a stub frontend replace the first P token embeddings); the
encoder-decoder (whisper-tiny: ``enc_frames [B, enc_seq, D]`` from a stub
frontend through :func:`encode`, then a cross-attention between each
decoder sublayer's self-attention and its FFN).  An ``L`` layer is a ``G``
layer whose attention sees only the last ``cfg.attn_window`` positions (in
decoding, through a ring cache: ``models/decode.py``).

``impl`` is as in :mod:`repro_torch.models.layers`: ``"kernel"`` (the
default) runs attention (the encoder's and the cross-attention too,
without a causal mask) and the SSD through the hand-written kernels on the
card, ``"plain"`` through the reference's pure-tensor forms.

``rules`` (a :class:`~repro_torch.models.layers.MeshRules`) runs the model
over a ``DeviceMesh`` whose parameters are DTensors
(``distributed.sharding.distribute_params``): tokens are the whole batch on
every rank, each rank embeds its batch rows against its vocabulary rows (a
masked lookup, the rows summed over ``model``), the residual stream is a
DTensor in the ``hidden`` layout, and the logits come out as a DTensor
``[B, S, vocab]`` with the batch over the data axes.  ``rules=None`` is the
one-device path, unchanged.

:func:`loss_fn` is the training loss.  ``remat`` rematerialises at the
reference's granularity: one ``torch.utils.checkpoint`` per whole pattern
cycle (the reference's scanned cycle body; a trailing partial cycle is not
rematerialised) and one per encoder layer; ``remat="dots"`` keeps the
outputs of the products without batch dimensions and recomputes the rest
(the reference's ``dots_with_no_batch_dims_saveable`` policy).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig, _full_pattern
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a layer pattern the port has no
    sublayer for (``G``, ``L``, ``A`` and ``M`` are carried)."""
    bad = set(cfg.layer_pattern) - set("GLAM")
    if bad:
        raise NotImplementedError(f"{cfg.name}: layer pattern chars {sorted(bad)}")


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class Norm(nn.Module):
    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        self.w = _param((cfg.d_model,), device, dtype)
        if cfg.norm == "ln":
            self.b = _param((cfg.d_model,), device, dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = _param((d, h, hd), device, dtype)
        self.wk = _param((d, kv, hd), device, dtype)
        self.wv = _param((d, kv, hd), device, dtype)
        self.wo = _param((h, hd, d), device, dtype)
        if cfg.qkv_bias:
            self.bq = _param((h, hd), device, dtype)
            self.bk = _param((kv, hd), device, dtype)
            self.bv = _param((kv, hd), device, dtype)


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.act == "gelu":  # whisper/phi-style 2-matrix MLP
            self.w_in = _param((d, f), device, dtype)
        else:
            self.w_gate = _param((d, f), device, dtype)
            self.w_up = _param((d, f), device, dtype)
        self.w_down = _param((f, d), device, dtype)


class MoE(nn.Module):
    """The reference's MoE parameters: ``router [D, E]`` in f32 whatever the
    model's dtype (as ``a_log``), experts ``w_gate``, ``w_up [E, D, F]``
    and ``w_down [E, F, D]``."""

    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        d, mc = cfg.d_model, cfg.moe
        e, f = mc.num_experts, mc.moe_dff
        self.router = _param((d, e), device, torch.float32)
        self.w_gate = _param((e, d, f), device, dtype)
        self.w_up = _param((e, d, f), device, dtype)
        self.w_down = _param((e, f, d), device, dtype)


class Mamba(nn.Module):
    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        d, di, sc = cfg.d_model, cfg.d_inner, cfg.ssm
        nh = cfg.n_ssm_heads
        self.w_z = _param((d, di), device, dtype)
        self.w_x = _param((d, di), device, dtype)
        self.w_B = _param((d, sc.d_state), device, dtype)
        self.w_C = _param((d, sc.d_state), device, dtype)
        self.w_dt = _param((d, nh), device, dtype)
        self.dt_bias = _param((nh,), device, dtype)
        self.conv_w = _param((sc.conv_width, di), device, dtype)
        self.a_log = _param((nh,), device, torch.float32)
        self.d_skip = _param((di,), device, dtype)
        self.w_out = _param((di, d), device, dtype)


class Sublayer(nn.Module):
    """One pattern position: ``M`` {norm, mamba}; ``A`` {norm1, norm2} (its
    attention and MLP are the model's ``shared_attn``); ``G`` and ``L``
    {norm1, norm2, attn, mlp}, or {norm1, norm2, attn, moe} when
    ``cfg.moe``."""

    def __init__(self, ch: str, cfg: ArchConfig, device, dtype):
        super().__init__()
        self.ch = ch
        if ch == "M":
            self.norm = Norm(cfg, device, dtype)
            self.mamba = Mamba(cfg, device, dtype)
            return
        self.norm1 = Norm(cfg, device, dtype)
        self.norm2 = Norm(cfg, device, dtype)
        if ch in "GL":
            self.attn = Attention(cfg, device, dtype)
            if cfg.moe:
                self.moe = MoE(cfg, device, dtype)
            else:
                self.mlp = MLP(cfg, device, dtype)


class CrossAttention(nn.Module):
    """A decoder layer's cross-attention over the encoder's output: ``norm``
    and ``attn`` (its ``wk``/``wv`` project the encoder output once, in
    :func:`project_cross_kv`)."""

    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        self.norm = Norm(cfg, device, dtype)
        self.attn = Attention(cfg, device, dtype)


class SharedAttention(nn.Module):
    def __init__(self, cfg: ArchConfig, device, dtype):
        super().__init__()
        self.attn = Attention(cfg, device, dtype)
        self.mlp = MLP(cfg, device, dtype)


class LM(nn.Module):
    """An LM with uninitialised parameters on ``device``; build one with
    :func:`init_params` or ``convert.lm_params_from_reference``.  An
    encoder-decoder also holds ``encoder`` (``enc_layers`` ``G`` sublayers
    of the config without MoE), ``enc_final_norm`` and ``cross`` (one
    :class:`CrossAttention` per decoder layer)."""

    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.pattern = _full_pattern(cfg)
        self.embed = _param((cfg.vocab_padded, cfg.d_model), dev, dtype)
        self.layers = nn.ModuleList(Sublayer(ch, cfg, dev, dtype) for ch in self.pattern)
        self.shared_attn = SharedAttention(cfg, dev, dtype) if "A" in self.pattern else None
        self.final_norm = Norm(cfg, dev, dtype)
        self.lm_head = None if cfg.tie_embeddings else _param((cfg.d_model, cfg.vocab_padded),
                                                               dev, dtype)
        if cfg.family == "encdec":  # the encoder: G sublayers without MoE, as the reference
            enc_cfg = dataclasses.replace(cfg, moe=None, layer_pattern="G")
            self.encoder = nn.ModuleList(Sublayer("G", enc_cfg, dev, dtype)
                                         for _ in range(cfg.enc_layers))
            self.enc_final_norm = Norm(cfg, dev, dtype)
            self.cross = nn.ModuleList(CrossAttention(cfg, dev, dtype)
                                       for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def embed_tokens(self, tokens: torch.Tensor, rules=None) -> torch.Tensor:
        idx = torch.as_tensor(tokens, device=self.device).long()
        if rules is not None:
            return self._embed_sharded(idx, rules)
        return self.embed[idx] * (self.cfg.d_model**0.5)

    def _embed_sharded(self, idx: torch.Tensor, rules) -> torch.Tensor:
        """The rank's batch rows looked up in its vocabulary rows (zero for a
        token another rank holds), a partial sum over ``model``: a DTensor
        ``[B, ..., D]`` with the batch over the data axes."""
        bdp = rules.batch_axes(idx.shape[0])
        tpv = rules.split_axis(self.cfg.vocab_padded)
        tail = (None,) * (idx.dim() - 1)
        ids = rules.rows(idx, (bdp, *tail))
        emb = rules.local(self.embed, (tpv, None), rules.split(bdp))
        if tpv is not None:
            ids = ids - rules.coord(tpv) * emb.shape[0]
            held = (ids >= 0) & (ids < emb.shape[0])
            rows = emb[ids.clamp(0, emb.shape[0] - 1)] * held[..., None].to(emb.dtype)
        else:
            rows = emb[ids]
        rows = rows * (self.cfg.d_model**0.5)
        return rules.wrap(rows, (*idx.shape, self.cfg.d_model), (bdp, *tail, None), partial=tpv)

    def embed_inputs(self, tokens: torch.Tensor, patch_embeds=None, rules=None) -> torch.Tensor:
        """Token embeddings ``[B, S, D]``; with ``patch_embeds [B, P, D]`` the
        first P positions are the patches (``cat([patches, h[:, P:]])``, as
        the reference: a prompt shorter than P comes out P long).  Under
        ``rules`` a DTensor in the ``hidden`` layout."""
        h = self.embed_tokens(tokens, rules)
        if patch_embeds is not None:
            pe = torch.as_tensor(patch_embeds, device=self.device).to(self.embed.dtype)
            if rules is None:
                return torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
            bdp = rules.batch_axes(h.shape[0])
            hl = rules.local(h, (bdp, None, None), rules.split(bdp))
            hl = torch.cat([rules.rows(pe, (bdp, None, None)), hl[:, pe.shape[1]:]], dim=1)
            h = rules.wrap(hl, (h.shape[0], hl.shape[1], h.shape[2]), (bdp, None, None))
        return L.cs(rules, h, "hidden")

    def cross_kv(self, enc_frames, impl: str, remat: bool | str = False,
                 rules=None) -> list | None:
        """Per decoder layer, the encoder output's cross ``(k, v)``; ``None``
        unless an encoder-decoder."""
        if self.cfg.family != "encdec":
            return None
        if enc_frames is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder takes enc_frames [B, S_enc, D]")
        frames = torch.as_tensor(enc_frames, device=self.device).to(self.embed.dtype)
        return project_cross_kv(self.cross, encode(self, frames, impl, remat, rules), rules)

    def forward(self, tokens: torch.Tensor, impl: str = "kernel", enc_frames=None,
                patch_embeds=None, remat: bool | str = False, rules=None) -> torch.Tensor:
        """``tokens [B, S]`` -> logits ``[B, S, vocab]``; an encoder-decoder
        takes ``enc_frames``, a VLM may take ``patch_embeds``.  ``remat``
        (off by default: serving keeps no graph) checkpoints each whole
        pattern cycle, and each encoder layer, under grad mode."""
        h = self.embed_inputs(tokens, patch_embeds, rules)
        kv = self.cross_kv(enc_frames, impl, remat, rules)

        def run(x, lo: int, hi: int):
            for i in range(lo, hi):
                layer = self.layers[i]
                cross = cross_call(self, kv and kv[i], i, layer.ch, impl, rules)
                x = block(x, layer, self.cfg, self.shared_attn, impl, cross, rules)
            return x

        period = len(self.cfg.layer_pattern)
        n_cycles = len(self.layers) // period
        for c in range(n_cycles):
            h = rematerialised(run, remat, h, c * period, (c + 1) * period)
        h = run(h, n_cycles * period, len(self.layers))
        h = L.apply_norm(h, self.final_norm, self.cfg.norm)
        return self.logits(h, rules)

    def logits(self, h: torch.Tensor, rules=None) -> torch.Tensor:
        """``h [B, S, D]`` (normed) -> logits ``[B, S, vocab]``.  Under
        ``rules`` each rank multiplies its batch rows by its vocabulary
        columns of the head, and the columns are gathered: a DTensor with
        the batch over the data axes."""
        if rules is None:
            return torch.einsum("bsd,dv->bsv", h, self.head())[..., : self.cfg.vocab]
        b, s, _ = h.shape
        bdp = rules.batch_axes(b)
        tpv = rules.split_axis(self.cfg.vocab_padded)
        split = rules.split(bdp, tpv)
        hl = rules.local(h, (bdp, None, None), split)
        if self.cfg.tie_embeddings:
            head = rules.local(self.embed, (tpv, None), split).T
        else:
            head = rules.local(self.lm_head, (None, tpv), split)
        out = rules.wrap(torch.einsum("bsd,dv->bsv", hl, head), (b, s, self.cfg.vocab_padded),
                         (bdp, None, tpv))
        out = rules.local(out, (bdp, None, None), rules.split(bdp))[..., : self.cfg.vocab]
        return rules.wrap(out, (b, s, self.cfg.vocab), (bdp, None, None))


def _dots_policy(ctx, op, *args, **kwargs):
    """remat="dots": keep the products without batch dimensions (the
    projections; einsum lowers them to a ``bmm`` of batch 1), recompute the
    rest (the attention's batched products included), as the reference's
    ``dots_with_no_batch_dims_saveable``."""
    aten = torch.ops.aten
    keep = op in (aten.mm.default, aten.addmm.default) or (
        op in (aten.bmm.default, aten.baddbmm.default) and args[-2].shape[0] == 1)
    return ckpt.CheckpointPolicy.MUST_SAVE if keep else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def rematerialised(fn, remat: bool | str, *args):
    """``fn(*args)``; under grad mode with ``remat`` a non-reentrant
    ``torch.utils.checkpoint`` of it (the reference's ``jax.checkpoint``),
    keeping the outputs of the products without batch dimensions when
    ``remat == "dots"``."""
    if not remat or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts, _dots_policy)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=ctx)
    return ckpt.checkpoint(fn, *args, use_reentrant=False)


def block(x: torch.Tensor, p: Sublayer, cfg: ArchConfig, shared, impl: str,
          cross=None, rules=None) -> torch.Tensor:
    """One pattern sublayer (the reference's ``lm._block``).  ``cross``
    (optional) is a residual cross-attention applied between
    self-attention and the FFN (decoder order)."""
    if p.ch == "M":
        return x + L.mamba_block(L.apply_norm(x, p.norm, cfg.norm), p.mamba, cfg, impl,
                                 rules=rules)
    ap = shared.attn if p.ch == "A" else p.attn
    h = L.apply_norm(x, p.norm1, cfg.norm)
    x = x + L.attention(h, ap, cfg, causal=True, window=attn_window(p.ch, cfg), impl=impl,
                        rules=rules)
    if cross is not None:
        x = x + cross(x)
    return x + ffn(L.apply_norm(x, p.norm2, cfg.norm), p, cfg, shared, rules)


def ffn(h: torch.Tensor, p: Sublayer, cfg: ArchConfig, shared, rules=None) -> torch.Tensor:
    """A sublayer's feed-forward: the shared block's MLP for ``A``, the MoE
    when ``cfg.moe``, else its own MLP."""
    if p.ch == "A":
        return L.mlp(h, shared.mlp, cfg.act, rules)
    if cfg.moe:
        return L.moe(h, p.moe, cfg, rules)
    return L.mlp(h, p.mlp, cfg.act, rules)


def cross_call(model: LM, kv_row, row: int, ch: str, impl: str, rules=None):
    """The residual cross-attention of decoder layer ``row`` over its
    encoder ``kv_row = (k, v)`` (``G`` and ``L`` sublayers only), or
    ``None``."""
    if kv_row is None or ch not in "GL":
        return None
    cp, cfg = model.cross[row], model.cfg

    def cross(x):
        return L.attention(L.apply_norm(x, cp.norm, cfg.norm), cp.attn, cfg, causal=False,
                           window=None, kv=kv_row, impl=impl, rules=rules)
    return cross


def encode(model: LM, frames: torch.Tensor, impl: str = "kernel",
           remat: bool | str = False, rules=None) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings ``[B, S_enc, D]``
    (the reference's ``lm.encode``): sinusoidal positions added, then the
    ``G`` sublayers with bidirectional attention (#8 without the causal
    mask under ``impl="kernel"``), then ``enc_final_norm``.  As in the
    reference, the attention also ropes q and k (``attention`` ropes
    whenever it projects its own K/V)."""
    cfg = model.cfg
    s, d = frames.shape[1], frames.shape[2]
    dev = frames.device
    half = torch.arange(d // 2, dtype=torch.float32, device=dev) / (d // 2)
    pos = torch.arange(s, dtype=torch.float32, device=dev)[:, None] / (10_000 ** half)[None, :]
    pe = torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1).to(frames.dtype)
    if rules is None:
        h = frames + pe[None]
    else:
        bdp = rules.batch_axes(frames.shape[0])
        h = rules.hidden(rules.wrap(rules.rows(frames, (bdp, None, None)) + pe[None],
                                    frames.shape, (bdp, None, None)))

    def layer(x, p):
        hh = L.apply_norm(x, p.norm1, cfg.norm)
        x = x + L.attention(hh, p.attn, cfg, causal=False, window=None, impl=impl, rules=rules)
        return x + L.mlp(L.apply_norm(x, p.norm2, cfg.norm), p.mlp, cfg.act, rules)

    for p in model.encoder:
        h = rematerialised(layer, remat, h, p)
    return L.apply_norm(h, model.enc_final_norm, cfg.norm)


def project_cross_kv(cross, enc_out: torch.Tensor,
                     rules=None) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per decoder layer, ``(k, v) [B, S_enc, Kv, hd]`` from the encoder
    output: neither roped nor biased (the reference's ``_project_cross_kv``).
    Under ``rules`` DTensors in the attention's kv-head layout."""
    if rules is None:
        return [(torch.einsum("bsd,dhq->bshq", enc_out, cp.attn.wk),
                 torch.einsum("bsd,dhq->bshq", enc_out, cp.attn.wv)) for cp in cross]
    if not cross:
        return []
    b, s, _ = enc_out.shape
    _, h, hd = cross[0].attn.wq.shape
    kv = cross[0].attn.wk.shape[1]
    bdp, _, tpk = L.head_layout(rules, b, h, kv)
    split = rules.split(bdp, tpk)
    el = rules.local(enc_out, (bdp, None, None), split)
    return [tuple(rules.wrap(torch.einsum("bsd,dhq->bshq", el,
                                          rules.local(w, (None, tpk, None), split)),
                             (b, s, kv, hd), (bdp, None, tpk, None))
                  for w in (cp.attn.wk, cp.attn.wv)) for cp in cross]


def attn_window(ch: str, cfg: ArchConfig) -> int | None:
    """The attention window of a pattern position: ``cfg.attn_window`` for
    ``L``, none (global) for ``G`` and ``A``."""
    return cfg.attn_window if ch == "L" else None


def forward(model: LM, tokens: torch.Tensor, impl: str = "kernel", enc_frames=None,
            patch_embeds=None, remat: bool | str = False, rules=None) -> torch.Tensor:
    """Returns logits ``[B, S, vocab]`` (the reference's ``lm.forward``)."""
    return model(tokens, impl=impl, enc_frames=enc_frames, patch_embeds=patch_embeds,
                 remat=remat, rules=rules)


def loss_fn(model: LM, tokens: torch.Tensor, labels: torch.Tensor, impl: str = "plain",
            remat: bool | str = True, rules=None, **kw) -> torch.Tensor:
    """The mean next-token negative log-likelihood (the reference's
    ``lm.loss_fn``): the f32 ``log_softmax`` of the logits, each label's
    log-probability picked by ``gather``, negated and averaged.  ``kw``
    takes ``enc_frames`` and ``patch_embeds``.  Under ``rules`` each rank
    takes its batch rows of the logits, whole over the vocabulary (the
    reference keeps the vocabulary sharded and picks by a masked
    reduction; the port gathers the rows' logits instead), and the mean runs
    over the whole batch: the loss is the same plain scalar on every rank."""
    logits = model(tokens, impl=impl, remat=remat, rules=rules, **kw)
    idx = torch.as_tensor(labels, device=model.device).long()
    if rules is not None:
        bdp = rules.batch_axes(idx.shape[0])
        lg = rules.local(logits, (bdp, None, None))
        ll = torch.gather(F.log_softmax(lg.to(torch.float32), dim=-1), -1,
                          rules.rows(idx, (bdp, None))[..., None])[..., 0]
        return -rules.wrap(ll, idx.shape, (bdp, None)).mean().full_tensor()
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, -1, idx[..., None])[..., 0])


# ----------------------------------------------------------------------------
# Init (the reference's distributions, drawn on the device)
# ----------------------------------------------------------------------------


def _dense_(t: torch.Tensor, g: torch.Generator, scale: float | None = None) -> None:
    """Fan-in-scaled normal, in place: N(0, 1)·scale, scale = shape[0]^-0.5."""
    fan_in = t.shape[0] if t.dim() >= 2 else 1
    scale = scale if scale is not None else fan_in**-0.5
    if t.dtype == torch.float32:
        t.normal_(generator=g).mul_(scale)
    else:  # draw in f32 and round once, as the reference does
        t.copy_(torch.empty(t.shape, device=t.device).normal_(generator=g).mul_(scale))


def _init_norm(p: Norm) -> None:
    p.w.fill_(1.0)
    if hasattr(p, "b"):
        p.b.zero_()


def _init_attn(p: Attention, cfg: ArchConfig, g) -> None:
    _dense_(p.wq, g)
    _dense_(p.wk, g)
    _dense_(p.wv, g)
    _dense_(p.wo, g, scale=(cfg.num_heads * cfg.head_dim) ** -0.5)
    for name in ("bq", "bk", "bv"):
        if hasattr(p, name):
            getattr(p, name).zero_()


def _init_mlp(p: MLP, g) -> None:
    for name in ("w_in", "w_gate", "w_up", "w_down"):
        if hasattr(p, name):
            _dense_(getattr(p, name), g)


def _init_moe(p: MoE, cfg: ArchConfig, g) -> None:
    _dense_(p.router, g)  # fan-in, f32
    _dense_(p.w_gate, g, scale=cfg.d_model**-0.5)
    _dense_(p.w_up, g, scale=cfg.d_model**-0.5)
    _dense_(p.w_down, g, scale=cfg.moe.moe_dff**-0.5)


def _init_sublayer(layer: Sublayer, cfg: ArchConfig, g) -> None:
    if layer.ch == "M":
        _init_norm(layer.norm)
        _init_mamba(layer.mamba, cfg, g)
        return
    _init_norm(layer.norm1)
    _init_norm(layer.norm2)
    if layer.ch in "GL":
        _init_attn(layer.attn, cfg, g)
        if hasattr(layer, "moe"):
            _init_moe(layer.moe, cfg, g)
        else:
            _init_mlp(layer.mlp, g)


def _init_mamba(p: Mamba, cfg: ArchConfig, g) -> None:
    for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"):
        _dense_(getattr(p, name), g)
    p.dt_bias.fill_(-2.0)
    _dense_(p.conv_w, g, scale=0.5)
    p.a_log.zero_()  # A = -exp(0) = -1
    p.d_skip.zero_()
    _dense_(p.w_out, g, scale=cfg.d_inner**-0.5)


@torch.no_grad()
def init_params(
    cfg: ArchConfig,
    generator: torch.Generator | int = 0,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> LM:
    """An :class:`LM` with the reference's initial distributions
    (``repro/models/lm.py:34-125``): fan-in-scaled normals, ``wo`` at
    ``(h·hd)^-0.5``, the embedding at ``d^-0.5``, ``conv_w`` at 0.5,
    ``w_out`` at ``d_inner^-0.5``, ``dt_bias`` −2, ``a_log`` 0, ``d_skip``
    0, norms at 1 (bias 0), QKV biases 0; MoE experts ``w_gate`` and
    ``w_up`` at ``d^-0.5``, ``w_down`` at ``moe_dff^-0.5``, the f32 router
    at fan-in; the encoder's sublayers and each decoder layer's
    cross-attention as a ``G`` sublayer's.  Every tensor is drawn on
    ``device`` (a full-width model never passes through host memory) from
    ``generator``, or from a generator on the device seeded with the given
    int.  The draws are not JAX's: the tests carry the reference's
    parameters across instead."""
    model = LM(cfg, device, dtype)
    if isinstance(generator, int):
        generator = torch.Generator(device=model.device).manual_seed(generator)
    g = generator
    _dense_(model.embed, g, scale=cfg.d_model**-0.5)
    if model.lm_head is not None:
        _dense_(model.lm_head, g)
    _init_norm(model.final_norm)
    for layer in model.layers:
        _init_sublayer(layer, cfg, g)
    if model.shared_attn is not None:
        _init_attn(model.shared_attn.attn, cfg, g)
        _init_mlp(model.shared_attn.mlp, g)
    if cfg.family == "encdec":
        for layer in model.encoder:
            _init_sublayer(layer, cfg, g)
        _init_norm(model.enc_final_norm)
        for cp in model.cross:
            _init_norm(cp.norm)
            _init_attn(cp.attn, cfg, g)
    return model
