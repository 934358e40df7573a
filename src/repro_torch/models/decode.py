"""Serving path: KV/state caches, prefill, and single-token ``decode_step``.

Counterpart of ``repro/models/decode.py``.  The cache is a list with one
dict per layer, in pattern order (the reference stacks whole cycles):

  'G' global attn : {k, v} of [B, T_max, Kv, hd]
  'L' SWA attn    : {k, v} of [B, W, Kv, hd], W = min(window, T_max): a ring,
                    position p in slot p % W
  'A' shared attn : as 'G' (weights shared, caches per occurrence)
  'M' mamba2      : {conv: [B, cw-1, d_inner], ssd: [B, nh, ds, hd] f32}

and, for an encoder-decoder, every layer's dict also holds its cross K/V
``cross_k``, ``cross_v`` of ``[B, S_enc, Kv, hd]`` (the reference keeps
them stacked apart, ``{'cross': {k, v} [n_dec, ...]}``); every leaf has the
batch at axis 0, so the serving engine grafts rows of them as of any other.

:func:`prefill` runs the forward pass while it fills the cache: attention
through ``impl`` (kernel #8 on the card by default) and each Mamba
sublayer through ``impl`` (kernel #9).  The reference's prefill runs its
Mamba outputs on its default path whatever ``impl`` says; the port honours
``impl`` there, so a prefill on the card launches #9 once per ``M``
sublayer.  The reference then computes each Mamba layer's projections and
SSD a second time for its final state (``repro/models/decode.py``); here
``mamba_block(return_state=True)`` takes the state from the same call (#9
returns it), so a prefill runs the projections once per layer and, on the
card, no plain ``ssd_chunked``.  The caches hold the same values.

The encoder and the cross-attention run on ``impl`` as well (#8 without the
causal mask on the card), so does the MoE (plain tensor operations: the
reference's MoE is an einsum dispatch, not a kernel).

Decoding is plain PyTorch, as the reference's is outside Pallas: one token
of attention over the cache (``xla_flash_attention`` with the cache's
positions; a ring slot's absolute position is ``p − ((p − i) mod W)``, so
RoPE and the window mask stay exact), one step of the SSD recurrence, and
an encoder-decoder's cross-attention over its cached K/V, as the
reference's ``_cross_decode`` on its default path.  As in the reference,
``decode_step`` attends cross only in the layers of whole pattern cycles,
never in a trailing partial cycle, which ``prefill`` and ``forward`` do
(whisper's pattern ``G`` has no such layer).
Where JAX returns new arrays, :func:`decode_step` writes the new K/V row and
the new Mamba state into ``cache`` in place and returns it: a copy of every
layer's cache per token would cost the card as much time as the step
itself.

``rules`` (a :class:`~repro_torch.models.layers.MeshRules`) runs both over a
mesh: :func:`prefill` returns its cache as DTensors placed by
``distributed.sharding.cache_specs`` and its logits as a DTensor;
:func:`decode_step` takes such a cache.  Each rank attends with its batch
rows and heads against its local cache shard, written in place where the
cache's placement is the attention's own layout (else the cache is
redistributed to that layout for the step and back).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import cache_specs, spec_of
from repro_torch.models import layers as L
from repro_torch.models.lm import LM, attn_window, check_supported, cross_call, ffn

Cache = list[dict[str, torch.Tensor]]


def init_cache(
    cfg: ArchConfig, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> Cache:
    """Zeroed caches for ``batch`` rows of ``max_seq`` positions."""
    check_supported(cfg)
    dev = resolve_device(device)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    cache: Cache = []
    for ch in cfg.layer_pattern * -(-cfg.num_layers // len(cfg.layer_pattern)):
        if len(cache) == cfg.num_layers:
            break
        if ch == "M":
            sc = cfg.ssm
            cache.append({
                "conv": torch.zeros((batch, sc.conv_width - 1, cfg.d_inner), dtype=dtype, device=dev),
                "ssd": torch.zeros((batch, cfg.n_ssm_heads, sc.d_state, sc.head_dim),
                                   dtype=torch.float32, device=dev),
            })
        else:
            t = _ring_len(ch, cfg, max_seq)
            cache.append({
                "k": torch.zeros((batch, t, kv, hd), dtype=dtype, device=dev),
                "v": torch.zeros((batch, t, kv, hd), dtype=dtype, device=dev),
            })
    if cfg.family == "encdec":
        for layer in cache:
            for key in ("cross_k", "cross_v"):
                layer[key] = torch.zeros((batch, cfg.enc_seq, kv, hd), dtype=dtype, device=dev)
    return cache


def _ring(k: torch.Tensor, t: int, s: int) -> torch.Tensor:
    """A prompt's ``k`` or ``v`` ``[B, S, Kv, hd]`` as a cache of ``t``
    slots: a ring (slot ``i % t`` for ``i`` in ``[s − t, s)``) when the
    prompt is longer, else padded to full capacity."""
    if t < s:
        return torch.roll(k[:, s - t:], (s - t) % t, dims=1)
    if t > s:
        return F.pad(k, (0, 0, 0, 0, 0, t - s))
    return k


def _ring_len(ch: str, cfg: ArchConfig, max_seq: int) -> int:
    """Cache slots of an attention layer: ``min(window, max_seq)`` for an
    ``L`` layer with a window, ``max_seq`` otherwise."""
    return min(cfg.attn_window, max_seq) if ch == "L" and cfg.attn_window else max_seq


# ----------------------------------------------------------------------------
# Single-token decode blocks
# ----------------------------------------------------------------------------


def _attn_decode(x, p, cache: dict, pos: int, cfg: ArchConfig, windowed: bool,
                 rules=None) -> torch.Tensor:
    """x [B, 1, D]; writes the new K/V at ``pos`` (``windowed``: at ring
    slot ``pos % W``) into ``cache`` in place."""
    if rules is not None:
        return _attn_decode_sharded(x, p, cache, pos, cfg, windowed, rules)
    q = torch.einsum("bsd,dhq->bshq", x, p.wq)
    k = torch.einsum("bsd,dhq->bshq", x, p.wk)
    v = torch.einsum("bsd,dhq->bshq", x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    o = _attend_cache(q, k, v, cache, pos, cfg, windowed)
    return torch.einsum("bshq,hqd->bsd", o, p.wo)


def _attend_cache(q, k, v, cache: dict, pos: int, cfg: ArchConfig, windowed: bool,
                  expand=None) -> torch.Tensor:
    """Rope ``q``, ``k`` ``[B, 1, ·, hd]`` at ``pos``, write ``k``, ``v`` into
    ``cache`` (local tensors) and attend over it.  ``expand`` maps the
    cache's kv heads to the query heads' (a sharded step's GQA split)."""
    b = q.shape[0]
    posb = torch.full((b, 1), pos, dtype=torch.long, device=q.device)
    q = L.rope(q, posb, cfg.rope_theta)
    k = L.rope(k, posb, cfg.rope_theta)
    t = cache["k"].shape[1]
    slot = pos % t if windowed else pos
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    idx = torch.arange(t, device=q.device)
    if windowed:
        # the absolute position in each ring slot; remainder, not fmod: the
        # dividend is negative for slots past pos, and jnp.mod floors
        k_pos = pos - torch.remainder(pos - idx, t)
        k_pos = torch.where(k_pos >= 0, k_pos, -(10**9))
    else:
        k_pos = torch.where(idx <= pos, idx, -(10**9))
    ck, cv = cache["k"], cache["v"]
    if expand is not None:
        ck, cv = expand(ck), expand(cv)
    return L.xla_flash_attention(
        q, ck, cv, causal=True, window=t if windowed else None,
        k_positions=k_pos.expand(b, t), q_positions=posb,
    )


def _local_cache(rules, cache: dict, specs: dict) -> dict:
    """The local tensors of ``cache``'s DTensors in the step's layouts
    ``specs`` (the cache's own shards, written in place, where its placement
    is that layout)."""
    return {key: rules.local(cache[key], spec) for key, spec in specs.items()}


def _store_cache(rules, cache: dict, local: dict, specs: dict) -> None:
    """Put the step's local tensors back into ``cache`` as DTensors with the
    placements the cache had."""
    for key, spec in specs.items():
        old = cache[key]
        cache[key] = rules.wrap(local[key], old.shape, spec).redistribute(
            old.device_mesh, old.placements)


def _attn_decode_sharded(x, p, cache: dict, pos: int, cfg: ArchConfig, windowed: bool,
                         rules) -> torch.Tensor:
    b = x.shape[0]
    bdp, tph, tpk = L.head_layout(rules, b, cfg.num_heads, cfg.num_kv_heads)
    xl = rules.local(x, (bdp, None, None))
    lp = rules.local_params(p, {"wq": (None, tph, None), "wk": (None, tpk, None),
                                "wv": (None, tpk, None), "wo": (tph, None, None),
                                "bq": (tph, None), "bk": (tpk, None), "bv": (tpk, None)})
    q = torch.einsum("bsd,dhq->bshq", xl, lp.wq)
    k = torch.einsum("bsd,dhq->bshq", xl, lp.wk)
    v = torch.einsum("bsd,dhq->bshq", xl, lp.wv)
    if cfg.qkv_bias:
        q, k, v = q + lp.bq, k + lp.bk, v + lp.bv
    specs = {"k": (bdp, None, tpk, None), "v": (bdp, None, tpk, None)}
    local = _local_cache(rules, cache, specs)
    expand = None
    if tph is not None and tpk is None:
        def expand(t):
            return L.rank_kv_heads(rules, t, cfg.num_heads, tph)
    o = _attend_cache(q, k, v, local, pos, cfg, windowed, expand)
    _store_cache(rules, cache, local, specs)
    out = torch.einsum("bshq,hqd->bsd", o, lp.wo)
    return rules.hidden(rules.wrap(out, x.shape, (bdp, None, None), partial=tph))


def _mamba_decode(x, p, cache: dict, cfg: ArchConfig, rules=None) -> torch.Tensor:
    """x [B, 1, D]; replaces ``cache``'s conv and ssd states in place."""
    if rules is not None:
        b = x.shape[0]
        bdp, tpd = rules.batch_axes(b), rules.split_axis(cfg.n_ssm_heads)
        specs = {"conv": (bdp, None, tpd), "ssd": (bdp, tpd, None, None)}
        local = _local_cache(rules, cache, specs)
        out = _mamba_decode(rules.local(x, (bdp, None, None)),
                            L.mamba_local_params(p, rules, tpd, ()), local, cfg)
        _store_cache(rules, cache, local, specs)
        return rules.hidden(rules.wrap(out, x.shape, (bdp, None, None), partial=tpd))
    sc = cfg.ssm
    b = x.shape[0]
    hd = sc.head_dim
    nh = p.a_log.shape[0]
    di = nh * hd
    x0 = x[:, 0]
    z = torch.einsum("bd,de->be", x0, p.w_z)
    xin = torch.einsum("bd,de->be", x0, p.w_x)  # [B, di]
    bvec = torch.einsum("bd,dn->bn", x0, p.w_B)
    cvec = torch.einsum("bd,dn->bn", x0, p.w_C)
    dt = F.softplus(torch.einsum("bd,dh->bh", x0, p.w_dt) + p.dt_bias)
    # causal conv over the last cw-1 inputs + the current one
    hist = torch.cat([cache["conv"], xin[:, None, :].to(cache["conv"].dtype)], dim=1)
    xc = F.silu(torch.einsum("bcd,cd->bd", hist, p.conv_w))
    u = xc.reshape(b, nh, hd) * dt[..., None]
    a = -torch.exp(p.a_log)  # [nh]
    decay = torch.exp(dt * a)  # [B, nh]
    h = cache["ssd"] * decay[..., None, None] + bvec[:, None, :, None] * u[..., None, :]
    y = torch.einsum("bn,bhnd->bhd", cvec, h.to(cvec.dtype))
    y = y.reshape(b, di) + xc * p.d_skip
    cache["conv"] = hist[:, 1:]
    cache["ssd"] = h
    return torch.einsum("be,ed->bd", y * F.silu(z), p.w_out)[:, None, :]


def _sub_decode(x, p, cache: dict, pos: int, cfg: ArchConfig, shared,
                cross=None, rules=None) -> torch.Tensor:
    if p.ch == "M":
        return x + _mamba_decode(L.apply_norm(x, p.norm, cfg.norm), p.mamba, cache, cfg, rules)
    ap = shared.attn if p.ch == "A" else p.attn
    x = x + _attn_decode(L.apply_norm(x, p.norm1, cfg.norm), ap, cache, pos, cfg,
                         windowed=(p.ch == "L"), rules=rules)
    if cross is not None:
        x = x + cross(x)
    return x + ffn(L.apply_norm(x, p.norm2, cfg.norm), p, cfg, shared, rules)


def decode_step(
    model: LM, cache: Cache, tokens: torch.Tensor, pos: int, rules=None,
) -> tuple[torch.Tensor, Cache]:
    """One decode step for the whole batch: ``tokens [B]`` at position
    ``pos``.  Returns ``(logits [B, vocab], cache)``, ``cache`` updated in
    place (under ``rules`` its leaves are replaced by DTensors of the same
    placements)."""
    cfg = model.cfg
    pos = int(pos)
    tokens = torch.as_tensor(tokens, device=model.device)[:, None]
    h = model.embed_inputs(tokens, rules=rules)
    # the reference's decode attends cross in the scanned cycles only
    cycled = cfg.num_layers // len(cfg.layer_pattern) * len(cfg.layer_pattern)
    for i, (layer, c) in enumerate(zip(model.layers, cache)):
        cross = None
        if cfg.family == "encdec" and i < cycled:
            cross = cross_call(model, (c["cross_k"], c["cross_v"]), i, layer.ch, "plain", rules)
        h = _sub_decode(h, layer, c, pos, cfg, model.shared_attn, cross, rules)
    h = L.apply_norm(h, model.final_norm, cfg.norm)
    logits = model.logits(h, rules)
    return logits[:, 0], cache


def prefill(
    model: LM,
    tokens: torch.Tensor,  # [B, S]
    impl: str = "kernel",
    max_seq: int | None = None,  # cache capacity (>= S; default S)
    enc_frames=None,  # [B, S_enc, D] (encoder-decoder)
    patch_embeds=None,  # [B, P, D] (VLM prefix)
    rules=None,
) -> tuple[torch.Tensor, Cache]:
    """Full-sequence prefill: returns ``(last-token logits [B, vocab],
    filled cache)``.  ``G``/``A`` caches are padded to ``max_seq``; an
    ``L`` cache is a ring of ``W = min(window, max_seq)`` slots: the last
    ``W`` positions, position ``p`` in slot ``p % W``, when the prompt is
    longer, else the prompt padded to ``W``.  An encoder-decoder runs its
    encoder on ``enc_frames`` and keeps each layer's cross K/V; a VLM's
    ``patch_embeds`` replace the first token embeddings."""
    L.check_impl(impl)
    cfg = model.cfg
    b, s = tokens.shape
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"max_seq={max_seq} is shorter than the prompt ({s})")
    shared = model.shared_attn
    h = model.embed_inputs(tokens, patch_embeds, rules)
    kv = model.cross_kv(enc_frames, impl, rules=rules)
    positions = torch.arange(s, device=model.device).expand(b, s)
    cache: Cache = []
    for i, p in enumerate(model.layers):
        if p.ch == "M":
            out, state = L.mamba_block(L.apply_norm(h, p.norm, cfg.norm), p.mamba, cfg, impl,
                                       return_state=True, rules=rules)
            cache.append(state)
            h = h + out
            continue
        ap = shared.attn if p.ch == "A" else p.attn
        hh = L.apply_norm(h, p.norm1, cfg.norm)
        o, (k, v) = L.attention(hh, ap, cfg, causal=True, window=attn_window(p.ch, cfg),
                                positions=positions, impl=impl, return_kv=True, rules=rules)
        h = h + o
        cross = cross_call(model, kv and kv[i], i, p.ch, impl, rules)
        if cross is not None:
            h = h + cross(h)
        h = h + ffn(L.apply_norm(h, p.norm2, cfg.norm), p, cfg, shared, rules)
        t = _ring_len(p.ch, cfg, max_seq)
        if rules is None:
            k, v = _ring(k, t, s), _ring(v, t, s)
        else:  # the sequence dim is whole in each rank's k and v
            k, v = (rules.wrap(_ring(x.to_local(), t, s), (b, t, *x.shape[2:]),
                               spec_of(x.placements, rules.mesh, 4)) for x in (k, v))
        cache.append({"k": k, "v": v})
    if kv is not None:
        for layer, (ck, cv) in zip(cache, kv):
            layer["cross_k"], layer["cross_v"] = ck, cv
    h = L.apply_norm(h, model.final_norm, cfg.norm)
    if rules is None:
        logits = torch.einsum("bd,dv->bv", h[:, -1], model.head())[:, : cfg.vocab]
        return logits, cache
    bdp = rules.batch_axes(b)
    last = rules.local(h, (bdp, None, None))[:, -1:]
    logits = model.logits(rules.wrap(last, (b, 1, h.shape[2]), (bdp, None, None)), rules)
    return logits[:, 0], place_cache(cache, cfg, max_seq, rules)


def place_cache(cache: Cache, cfg: ArchConfig, max_seq: int, rules) -> Cache:
    """Every leaf of ``cache`` (DTensors) redistributed to its
    ``cache_specs`` placement for a batch of ``B`` rows and ``max_seq``
    positions."""
    b = cache[0][next(iter(cache[0]))].shape[0]
    specs = cache_specs(cache, cfg, ShapeConfig("decode", max_seq, b, "decode"), rules.mesh)
    return [{k: rules.cs(layer[k], *spec[k]) for k in layer} for layer, spec in zip(cache, specs)]

