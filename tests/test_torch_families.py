"""The port's MoE, encoder-decoder and VLM pieces against the JAX package's,
on the CPU.

``layers.moe`` alone against ``repro.models.layers.moe`` (capacity drops
present at a capacity factor of 1.25, none at 8.0), the reference's top-k
order on ties, ``encode`` and the cross K/V, the VLM splice on both sides of
``num_patches``, ``convert`` and ``init_params`` for all four families, the
step functions' extra inputs, the launcher's refusal of the
encoder-decoder, and ``chip_smoke.py``'s routing accounting and family
phases rehearsed on reduced models.  Inputs are numpy arrays from fixed
seeds, the same arrays through both packages; reduced configs, S <= 32.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import decode_step, forward, init_params, prefill
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import decode as tdecode
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

TOL = 1e-4
KEY = jax.random.PRNGKey(0)
FAMILIES = ["qwen3-moe-235b-a22b", "grok-1-314b", "whisper-tiny", "phi-3-vision-4.2b"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _configs(arch: str, **moe):
    """The reference's and the port's reduced config, the MoE fields
    replaced by ``moe``."""
    cfg, tcfg = reduced(get_config(arch)), tconfigs.reduced(tconfigs.get_config(arch))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe))
    return cfg, tcfg


def _model(arch: str, **moe):
    cfg, tcfg = _configs(arch, **moe)
    params = init_params(cfg, KEY)
    return cfg, params, lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg,
                                                 device="cpu")


def _moe_layer(cf: float, router=None):
    """A MoE layer of 8 experts, top 3, ``d_model`` 64, from the reference's
    ``_moe_params``, in both packages, and an input ``[2, 32, 64]``."""
    cfg, tcfg = _configs("qwen3-moe-235b-a22b", num_experts=8, top_k=3, capacity_factor=cf)
    p = rlm._moe_params(KEY, cfg, jnp.float32)
    if router is not None:
        p["router"] = jnp.asarray(router, jnp.float32)
    mod = tlm.MoE(tcfg, torch.device("cpu"), torch.float32)
    with torch.no_grad():
        for name, leaf in p.items():
            getattr(mod, name).copy_(torch.from_numpy(np.array(leaf)))
    x = np.random.default_rng(1).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, p, mod, x


def _dropped(topi: np.ndarray, e: int, c1: int) -> int:
    """Tokens a round sends past its expert's capacity, over all rounds:
    the reference's integer position in expert along S."""
    n = 0
    for r in range(topi.shape[-1]):
        onehot = np.eye(e, dtype=np.int64)[topi[..., r]]
        pos = np.cumsum(onehot, axis=1) - onehot
        n += int(((pos >= c1) & (onehot > 0)).sum())
    return n


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_layer_matches_reference_with_and_without_capacity_drops(cf):
    cfg, tcfg, p, mod, x = _moe_layer(cf)
    want = np.asarray(rlayers.moe(jnp.asarray(x), p, cfg, None))
    with torch.inference_mode():
        got = tlayers.moe(torch.from_numpy(x), mod, tcfg)
        _, topi = tlayers.router_top_k(tlayers.router_probs(torch.from_numpy(x), mod),
                                       cfg.moe.top_k)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x), p["router"]), axis=-1)
    ref_topi = np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])
    np.testing.assert_array_equal(topi.numpy(), ref_topi)
    _close(got, want)
    c1 = max(int(32 / cfg.moe.num_experts * cf), 4)
    drops = _dropped(ref_topi, cfg.moe.num_experts, c1)
    assert (drops > 0) if cf == 1.25 else (drops == 0), drops


def test_router_top_k_keeps_the_reference_tie_order():
    """Ties go to the lower expert index first, as ``jax.lax.top_k`` puts
    them: on hand-made rows with ties at, across and inside the top k, and
    through the whole layer with a zero router (every probability 1/E, so
    round r sends every token to expert r and most are dropped)."""
    probs = np.array([[0.125] * 8,
                      [0.1, 0.2, 0.2, 0.1, 0.2, 0.1, 0.05, 0.05],
                      [0.3, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1],
                      [0.05, 0.05, 0.1, 0.1, 0.2, 0.2, 0.15, 0.15]], np.float32)
    for k in (1, 3, 5, 8):
        vals, idx = tlayers.router_top_k(torch.from_numpy(probs), k)
        rv, ri = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    cfg, tcfg, p, mod, x = _moe_layer(1.25, router=np.zeros((64, 8)))
    with torch.inference_mode():
        _, topi = tlayers.router_top_k(tlayers.router_probs(torch.from_numpy(x), mod), 3)
        got = tlayers.moe(torch.from_numpy(x), mod, tcfg)
    assert (topi.numpy() == np.arange(3)).all()
    _close(got, np.asarray(rlayers.moe(jnp.asarray(x), p, cfg, None)))


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_router_margins_exceed_the_tolerance_and_flips_are_accounted():
    """chip_smoke's routing accounting.  On reduced qwen3-moe at S = 24 the
    port's and the reference's router probabilities differ by far less than
    the smallest gap between adjacent ranks, and that gap exceeds the file's
    tolerance: logits equal at 1e-4 cannot hide a different routing.  The
    accounting counts a flip below ``MOE_MARGIN_BOUND`` (its row's first
    position, its request's first token after it) and fails one above."""
    cs = _chip_smoke()
    cfg, params, model = _model("qwen3-moe-235b-a22b")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    logs = [cs.RouterLog(), cs.RouterLog()]
    with torch.inference_mode():
        for log, impl in zip(logs, ("kernel", "plain")):
            with log.record():
                model(torch.from_numpy(toks), impl=impl)
    routing = cs.routing_flips(*logs)
    assert routing["moe_calls"] == cfg.num_layers and routing["flips"] == 0
    assert routing["smallest_margin"] > TOL
    # the router's input at layer 0, in both packages
    h = params["embed"][toks] * cfg.d_model**0.5
    lp = jax.tree.map(lambda t: t[0], params["cycles"][0])
    hh = rlayers.apply_norm(h, lp["norm1"], cfg.norm)
    h = h + rlayers.attention(hh, lp["attn"], cfg, causal=True, window=None, rules=None)
    x = rlayers.apply_norm(h, lp["norm2"], cfg.norm)
    ref = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, lp["moe"]["router"]), axis=-1)
    mine = tlayers.router_probs(torch.from_numpy(np.array(x)), model.layers[0].moe)
    assert float(np.abs(mine.numpy() - np.asarray(ref)).max()) < routing["smallest_margin"] / 100

    def event(idx, gaps):
        return ("moe", torch.tensor([idx]), torch.tensor([gaps], dtype=torch.float32))

    a, b = cs.RouterLog(), cs.RouterLog()
    a.events = [event([[0, 1], [2, 3]], [[0.1, 0.1], [0.1, 3e-6]]), ("tokens", [(0, 7, 0)])]
    b.events = [event([[0, 1], [2, 4]], [[0.1, 0.1], [0.1, 5e-6]]), ("tokens", [(0, 7, 0)])]
    out = cs.routing_flips(a, b)
    assert out["flips"] == 1 and out["first_pos"] == {0: 1} and out["first_token"] == {7: 0}
    assert out["largest_flip_margin"] == pytest.approx(5e-6)
    b.events[0] = event([[0, 1], [2, 4]], [[0.1, 0.1], [0.1, 2e-5]])  # above on one path
    with pytest.raises(AssertionError, match="routing flip"):
        cs.routing_flips(a, b)
    # the same set in another rank order moves capacity positions too
    a.events[0] = event([[0, 1], [2, 3]], [[2e-6, 0.1], [0.1, 0.1]])
    b.events[0] = event([[1, 0], [2, 3]], [[4e-6, 0.1], [0.1, 0.1]])
    out = cs.routing_flips(a, b)
    assert out["flips"] == 1 and out["first_pos"] == {0: 0}
    b.events[1] = ("tokens", [(0, 8, 0)])
    with pytest.raises(AssertionError, match="different"):
        cs.routing_flips(a, b)
    # after a flip at position 0 the row's later positions, later layers and
    # its request's decode steps differ anyway: flips there are downstream
    a.events = [event([[0, 1], [2, 3]], [[3e-6, 0.1], [0.1, 0.1]]),
                event([[0, 1], [2, 3]], [[0.1, 0.1], [0.1, 0.1]]), ("tokens", [(0, 7, 0)]),
                ("moe", torch.tensor([[[0, 1]]]), torch.tensor([[[0.1, 0.1]]])),
                ("tokens", [(0, 7, 1)])]
    b.events = [event([[1, 0], [2, 3]], [[3e-6, 0.1], [0.1, 0.1]]),
                event([[0, 1], [3, 2]], [[0.1, 0.1], [0.2, 0.1]]), ("tokens", [(0, 7, 0)]),
                ("moe", torch.tensor([[[1, 0]]]), torch.tensor([[[0.3, 0.1]]])),
                ("tokens", [(0, 7, 1)])]
    out = cs.routing_flips(a, b)
    assert (out["flips"], out["downstream"]) == (1, 2) and out["first_token"] == {7: 0}
    b.events[0] = a.events[0]  # the same flip, first met in the second layer: above the bound
    with pytest.raises(AssertionError, match="position 1"):
        cs.routing_flips(a, b)


def test_moe_decode_exact_without_capacity_drops():
    """``tests/test_models.py::test_moe_decode_exact_without_capacity_drops``
    through the port: at capacity factor 8 nothing drops, so a decode step
    (a group of one token) gives the forward's logits at that position."""
    cfg, params, model = _model("qwen3-moe-235b-a22b", capacity_factor=8.0)
    toks = np.asarray(jax.random.randint(KEY, (2, 17), 0, cfg.vocab))
    with torch.inference_mode():
        ref = tlm.forward(model, torch.from_numpy(toks))
        last, cache = tdecode.prefill(model, torch.from_numpy(toks[:, :16]), max_seq=17)
        lg, _ = tdecode.decode_step(model, cache, torch.from_numpy(toks[:, 16]), 16)
    np.testing.assert_allclose(lg.numpy(), ref[:, 16].numpy(), atol=2e-3)
    np.testing.assert_allclose(last.numpy(), ref[:, 15].numpy(), atol=2e-3)
    ref_lg, _ = decode_step(params, prefill(params, jnp.asarray(toks[:, :16]), cfg,
                                            max_seq=17)[1], jnp.asarray(toks[:, 16]),
                            jnp.int32(16), cfg)
    _close(lg, ref_lg)


def test_moe_decode_routes_a_token_alone_where_the_forward_may_drop_it():
    """At capacity factor 1.25 the prefill equals the forward up to the
    prompt's end (capacity is taken in order along S), while a decode step
    routes its token in a group of one and never drops it: its logits equal
    the forward's exactly in the rows whose token the forward kept, as in
    the reference."""
    cfg, params, model = _model("qwen3-moe-235b-a22b")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 25)).astype(np.int32)
    with torch.inference_mode():
        full = tlm.forward(model, torch.from_numpy(toks))
        last, cache = tdecode.prefill(model, torch.from_numpy(toks[:, :24]), max_seq=25)
        lg, _ = tdecode.decode_step(model, cache, torch.from_numpy(toks[:, 24]), 24)
    _close(last, full[:, 23])
    ref_full = np.asarray(forward(params, jnp.asarray(toks), cfg))
    ref_lg = np.asarray(decode_step(params, prefill(params, jnp.asarray(toks[:, :24]), cfg,
                                                    max_seq=25)[1],
                                    jnp.asarray(toks[:, 24]), jnp.int32(24), cfg)[0])
    _close(lg, ref_lg)
    same = np.isclose(ref_lg, ref_full[:, 24], atol=TOL, rtol=TOL).all(axis=-1)
    np.testing.assert_array_equal(
        np.isclose(lg.numpy(), full[:, 24].numpy(), atol=TOL, rtol=TOL).all(axis=-1), same)
    assert not same.all()  # the forward dropped a last token here


@pytest.fixture(scope="module")
def whisper():
    cfg, params, model = _model("whisper-tiny")
    frames = (np.random.default_rng(2).standard_normal((2, cfg.enc_seq, cfg.d_model))
              * 0.02).astype(np.float32)
    return cfg, params, model, frames


def test_encode_and_cross_kv_match_reference(whisper):
    """The encoder (sinusoidal positions, bidirectional attention that also
    ropes, as the reference's does) and each decoder layer's cross K/V,
    neither roped nor biased; kernel and plain paths alike on the CPU."""
    cfg, params, model, frames = whisper
    ref_enc = rlm.encode(params, jnp.asarray(frames), cfg)
    ref_kv = rlm._project_cross_kv(params["cross"], ref_enc, cfg)
    with torch.inference_mode():
        for impl in ("kernel", "plain"):
            enc = tlm.encode(model, torch.from_numpy(frames), impl)
            _close(enc, ref_enc)
            kv = tlm.project_cross_kv(model.cross, enc)
            assert len(kv) == cfg.num_layers
            for i, (k, v) in enumerate(kv):
                assert tuple(k.shape) == (2, cfg.enc_seq, cfg.num_kv_heads, cfg.head_dim)
                _close(k, ref_kv["k"][i])
                _close(v, ref_kv["v"][i])


@pytest.mark.parametrize("s", [4, 12], ids=["shorter_than_the_patches", "longer"])
def test_vlm_splice_matches_reference_on_both_sides_of_num_patches(s):
    """``cat([patches, h[:, P:]])``: a prompt of 12 > P = 8 keeps its
    length, one of 4 < P comes out P long, in both packages."""
    cfg, params, model = _model("phi-3-vision-4.2b")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    pe = (rng.standard_normal((2, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32)
    ref = np.asarray(forward(params, jnp.asarray(toks), cfg, patch_embeds=jnp.asarray(pe)))
    with torch.inference_mode():
        got = tlm.forward(model, torch.from_numpy(toks), patch_embeds=torch.from_numpy(pe))
        h = model.embed_inputs(torch.from_numpy(toks), torch.from_numpy(pe))
    assert tuple(got.shape) == ref.shape == (2, max(s, cfg.num_patches), cfg.vocab)
    _close(got, ref)
    np.testing.assert_array_equal(h[:, :cfg.num_patches].numpy(), pe)
    if s < cfg.num_patches:  # prefill ropes S positions: both packages refuse
        with pytest.raises(TypeError, match="broadcasting"):
            prefill(params, jnp.asarray(toks), cfg, patch_embeds=jnp.asarray(pe))
        with pytest.raises(RuntimeError, match="must match"), torch.inference_mode():
            tdecode.prefill(model, torch.from_numpy(toks), patch_embeds=torch.from_numpy(pe))


@pytest.mark.parametrize("arch", FAMILIES)
def test_convert_fills_every_parameter_once(arch):
    """Every port parameter filled from the reference's tree, element for
    element as many; a tree without its encoder, cross or MoE subtree leaves
    parameters unfilled, which ``convert`` refuses."""
    cfg, params, model = _model(arch)
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))
    tcfg = model.cfg
    drop = {"encdec": "cross", "vlm": "cycles"}.get(cfg.family, "cycles")
    tree = jax.tree.map(np.asarray, params)
    if cfg.moe:
        tree["cycles"] = [{k: v for k, v in sub.items() if k != "moe"} for sub in tree["cycles"]]
    else:
        tree.pop(drop)
    with pytest.raises(ValueError, match="unfilled"):
        lm_params_from_reference(tree, tcfg, device="cpu")
    if cfg.family == "encdec":
        tree = jax.tree.map(np.asarray, params)
        tree.pop("encoder")
        with pytest.raises(ValueError, match="unfilled"):
            lm_params_from_reference(tree, tcfg, device="cpu")


def test_init_params_draws_the_reference_distributions_for_the_families():
    """``init_params`` for MoE, the encoder and the cross-attention: as many
    parameters as the reference's ``init_params``; the router in f32 in a
    bf16 model; experts at d^-0.5 (``w_gate``, ``w_up``) and moe_dff^-0.5
    (``w_down``), the router at fan-in; the encoder's and cross-attention's
    projections at fan-in, their LayerNorms at 1 and 0."""
    for arch in FAMILIES:
        cfg, tcfg = _configs(arch)
        model = tlm.init_params(tcfg, 0, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == sum(
            x.size for x in jax.tree.leaves(init_params(cfg, KEY))), arch
    _, tcfg = _configs("qwen3-moe-235b-a22b", num_experts=16, moe_dff=512)
    tcfg = dataclasses.replace(tcfg, d_model=256)
    moe = tlm.init_params(tcfg, 1, device="cpu", dtype=torch.bfloat16).layers[0].moe
    assert moe.router.dtype == torch.float32 and moe.w_gate.dtype == torch.bfloat16
    for t, want in ((moe.router, 256**-0.5), (moe.w_gate, 256**-0.5), (moe.w_up, 256**-0.5),
                    (moe.w_down, 512**-0.5)):
        assert abs(float(t.float().std()) - want) < 0.05 * want
    _, wcfg = _configs("whisper-tiny")
    w = tlm.init_params(dataclasses.replace(wcfg, d_model=256), 2, device="cpu")
    assert len(w.encoder) == wcfg.enc_layers and len(w.cross) == wcfg.num_layers
    for t in (w.encoder[0].attn.wq, w.encoder[1].mlp.w_in, w.cross[0].attn.wk):
        assert abs(float(t.std()) - 256**-0.5) < 0.05 * 256**-0.5
    for norm in (w.enc_final_norm, w.cross[1].norm, w.encoder[0].norm2):
        assert torch.all(norm.w == 1.0) and torch.all(norm.b == 0.0)


def test_param_count_matches_init():
    """``tests/test_models.py::test_param_count_matches_init`` for the port's
    grok-1: the built model's parameters within 20% of ``param_count()``
    (which leaves out norms and vocab padding)."""
    cfg = tconfigs.reduced(tconfigs.get_config("grok-1-314b"))
    model = tlm.init_params(cfg, 0, device="cpu")
    actual = sum(p.numel() for p in model.parameters())
    emb_pad = (cfg.vocab_padded - cfg.vocab) * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    assert abs(actual - emb_pad - cfg.param_count()) / actual < 0.2


@pytest.mark.parametrize("arch", ["whisper-tiny", "phi-3-vision-4.2b"])
def test_prefill_step_passes_the_frontend_inputs(arch):
    """``make_prefill_step`` hands ``batch["enc_frames"]`` (encoder-decoder)
    or ``batch["patch_embeds"]`` (VLM) to ``prefill``: its logits and cache
    are the reference's step's; a batch without them is refused."""
    from repro.launch.steps import make_prefill_step as ref_step

    cfg, params, model = _model(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    key = "enc_frames" if cfg.family == "encdec" else "patch_embeds"
    n = cfg.enc_seq if cfg.family == "encdec" else cfg.num_patches
    extra = (rng.standard_normal((2, n, cfg.d_model)) * 0.02).astype(np.float32)
    want, want_cache = ref_step(cfg, max_seq=13)(params, {"tokens": jnp.asarray(toks),
                                                          key: jnp.asarray(extra)})
    with torch.inference_mode():
        last, cache = make_prefill_step(model.cfg, max_seq=13)(
            model, {"tokens": torch.from_numpy(toks), key: torch.from_numpy(extra)})
        lg, _ = make_decode_step(model.cfg)(model, cache, torch.from_numpy(toks[:, -1]), 12)
        with pytest.raises(KeyError, match=key):
            make_prefill_step(model.cfg)(model, {"tokens": torch.from_numpy(toks)})
    _close(last, want)
    ref_lg, _ = decode_step(params, want_cache, jnp.asarray(toks[:, -1]), jnp.int32(12), cfg)
    _close(lg, ref_lg)


def test_serve_launcher_refuses_the_encoder_decoder():
    with pytest.raises(SystemExit, match="decoder-only"):
        tserve.main(["--arch", "whisper-tiny", "--device", "cpu"])


def test_chip_smoke_family_phases_pass_on_reduced_cpu_models():
    """chip_smoke.py's lm_moe (forward, both traffics, the continuous loop
    with its joiners), lm_encdec and lm_vlm functions on reduced models on
    the CPU (the kernels' plain versions; the launches a card run would
    read handed in), and the non-causal #8 rows of the kernels phase."""
    cs = _chip_smoke()
    phases = []

    def runner(cfg):
        want = cs.lm_layer_counts(cfg)

        def run(name, fn):
            out = fn()
            n = 1
            if isinstance(out, dict):  # a continuous run: one launch set a prefill
                n = sum(cs.lm_prefills(e) for e, _, _ in out.values())
            elif isinstance(out, tuple) and hasattr(out[0], "wave_stats"):
                n = len(out[0].wave_stats)
            phases.append(name)
            return out, 0.5, {**dict.fromkeys(cs.KERNELS, 0),
                              **{k: v * n for k, v in want.items()}}
        return run

    mcfg = tconfigs.reduced(tconfigs.get_config(cs.MOE_ARCH))
    model = tlm.init_params(mcfg, 0, device="cpu")
    run = runner(mcfg)
    fwd = cs.lm_forward_check(model, 40, 0, run, "lm_moe")
    assert fwd["max_abs_err"] < 1e-4 and fwd["routing"]["moe_calls"] == 2
    for traffic in cs.SERVE_TRAFFIC.values():
        traffic = {**traffic, "plen": (4, 24), "max_seq": 48}
        res = cs.lm_serve_check(model, traffic, 0, run, "lm_moe")
        assert res["streams"]["tokens_equal"] == res["streams"]["tokens"] > 0
        assert res["streams"]["after_flip"] == 0 and res["routing"]["flips"] == 0
        assert res["routing"]["moe_calls"] == sum(
            (1 + w["decode_steps"]) * mcfg.num_layers for w in res["waves"])
    res = cs.lm_continuous_check(model, cs.LM_JOIN, 0, run, "lm_moe",
                                 cs.SERVE_TRAFFIC["launcher"])
    assert res["join"]["joiner_vs_solo"]["tokens_equal"] == cs.LM_JOIN["max_new"][1]
    assert res["traffic"]["streams"]["tokens_equal"] == 8 * 16
    assert res["join"]["routing"]["flips"] == 0 and res["join"]["routing"]["moe_calls"] > 0
    for arch, traffic, want in ((cs.ENCDEC_ARCH, cs.ENCDEC_TRAFFIC, 6),
                                (cs.VLM_ARCH, {**cs.VLM_TRAFFIC, "plen": (4, 20)}, 2)):
        cfg = tconfigs.reduced(tconfigs.get_config(arch))
        assert cs.lm_layer_counts(cfg)["flash_attention"] == want  # whisper: 2 + 2 + 2
        model = tlm.init_params(cfg, 0, device="cpu")
        res = cs.steps_check(model, traffic, 0, runner(cfg), "lm_x")
        assert res["streams"]["tokens_equal"] == res["streams"]["tokens"] == 4 * 17
        assert res["launches"]["flash_attention"] == want
        keys = {"k", "v", "cross_k", "cross_v"} if cfg.family == "encdec" else {"k", "v"}
        assert set(res["cache_max_abs_err"]) == keys
        if cfg.family == "vlm":  # the patches, then the longest text
            texts = cs.serve_prompts(cfg, traffic, 0)
            assert res["prompt_len"] == cfg.num_patches + max(len(t) for t in texts)
        with pytest.raises(AssertionError, match="launches"):
            cs.steps_check(model, traffic, 0, lambda name, fn: (fn(), 0.5, {
                **dict.fromkeys(cs.KERNELS, 0), "flash_attention": want - 1}), "lm_x")
    assert cs.lm_layer_counts(tconfigs.get_config(cs.ENCDEC_ARCH))["flash_attention"] == 12
    assert cs.lm_layer_counts(tconfigs.get_config(cs.VLM_ARCH))["flash_attention"] == 32

    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    sweep = cs.fa_sweep(randn, cs.FA_TOL, causal=False)
    assert sorted(sweep) == sorted(cs.FA_D_SWEEP)
    shapes = {(s == t, s < t) for _, hq, hkv, s, t, _ in cs.FA_NONCAUSAL_SHAPES if hq > hkv}
    assert shapes == {(True, False), (False, True), (False, False)}  # S = T, S < T, S > T
    wcfg = dataclasses.replace(tconfigs.get_config(cs.ENCDEC_ARCH), enc_seq=40)
    cs_time = cs.time_ms
    try:
        cs.time_ms = lambda fn, flush=None: (fn(), 0.0)[1]
        rows = cs.noncausal_attention(wcfg, 2, 7, randn, 12)
    finally:
        cs.time_ms = cs_time
    assert rows["encoder"]["shape"] == {"B": 2, "Hq": 6, "Hkv": 6, "S": 40, "T": 40, "D": 64}
    assert rows["cross"]["shape"]["S"] == 7 and rows["launches_per_prefill"] == 12
    for name, s in (("encoder", 40), ("cross", 7)):
        assert rows[name]["library_max_abs_err"] < 1e-5
        nbytes, ops = (2 * 6 * s + 2 * 6 * 40) * 2 * 64 * 4, 4.0 * 2 * 6 * 64 * s * 40
        assert (rows[name]["bound_ms"], rows[name]["bound_by"]) == cs.bound_tf32x3_ms(nbytes,
                                                                                         ops)
