"""The port's LM substrate against the JAX package's, on the CPU.

Reduced zamba2-7b (hybrid: Mamba2 + the shared attention block), mamba2-130m
(ssm), yi-9b (dense GQA), qwen1.5-4b (dense, QKV bias), gemma3-12b (``LLLLLG``
sliding-window and global layers) and h2o-danube-3-4b (all ``L``), both with
the window cut to 16, a narrow gemma3 at its own head dim of 240
(``gemma3-12b@d240``), qwen3-moe-235b-a22b and grok-1-314b (MoE, capacity
factor 1.25: capacity drops happen), whisper-tiny (encoder-decoder, seeded
frames) and phi-3-vision-4.2b (VLM, seeded patches), are built by the
reference's ``init_params`` from one key and carried across with
``convert.lm_params_from_reference``, so both packages compute the same
function on the same numpy inputs.  At S = 24 > 16 the ``L`` layers' ring
caches hold the last 16 positions, arranged by prefill and compared slot for
slot; the decode step writes slot 24 % 16.  ``forward`` logits, ``prefill`` last-token logits and caches and
one ``decode_step`` are held against the reference's at atol = rtol = 1e-4
(the same f32 operations, summed in PyTorch's order: the observed gap is
~1e-5); the port's own prefill + decode against its forward at the
reference's 2e-3 (``tests/test_models.py:48``).  On CPU tensors ``impl=
"kernel"`` runs the kernels' plain versions, held against ``impl="plain"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs, reduced
from repro.models import decode_step, forward, init_params, prefill
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import init_cache as tinit_cache
from repro_torch.models import init_params as tinit_params
from repro_torch.models import prefill as tprefill

ARCHS = ["zamba2-7b", "mamba2-130m", "yi-9b", "qwen1.5-4b", "gemma3-12b", "h2o-danube-3-4b",
         "gemma3-12b@d240", "qwen3-moe-235b-a22b", "grok-1-314b", "whisper-tiny",
         "phi-3-vision-4.2b"]
TOL = 1e-4
B, S = 2, 24
# gemma3's head dim (3840 / 16 = 240) on a narrow model: 2 heads, 1 kv head,
# one LLLLLG cycle, the reduced window of 16
D240 = dict(d_model=480, num_heads=2, num_kv_heads=1)


def configs(arch: str):
    """The reference's and the port's config of a test arch: ``reduced``,
    with ``@d240`` the narrow gemma3 at head dim 240."""
    name, _, variant = arch.partition("@")
    cfg, tcfg = reduced(get_config(name)), tconfigs.reduced(tconfigs.get_config(name))
    if variant == "d240":
        cfg, tcfg = dataclasses.replace(cfg, **D240), dataclasses.replace(tcfg, **D240)
        assert cfg.head_dim == tcfg.head_dim == 240
    return cfg, tcfg


def frontend_inputs(cfg, rng, b: int) -> dict:
    """The stub frontends' inputs, numpy from ``rng``: ``enc_frames [B,
    enc_seq, D]`` for an encoder-decoder, ``patch_embeds [B, num_patches,
    D]`` for a VLM, both at the 0.02 scale of ``tests/test_models.py``."""
    kw = {}
    if cfg.family == "encdec":
        kw["enc_frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)) * 0.02
    if cfg.family == "vlm":
        kw["patch_embeds"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)) * 0.02
    return {k: v.astype(np.float32) for k, v in kw.items()}


class Case:
    """The reference's outputs on one reduced arch, computed once.  ``kw``
    holds the frontend inputs as numpy (``jkw`` as JAX arrays, ``tkw`` as
    tensors): the same arrays go to both packages."""

    def __init__(self, arch: str):
        self.cfg, self.tcfg = configs(arch)
        self.params = init_params(self.cfg, jax.random.PRNGKey(0))
        self.model = lm_params_from_reference(jax.tree.map(np.asarray, self.params), self.tcfg,
                                              device="cpu")
        # a MoE decode step routes one token alone, where the forward's S + 1
        # tokens share each expert's capacity: the own-consistency check runs
        # at capacity factor 8, as tests/test_models.py:61-69 does
        self.own_model = self.model
        if self.cfg.moe:
            cf8 = dataclasses.replace(self.tcfg, moe=dataclasses.replace(self.tcfg.moe,
                                                                         capacity_factor=8.0))
            self.own_model = lm_params_from_reference(jax.tree.map(np.asarray, self.params), cf8,
                                                      device="cpu")
        rng = np.random.default_rng(0)
        self.toks = rng.integers(0, self.cfg.vocab, (B, S + 1)).astype(np.int32)
        self.kw = frontend_inputs(self.cfg, rng, B)
        self.jkw = {k: jnp.asarray(v) for k, v in self.kw.items()}
        self.tkw = {k: torch.from_numpy(v) for k, v in self.kw.items()}
        self.ref_logits = np.asarray(forward(self.params, jnp.asarray(self.toks), self.cfg,
                                             **self.jkw))
        self.ref_last, self.ref_cache = prefill(self.params, jnp.asarray(self.toks[:, :S]),
                                                self.cfg, max_seq=S + 1, **self.jkw)
        lg, _ = decode_step(self.params, self.ref_cache, jnp.asarray(self.toks[:, S]),
                            jnp.int32(S), self.cfg)
        self.ref_decode = np.asarray(lg)

    def ref_cache_layer(self, i: int) -> dict:
        """Layer ``i`` of the reference's stacked cache, as numpy, with its
        row of the cross K/V (``cross_k``, ``cross_v``) for an
        encoder-decoder."""
        out = _ref_layer(self.ref_cache, self.cfg, i)
        if "cross" in self.ref_cache:
            out.update(cross_k=np.asarray(self.ref_cache["cross"]["k"][i]),
                       cross_v=np.asarray(self.ref_cache["cross"]["v"][i]))
        return out


_CASES: dict = {}


def _case(arch: str) -> Case:
    if arch not in _CASES:
        _CASES[arch] = Case(arch)
    return _CASES[arch]


@pytest.fixture(params=ARCHS)
def case(request):
    return _case(request.param)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", list_archs())
def test_config_copies_equal_the_reference(arch):
    mine, ref = tconfigs.get_config(arch), get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tconfigs.reduced(mine)) == dataclasses.asdict(reduced(ref))
    assert mine.param_count() == ref.param_count()
    assert tconfigs.list_archs() == list_archs()


def test_forward_matches_reference(case):
    with torch.inference_mode():
        mine = tforward(case.model, torch.from_numpy(case.toks), **case.tkw)
    assert tuple(mine.shape) == (B, S + 1, case.cfg.vocab)
    _close(mine, case.ref_logits)


def test_prefill_logits_and_caches_match_reference(case):
    with torch.inference_mode():
        last, cache = tprefill(case.model, torch.from_numpy(case.toks[:, :S]), max_seq=S + 1,
                               **case.tkw)
    _close(last, case.ref_last)
    assert len(cache) == case.cfg.num_layers
    for i, layer in enumerate(cache):
        want = case.ref_cache_layer(i)
        assert set(layer) == set(want)
        for key in want:
            assert tuple(layer[key].shape) == want[key].shape, (i, key)
            _close(layer[key], want[key])


def test_decode_step_matches_reference(case):
    with torch.inference_mode():
        _, cache = tprefill(case.model, torch.from_numpy(case.toks[:, :S]), max_seq=S + 1,
                            **case.tkw)
        lg, cache2 = tdecode(case.model, cache, torch.from_numpy(case.toks[:, S]), S)
    assert cache2 is cache  # updated in place
    _close(lg, case.ref_decode)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_prefill_projects_each_mamba_layer_once(monkeypatch, arch, impl):
    """Each Mamba layer's cache comes from the call that gives its output:
    ``mamba_inputs`` runs once a layer; under ``impl="kernel"`` the kernel
    wrapper runs once a layer and the model never calls the plain
    ``ssd_chunked`` itself (on the card: no plain SSD at all), under
    ``"plain"`` ``ssd_chunked`` once a layer.  Logits and caches still
    equal the reference's."""
    import repro_torch.models.layers as tlayers

    c = _case(arch)
    calls = dict.fromkeys(("mamba_inputs", "ssd_chunked", "ssd_scan"), 0)

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tlayers, "mamba_inputs", counted("mamba_inputs", tlayers.mamba_inputs))
    monkeypatch.setattr(tlayers, "ssd_chunked", counted("ssd_chunked", tlayers.ssd_chunked))
    monkeypatch.setattr(tlayers.ops, "ssd_scan", counted("ssd_scan", tlayers.ops.ssd_scan))
    with torch.inference_mode():
        last, cache = tprefill(c.model, torch.from_numpy(c.toks[:, :S]), impl=impl,
                               max_seq=S + 1)
    n_mamba = c.model.pattern.count("M")
    assert n_mamba > 0 and calls["mamba_inputs"] == n_mamba
    if impl == "kernel":
        assert (calls["ssd_scan"], calls["ssd_chunked"]) == (n_mamba, 0)
    else:
        assert (calls["ssd_scan"], calls["ssd_chunked"]) == (0, n_mamba)
    _close(last, c.ref_last)
    for i, layer in enumerate(cache):
        want = c.ref_cache_layer(i)
        for key in want:
            _close(layer[key], want[key])


def test_own_prefill_and_decode_match_own_forward(case):
    model = case.own_model
    with torch.inference_mode():
        full = tforward(model, torch.from_numpy(case.toks), **case.tkw)
        last, cache = tprefill(model, torch.from_numpy(case.toks[:, :S]), max_seq=S + 1,
                               **case.tkw)
        lg, _ = tdecode(model, cache, torch.from_numpy(case.toks[:, S]), S)
    _close(last, full[:, S - 1], 2e-3)
    _close(lg, full[:, S], 2e-3)


def test_plain_impl_matches_kernel_impl_on_cpu(case):
    toks, kw = torch.from_numpy(case.toks), case.tkw
    with torch.inference_mode():
        _close(tforward(case.model, toks, impl="plain", **kw), tforward(case.model, toks, **kw),
               1e-5)
        lk, ck = tprefill(case.model, toks[:, :S], impl="kernel", **kw)
        lp, cp = tprefill(case.model, toks[:, :S], impl="plain", **kw)
    _close(lk, lp, 1e-5)
    for a, b in zip(ck, cp):
        for key in a:
            _close(a[key], b[key], 1e-5)
    with pytest.raises(ValueError, match="impl"):
        tforward(case.model, toks, impl="pallas", **kw)


def test_init_params_draws_the_reference_distributions():
    cfg = tconfigs.reduced(tconfigs.get_config("zamba2-7b"))
    ref = init_params(reduced(get_config("zamba2-7b")), jax.random.PRNGKey(0))
    model = tinit_params(cfg, 0, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(ref))
    m = model.layers[0].mamba
    assert torch.all(m.dt_bias == -2.0) and torch.all(m.a_log == 0.0)
    assert torch.all(m.d_skip == 0.0) and torch.all(model.layers[0].norm.w == 1.0)
    big = tinit_params(dataclasses.replace(cfg, d_model=256), 1, device="cpu")
    mb = big.layers[0].mamba
    assert abs(float(mb.w_z.std()) - 256**-0.5) < 0.05 * 256**-0.5
    assert abs(float(mb.conv_w.std()) - 0.5) < 0.05
    assert abs(float(big.embed.std()) - 256**-0.5) < 0.05 * 256**-0.5
    again = tinit_params(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_init_cache_matches_reference_shapes():
    """Every layer's cache leaf has the reference's shape; an
    encoder-decoder's ``cross_k`` / ``cross_v`` that of its row of the
    reference's stacked ``cross``."""
    from repro.models.decode import init_cache

    for arch in ("zamba2-7b", "yi-9b", "gemma3-12b", "h2o-danube-3-4b", "qwen3-moe-235b-a22b",
                 "whisper-tiny", "phi-3-vision-4.2b"):
        ref = init_cache(reduced(get_config(arch)), 2, 16)
        mine = tinit_cache(tconfigs.reduced(tconfigs.get_config(arch)), 2, 16, device="cpu")
        cfg = reduced(get_config(arch))
        period = len(cfg.layer_pattern)
        assert len(mine) == cfg.num_layers
        for i, layer in enumerate(mine):
            c, pos = divmod(i, period)
            sub = dict(ref["cycles"][pos] if c < cfg.num_layers // period else ref["rest"][pos])
            if "cross" in ref:
                sub.update(cross_k=ref["cross"]["k"], cross_v=ref["cross"]["v"])
            assert set(layer) == set(sub), (arch, i)
            for key, t in layer.items():
                assert tuple(t.shape) == tuple(sub[key].shape[1:]), (arch, i, key)


def _ref_layer(cache, cfg, i: int) -> dict:
    """Layer ``i`` of a reference cache (stacked by cycle), as numpy."""
    period = len(cfg.layer_pattern)
    n_cycles = cfg.num_layers // period
    if i < n_cycles * period:
        return {k: np.asarray(v[i // period]) for k, v in cache["cycles"][i % period].items()}
    return {k: np.asarray(v[0]) for k, v in cache["rest"][i - n_cycles * period].items()}


@pytest.fixture(scope="module")
def danube():
    cfg, tcfg = configs("h2o-danube-3-4b")
    params = init_params(cfg, jax.random.PRNGKey(0))
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 40)).astype(np.int32)
    step = jax.jit(lambda p, c, t, pos: decode_step(p, c, t, pos, cfg))  # one trace, 2·19 steps
    return cfg, params, model, toks, step


@pytest.mark.parametrize("plen", [20, 10], ids=["ring_arranged", "ring_padded"])
def test_swa_ring_buffer_long_decode_matches_reference(danube, plen):
    """``tests/test_models.py::test_swa_ring_buffer_long_decode`` through both
    packages: reduced danube (window 16), a prompt of 20 (> W: prefill
    arranges the last 16 positions into the ring) or 10 (< W: padded), then
    decode to position 38, far past 2·W.  The ring after prefill equals the
    reference's slot for slot, every step's logits the reference's and the
    ring after the last step the reference's."""
    cfg, params, model, toks, step = danube
    s = toks.shape[1]
    ref_last, ref_cache = prefill(params, jnp.asarray(toks[:, :plen]), cfg, max_seq=s)
    with torch.inference_mode():
        last, cache = tprefill(model, torch.from_numpy(toks[:, :plen]), max_seq=s)
    _close(last, ref_last)
    for i, layer in enumerate(cache):
        want = _ref_layer(ref_cache, cfg, i)
        assert tuple(layer["k"].shape) == want["k"].shape == (1, cfg.attn_window, 2, 16)
        for key in want:
            _close(layer[key], want[key])
    for pos in range(plen, s - 1):
        lg_ref, ref_cache = step(params, ref_cache, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        with torch.inference_mode():
            lg, cache = tdecode(model, cache, torch.from_numpy(toks[:, pos]), pos)
        _close(lg, np.asarray(lg_ref))
    for i, layer in enumerate(cache):
        want = _ref_layer(ref_cache, cfg, i)
        for key in want:
            _close(layer[key], want[key])


def test_windowed_decode_positions_use_a_floored_remainder(monkeypatch):
    """The ring's absolute positions ``pos − ((pos − i) mod W)``: slots past
    ``pos`` hold the previous lap (``torch.fmod`` would give them positions
    after ``pos``), slots not yet written before the first lap are masked."""
    from repro_torch.models.decode import _attn_decode

    _, tcfg = configs("h2o-danube-3-4b")
    model = tinit_params(tcfg, 0, device="cpu")
    attn = model.layers[0].attn
    w, kv, hd = tcfg.attn_window, tcfg.num_kv_heads, tcfg.head_dim
    seen = {}

    def spy(q, k, v, causal, window=None, k_positions=None, q_positions=None, **kw):
        seen.update(window=window, k_positions=k_positions.clone())
        return torch.zeros_like(q)

    import repro_torch.models.layers as tlayers

    monkeypatch.setattr(tlayers, "xla_flash_attention", spy)
    x = torch.randn(1, 1, tcfg.d_model)
    for pos, want in ((5, [*range(6), *[-(10**9)] * (w - 6)]),
                      (21, [16, 17, 18, 19, 20, 21, *range(6, 16)])):
        cache = {"k": torch.zeros(1, w, kv, hd), "v": torch.zeros(1, w, kv, hd)}
        _attn_decode(x, attn, cache, pos, tcfg, windowed=True)
        assert seen["window"] == w
        assert seen["k_positions"][0].tolist() == want
        assert bool(cache["k"][0, pos % w].abs().sum() > 0)
