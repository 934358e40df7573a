"""The port's LM substrate against the JAX package's, on the CPU.

Reduced zamba2-7b (hybrid: Mamba2 + the shared attention block), mamba2-130m
(ssm), yi-9b (dense GQA) and qwen1.5-4b (dense, QKV bias) are built by the
reference's ``init_params`` from one key and carried across with
``convert.lm_params_from_reference``, so both packages compute the same
function.  ``forward`` logits, ``prefill`` last-token logits and caches and
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
from repro_torch.models import LM
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import init_cache as tinit_cache
from repro_torch.models import init_params as tinit_params
from repro_torch.models import prefill as tprefill

ARCHS = ["zamba2-7b", "mamba2-130m", "yi-9b", "qwen1.5-4b"]
TOL = 1e-4
B, S = 2, 24


class Case:
    """The reference's outputs on one reduced arch, computed once."""

    def __init__(self, arch: str):
        self.cfg = reduced(get_config(arch))
        self.tcfg = tconfigs.reduced(tconfigs.get_config(arch))
        self.params = init_params(self.cfg, jax.random.PRNGKey(0))
        self.model = lm_params_from_reference(jax.tree.map(np.asarray, self.params), self.tcfg,
                                              device="cpu")
        rng = np.random.default_rng(0)
        self.toks = rng.integers(0, self.cfg.vocab, (B, S + 1)).astype(np.int32)
        self.ref_logits = np.asarray(forward(self.params, jnp.asarray(self.toks), self.cfg))
        self.ref_last, self.ref_cache = prefill(self.params, jnp.asarray(self.toks[:, :S]),
                                                self.cfg, max_seq=S + 1)
        lg, _ = decode_step(self.params, self.ref_cache, jnp.asarray(self.toks[:, S]),
                            jnp.int32(S), self.cfg)
        self.ref_decode = np.asarray(lg)

    def ref_cache_layer(self, i: int) -> dict:
        """Layer ``i`` of the reference's stacked cache, as numpy."""
        period = len(self.cfg.layer_pattern)
        n_cycles = self.cfg.num_layers // period
        if i < n_cycles * period:
            sub = self.ref_cache["cycles"][i % period]
            return {k: np.asarray(v[i // period]) for k, v in sub.items()}
        sub = self.ref_cache["rest"][i - n_cycles * period]
        return {k: np.asarray(v[0]) for k, v in sub.items()}


_CASES: dict = {}


@pytest.fixture(params=ARCHS)
def case(request):
    if request.param not in _CASES:
        _CASES[request.param] = Case(request.param)
    return _CASES[request.param]


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
        mine = tforward(case.model, torch.from_numpy(case.toks))
    assert tuple(mine.shape) == (B, S + 1, case.cfg.vocab)
    _close(mine, case.ref_logits)


def test_prefill_logits_and_caches_match_reference(case):
    with torch.inference_mode():
        last, cache = tprefill(case.model, torch.from_numpy(case.toks[:, :S]), max_seq=S + 1)
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
        _, cache = tprefill(case.model, torch.from_numpy(case.toks[:, :S]), max_seq=S + 1)
        lg, cache2 = tdecode(case.model, cache, torch.from_numpy(case.toks[:, S]), S)
    assert cache2 is cache  # updated in place
    _close(lg, case.ref_decode)


def test_own_prefill_and_decode_match_own_forward(case):
    with torch.inference_mode():
        full = tforward(case.model, torch.from_numpy(case.toks))
        last, cache = tprefill(case.model, torch.from_numpy(case.toks[:, :S]), max_seq=S + 1)
        lg, _ = tdecode(case.model, cache, torch.from_numpy(case.toks[:, S]), S)
    _close(last, full[:, S - 1], 2e-3)
    _close(lg, full[:, S], 2e-3)


def test_plain_impl_matches_kernel_impl_on_cpu(case):
    toks = torch.from_numpy(case.toks)
    with torch.inference_mode():
        _close(tforward(case.model, toks, impl="plain"), tforward(case.model, toks), 1e-5)
        lk, ck = tprefill(case.model, toks[:, :S], impl="kernel")
        lp, cp = tprefill(case.model, toks[:, :S], impl="plain")
    _close(lk, lp, 1e-5)
    for a, b in zip(ck, cp):
        for key in a:
            _close(a[key], b[key], 1e-5)
    with pytest.raises(ValueError, match="impl"):
        tforward(case.model, toks, impl="pallas")


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
    from repro.models.decode import init_cache

    for arch in ("zamba2-7b", "yi-9b"):
        ref = init_cache(reduced(get_config(arch)), 2, 16)
        mine = tinit_cache(tconfigs.reduced(tconfigs.get_config(arch)), 2, 16, device="cpu")
        cfg = reduced(get_config(arch))
        period = len(cfg.layer_pattern)
        for i, layer in enumerate(mine):
            c, pos = divmod(i, period)
            sub = ref["cycles"][pos] if c < cfg.num_layers // period else ref["rest"][pos]
            for key, t in layer.items():
                assert tuple(t.shape) == tuple(sub[key].shape[1:]), (arch, i, key)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b", "whisper-tiny",
                                  "phi-3-vision-4.2b", "gemma3-12b", "h2o-danube-3-4b"])
def test_what_this_slice_does_not_carry_raises(arch):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    with pytest.raises(NotImplementedError, match="slice"):
        LM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        tinit_params(cfg, 0, device="cpu")
