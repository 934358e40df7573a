"""Three train steps of the port against the reference's ``make_train_step``
on the CPU, and chip_smoke.py's training phases rehearsed on the CPU.

The reference's jitted step and the port's eager step start from the same
parameters (``convert.lm_params_from_reference``) and take three steps on
the same batch (B 2, S 16) under ``peak_lr=3e-3, warmup=2``: the rate is 0
at step 0, then 1.5e-3 and 3e-3.  Measured: losses and grad norms agree to
~2e-7 relative and the parameters to ≤ 8e-5 absolute after the three steps
(AdamW's first moves are ~lr·sign(g), so an element whose gradient lies
near zero carries the f32 rounding of g into a move of up to 2·lr).  Held:
loss and grad norm to rtol 1e-5, the learning rate exactly, every
parameter to ``2e-4 + 1e-5·|p|`` (a twentieth of the 4.5e-3 the two
nonzero steps may move an element).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.launch.steps import TrainState as RTrainState
from repro.launch.steps import make_train_step as rmake
from repro.models import init_params as rinit
from repro.optim import adamw_init as radamw_init
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.pipeline import make_token_corpus
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import init_params

REPO = pathlib.Path(__file__).resolve().parent.parent
B, S = 2, 16
LR = {"peak_lr": 3e-3, "warmup": 2, "total_steps": 60}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _arrays(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["enc_frames"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model)) * 0.02
                             ).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.normal(size=(B, cfg.num_patches, cfg.d_model)) * 0.02
                               ).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen1.5-4b", "qwen3-moe-235b-a22b",
                                  "phi-3-vision-4.2b"])
def test_three_train_steps_match_reference(arch):
    cfg = reduced(get_config(arch))
    params = rinit(cfg, jax.random.PRNGKey(0))
    arrays = _arrays(cfg)
    ref_step = jax.jit(rmake(cfg, **LR))
    rstate = RTrainState(params, radamw_init(params), jnp.zeros((), jnp.int32))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    state = make_train_state(lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg,
                                                      device="cpu"))
    step = make_train_step(tcfg, **LR)
    rb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    for i in range(3):
        rstate, rm = ref_step(rstate, rb)
        state, m = step(state, tb)
        assert float(m["lr"]) == float(rm["lr"]), i
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5), i
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-5), i
    assert int(state.step) == int(rstate.step) == 3
    assert int(state.opt.step) == int(rstate.opt.step) == 3
    ref = dict(lm_params_from_reference(jax.tree.map(np.asarray, rstate.params), tcfg,
                                        device="cpu").named_parameters())
    for n, p in state.model.named_parameters():
        r = ref[n].detach()
        err = (p.detach() - r).abs()
        assert bool((err <= 2e-4 + 1e-5 * r.abs()).all()), (n, float(err.max()))


# ---- chip_smoke.py's training phases, rehearsed on the CPU


def _run(cs, seen):
    def run(name, fn):
        assert name in cs.PHASE_KERNELS
        seen.append(name)
        return fn(), 0.5, dict.fromkeys(cs.KERNELS, 0)
    return run


def test_chip_smoke_train_stream_phase_on_a_small_cpu_corpus(monkeypatch):
    cs = _chip_smoke()
    store, tokens = make_token_corpus(num_seqs=1024, seq_len=17, vocab=512, seed=0, device="cpu")
    seen = []
    res = cs.train_stream_check(store, tokens, store.to("cpu"), tokens.clone(), _run(cs, seen),
                                batches=8)
    assert seen == ["train_stream"]
    first, second = (res["filters"][f] for f in cs.TRAIN_FILTERS)
    assert first["batches"] == 8 and first["refills"] > 0
    assert second["epoch_reset_at"] is not None and second["rounds"] >= 1
    assert second["batches"] == second["epoch_reset_at"] + 8
    with pytest.raises(AssertionError, match="no epoch reset"):
        cs.train_stream_check(store, tokens, store.to("cpu"), tokens.clone(), _run(cs, []),
                              batches=8, cap=12)
    # a stream whose CPU copy differs fails on its record ids
    other, other_tokens = make_token_corpus(num_seqs=1024, seq_len=17, vocab=512, seed=1,
                                            device="cpu")
    with pytest.raises(AssertionError, match="differ"):
        cs.train_stream_check(store, tokens, other, other_tokens, _run(cs, []), batches=8)


def test_chip_smoke_train_phase_restart_on_a_reduced_cpu_model():
    cs = _chip_smoke()
    seen = []
    res = cs.train_check(_run(cs, seen), device="cpu", reduced=True, corpus_seqs=512, batch=4,
                         steps=6, every=3, seq=16)
    assert seen == ["train", "train"]
    assert res["rel"] <= cs.TRAIN_RESTART_RTOL and np.isfinite(res["loss"])
    assert 0.0 < res["refill_share"] < 1.0 and res["refills"] >= 1
    assert res["peak_gb"] is None and res["tokens_per_s"] > 0


def test_chip_smoke_train_learns_and_archs_phases_on_the_cpu():
    cs = _chip_smoke()
    seen = []
    cfg = tconfigs.reduced(tconfigs.get_config(cs.TRAIN_ARCH))
    res = cs.train_learns_check(cfg, _run(cs, seen), 0, device="cpu")
    assert res["last"] < cs.TRAIN_LEARN["ratio"] * res["first"]
    res = cs.train_archs_check(_run(cs, seen), 0, device="cpu", ref_device="cpu")
    assert seen == ["train_learns", "train_archs"]
    assert set(res["archs"]) == set(tconfigs.list_archs())
    assert all(r["loss_rel"] == 0.0 and r["param_err_over_lr"] <= 0.0
               for r in res["archs"].values())


def test_chip_smoke_moe_equal_length_traffic_compares_every_token():
    """The lm_moe traffic of one prompt length, shrunk: no row is padded,
    no routing flip, every token compared."""
    cs = _chip_smoke()
    mcfg = tconfigs.reduced(tconfigs.get_config(cs.MOE_ARCH))
    model = init_params(mcfg, 0, device="cpu")
    traffic = {**cs.MOE_EQUAL_TRAFFIC, "plen": (40, 41), "max_seq": 64}
    prompts = cs.serve_prompts(mcfg, traffic, 0)
    assert {len(p) for p in prompts} == {40}
    want = cs.lm_layer_counts(mcfg)

    def run(name, fn):
        out = fn()
        n = len(out[0].wave_stats)
        return out, 0.5, {**dict.fromkeys(cs.KERNELS, 0), **{k: v * n for k, v in want.items()}}

    res = cs.lm_serve_check(model, traffic, 0, run, "lm_moe")
    s = res["streams"]
    assert s["tokens_equal"] + s["near_ties"] == s["tokens"] == 4 * 16
    assert s["after_flip"] == 0 and res["routing"]["flips"] == 0
