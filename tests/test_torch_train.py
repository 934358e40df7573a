"""The port's training loss and gradients against the JAX package's, on the
CPU, and the train step's and the launcher's own contracts.

For each of the ten configurations at ``reduced()`` (B 2, S 16; seeded
``enc_frames`` / ``patch_embeds`` at 0.02), the reference's parameters are
carried across with ``convert.lm_params_from_reference``; the reference's
gradient tree has the parameters' structure, so the same function maps it
onto a module and the two are compared leaf by leaf.  Measured: the loss
agrees to ~1.5e-7 relative, every gradient leaf to ~9e-6 of its largest
element (zamba2's; the rest ≤ 3.3e-6).  Held: the loss to rtol 1e-6, each
leaf to ``max |Δ| <= 5e-5·max |ref| + 1e-9``.

Then the port alone: rematerialisation (whole cycles, encoder layers,
``"dots"``) changes no value, ``make_train_step(impl="kernel")`` is refused,
the loss falls on the learnable pattern of ``tests/test_models.py:86``, and
the launcher trains end to end and restarts exactly
(``tests/test_system.py:10-38``, ``--device cpu``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs, reduced
from repro.models import init_params as rinit
from repro.models import loss_fn as rloss
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.models import init_params, loss_fn

B, S = 2, 16
LOSS_RTOL = 1e-6
GRAD_TOL = 5e-5  # of each leaf's largest reference element


def batch_arrays(cfg, b: int, s: int, seed: int = 0) -> dict:
    """Seeded numpy tokens, labels and a family's stub inputs."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["enc_frames"] = (rng.normal(size=(b, cfg.enc_seq, cfg.d_model)) * 0.02
                             ).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.normal(size=(b, cfg.num_patches, cfg.d_model)) * 0.02
                               ).astype(np.float32)
    return out


def extras(arrays: dict, to) -> dict:
    return {k: to(v) for k, v in arrays.items() if k in ("enc_frames", "patch_embeds")}


def loss_and_grads(model, arrays: dict, **kw):
    for p in model.parameters():
        p.requires_grad_(True)
    loss = loss_fn(model, torch.from_numpy(arrays["tokens"]), torch.from_numpy(arrays["labels"]),
                   **extras(arrays, torch.from_numpy), **kw)
    names = [n for n, _ in model.named_parameters()]
    gs = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                             materialize_grads=True)
    return loss.detach(), dict(zip(names, gs))


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_reference(arch):
    cfg = reduced(get_config(arch))
    params = rinit(cfg, jax.random.PRNGKey(0))
    arrays = batch_arrays(cfg, B, S)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda p: rloss(
        p, jnp.asarray(arrays["tokens"]), jnp.asarray(arrays["labels"]), cfg,
        **extras(arrays, jnp.asarray))))(params)
    tcfg = treduced(tget(arch))
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    loss, grads = loss_and_grads(model, arrays)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
    ref = dict(lm_params_from_reference(jax.tree.map(np.asarray, ref_grads), tcfg,
                                        device="cpu").named_parameters())
    assert set(ref) == set(grads)
    for n, g in grads.items():
        r = ref[n].detach()
        err = float((g - r).abs().max())
        assert err <= GRAD_TOL * float(r.abs().max()) + 1e-9, (n, err, float(r.abs().max()))


@pytest.mark.parametrize("arch,remat", [("mamba2-130m", True), ("mamba2-130m", "dots"),
                                        ("whisper-tiny", True), ("zamba2-7b", "dots")])
def test_remat_changes_no_value(arch, remat):
    """Checkpointing whole cycles (zamba2's trailing partial cycle runs
    plain) and encoder layers recomputes the same operations: equal loss and
    gradients."""
    cfg = treduced(tget(arch))
    arrays = batch_arrays(cfg, B, S, seed=1)
    model = init_params(cfg, 0, device="cpu")
    l0, g0 = loss_and_grads(model, arrays, remat=False)
    l1, g1 = loss_and_grads(model, arrays, remat=remat)
    assert float(l1) == float(l0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-9)


def test_forward_defaults_to_no_remat_and_no_graph():
    """Serving is unchanged: parameters built without grad, so a forward
    keeps no graph whatever ``remat`` says."""
    cfg = treduced(tget("mamba2-130m"))
    model = init_params(cfg, 0, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    toks = torch.zeros((1, 8), dtype=torch.int32)
    assert model(toks, impl="plain").grad_fn is None
    assert model(toks, impl="plain", remat=True).grad_fn is None


def test_train_step_refuses_kernel_impl_and_untrainable_state():
    cfg = treduced(tget("qwen1.5-4b"))
    with pytest.raises(ValueError, match="define no gradient"):
        make_train_step(cfg, impl="kernel")
    with pytest.raises(ValueError, match="impl must be one of"):
        make_train_step(cfg, impl="xla")
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim import adamw_init

    model = init_params(cfg, 0, device="cpu")
    state = TrainState(model, adamw_init(dict(model.named_parameters())), torch.zeros(()))
    arrays = batch_arrays(cfg, B, S)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    with pytest.raises(ValueError, match="make_train_state"):
        make_train_step(cfg)(state, batch)


def test_loss_decreases_on_learnable_pattern():
    """tests/test_models.py:86 on the port."""
    cfg = treduced(tget("qwen1.5-4b"))
    state = make_train_state(init_params(cfg, 0, device="cpu"))
    step_fn = make_train_step(cfg, peak_lr=3e-3, warmup=2, total_steps=60)
    toks = torch.arange(16, dtype=torch.int32).tile(4, 4)[:, :48]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    for _ in range(30):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.6, losses[::6]
    assert int(state.step) == int(state.opt.step) == 30


def test_train_launcher_end_to_end(tmp_path):
    loss = train_main([
        "--arch", "mamba2-130m", "--reduced", "--steps", "8", "--batch", "4",
        "--seq", "48", "--filter", "domain=code", "--corpus-seqs", "512",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "4", "--log-every", "4",
        "--device", "cpu",
    ])
    assert np.isfinite(loss)
    assert latest_step(tmp_path) == 8
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4", "step_8"]


def test_train_restart_is_exact(tmp_path):
    """Crash-restart: 4 steps + resume-to-8 equals an uninterrupted 8, and
    so does the pipeline state at step 8."""
    args = ["--arch", "qwen1.5-4b", "--reduced", "--steps", "8", "--batch", "4",
            "--seq", "32", "--filter", "quality=hi", "--corpus-seqs", "256",
            "--ckpt-every", "4", "--log-every", "8", "--device", "cpu"]
    loss_straight = train_main(args + ["--ckpt-dir", str(tmp_path / "a")])
    stopped = [a if a != "8" else "4" for a in args]
    train_main(stopped + ["--ckpt-dir", str(tmp_path / "b")])
    assert latest_step(tmp_path / "b") == 4
    loss_resumed = train_main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert loss_resumed == pytest.approx(loss_straight, rel=1e-4)
    ea, eb = (CheckpointManager(tmp_path / d).extra(8) for d in "ab")
    assert ea == eb
