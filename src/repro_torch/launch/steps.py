"""Step functions: the train step the trainer runs, and the prefill and
decode steps the servers run.

Counterpart of ``repro/launch/steps.py`` (``TrainState``,
``make_train_step``, ``make_prefill_step``, ``make_decode_step``).  The
reference's factories close over ``cfg`` and ``rules`` so that ``jax.jit``
sees pure array signatures; here the model carries its config and the
steps run eagerly.

The train step differentiates :func:`repro_torch.models.lm.loss_fn` with
autograd on the plain path (``impl="plain"``, the reference's default
``"xla"``): the reference's Pallas kernels define no gradient, and neither
do the port's #8 and #9, so ``impl="kernel"`` is refused.

``rules`` (a :class:`~repro_torch.models.layers.MeshRules`; keyword-only
here, where the reference takes it second) runs each step over a mesh.  A
sharded train state holds the model's parameters as DTensors placed by
``distributed.sharding.train_state_specs``
(``distributed.sharding.distribute_params`` before
:func:`make_train_state`), and the AdamW moments as DTensors of the same
placements (ZeRO); ``step`` is replicated.  Every gradient is brought to its
parameter's placements, the clip takes the norm over the whole DTensors,
and the update runs on each rank's shards.  Batches are the whole batch on
every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode as D
from repro_torch.models import lm as M
from repro_torch.models.layers import check_impl
from repro_torch.models.lm import check_supported
from repro_torch.optim import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim import warmup_cosine


class TrainState(NamedTuple):
    model: M.LM  # holds the parameters, updated in place
    opt: AdamWState
    step: torch.Tensor  # [] int32


def make_train_state(model: M.LM, state_dtype: torch.dtype = torch.float32) -> TrainState:
    """Turn on ``requires_grad`` for ``model``'s parameters (an ``LM`` is
    built with it off, so that serving builds no autograd graph) and pair
    the model with fresh AdamW moments in ``state_dtype`` at step 0."""
    for p in model.parameters():
        p.requires_grad_(True)
    opt = adamw_init(dict(model.named_parameters()), state_dtype)
    return TrainState(model, opt, torch.zeros((), dtype=torch.int32, device=model.device))


def family_inputs(cfg: ArchConfig, batch: dict) -> dict:
    """The extra model inputs a family takes from a batch: ``enc_frames``
    for an encoder-decoder, ``patch_embeds`` for a VLM."""
    kw = {}
    if cfg.family == "encdec":
        kw["enc_frames"] = batch["enc_frames"]
    if cfg.family == "vlm":
        kw["patch_embeds"] = batch["patch_embeds"]
    return kw


def make_train_step(
    cfg: ArchConfig,
    peak_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    clip: float = 1.0,
    impl: str = "plain",
    remat: bool | str = True,
    *,
    rules=None,
):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``
    over ``batch["tokens"]`` and ``batch["labels"]``: the loss and its
    gradients by autograd, the gradients clipped to a global norm of
    ``clip``, the learning rate ``warmup_cosine(opt.step)`` taken before the
    update, then AdamW in place on the model's parameters."""
    check_supported(cfg)
    check_impl(impl)
    if impl == "kernel":
        raise ValueError("make_train_step: the kernels #8 and #9 define no gradient (as the "
                         "reference's Pallas kernels define no VJP); train with impl='plain'")

    def train_step(state: TrainState, batch: dict):
        model = state.model
        params = dict(model.named_parameters())
        frozen = [n for n, p in params.items() if not p.requires_grad]
        if frozen:
            raise ValueError(f"parameters {frozen[:3]} do not require grad; build the state "
                             "with make_train_state")
        with torch.enable_grad():
            lval = M.loss_fn(model, batch["tokens"], batch["labels"], impl=impl, remat=remat,
                             rules=rules, **family_inputs(cfg, batch))
            gs = torch.autograd.grad(lval, list(params.values()), allow_unused=True,
                                     materialize_grads=True)
        if rules is not None:
            gs = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(gs, params.values())]
        grads, gnorm = clip_by_global_norm(dict(zip(params, gs)), clip)
        lr = warmup_cosine(state.opt.step, peak_lr, warmup, total_steps)
        _, opt = adamw_update(params, grads, state.opt, lr)
        metrics = {"loss": lval.detach(), "grad_norm": gnorm, "lr": lr}
        return TrainState(model, opt, state.step + 1), metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, impl: str = "kernel", max_seq: int | None = None, *,
                      rules=None):
    """``prefill_step(model, batch) -> (last logits [B, V], cache)`` over
    ``batch["tokens"]``, with ``batch["enc_frames"]`` for an
    encoder-decoder and ``batch["patch_embeds"]`` for a VLM;
    ``impl="kernel"`` runs kernels #8 and #9 on the card (under ``rules``
    on each rank's shards)."""
    check_supported(cfg)
    check_impl(impl)

    def prefill_step(model, batch):
        return D.prefill(model, batch["tokens"], impl=impl, max_seq=max_seq, rules=rules,
                         **family_inputs(cfg, batch))

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, rules=None):
    """``decode_step(model, cache, tokens, pos) -> (logits [B, V], cache)``."""
    check_supported(cfg)

    def decode_step(model, cache, tokens, pos):
        return D.decode_step(model, cache, tokens, pos, rules=rules)

    return decode_step
