"""Step functions: the prefill and decode steps the servers run.

Counterpart of ``repro/launch/steps.py`` (``make_prefill_step``,
``make_decode_step``).  The reference's factories close over ``cfg`` and
``rules`` so that ``jax.jit`` sees pure array signatures; here the model
carries its config and the steps run eagerly.  The train step arrives with
the training slice of the port (ROADMAP Queue 1).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode as D
from repro_torch.models.layers import check_impl
from repro_torch.models.lm import check_supported


def make_prefill_step(cfg: ArchConfig, impl: str = "kernel", max_seq: int | None = None):
    """``prefill_step(model, batch) -> (last logits [B, V], cache)`` over
    ``batch["tokens"]``, with ``batch["enc_frames"]`` for an
    encoder-decoder and ``batch["patch_embeds"]`` for a VLM;
    ``impl="kernel"`` runs kernels #8 and #9 on the card."""
    check_supported(cfg)
    check_impl(impl)

    def prefill_step(model, batch):
        kw = {}
        if cfg.family == "encdec":
            kw["enc_frames"] = batch["enc_frames"]
        if cfg.family == "vlm":
            kw["patch_embeds"] = batch["patch_embeds"]
        return D.prefill(model, batch["tokens"], impl=impl, max_seq=max_seq, **kw)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode_step(model, cache, tokens, pos) -> (logits [B, V], cache)``."""
    check_supported(cfg)

    def decode_step(model, cache, tokens, pos):
        return D.decode_step(model, cache, tokens, pos)

    return decode_step
