"""Decoder-only LMs on PyTorch (counterpart of ``repro/models``)."""
from repro_torch.models.decode import decode_step, init_cache, prefill
from repro_torch.models.lm import LM, forward, init_params, loss_fn

__all__ = [
    "LM", "decode_step", "forward", "init_cache", "init_params", "loss_fn", "prefill",
]
