"""Optimiser pieces of the PyTorch port (counterparts of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "warmup_cosine",
]
