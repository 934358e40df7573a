"""Checkpointing of the PyTorch port (counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager, latest_step

__all__ = ["CheckpointManager", "latest_step"]
