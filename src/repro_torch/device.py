"""Device resolution: explicit, never a silent fall back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return the ``torch.device`` named by ``device``.

    ``"cuda"`` (the default of every entry point) raises when CUDA is not
    available; the CPU is used only when the caller names it.  A bare
    ``"cuda"`` is pinned to the current CUDA device index, so the result
    compares equal to a tensor's ``.device``.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
