"""Gradient compression with error feedback (counterpart of
``repro/optim/compress.py``).

int8 uniform quantisation with a per-tensor scale and an error-feedback
residual (Seide et al. / Karimireddy et al.): the quantisation error is
carried into the next step, so compression is unbiased over time.  On the
wire 4 bytes become 1 per gradient element.  Gradients are dicts keyed by
parameter name; ``torch.round`` rounds half to even, as ``jnp.round``
does, so ``q`` equals the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CompressState(NamedTuple):
    error: dict[str, torch.Tensor]  # f32 residuals, shaped like the grads


def compress_init(grads_like: dict[str, torch.Tensor]) -> CompressState:
    return CompressState(error={n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                                for n, g in grads_like.items()})


def quantize(g: torch.Tensor, err: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``g + err`` -> ``(int8 q, scale, new_err)`` with round to nearest even.
    Divisors are tensors: CUDA turns division by a Python number into a
    multiply by its reciprocal."""
    corrected = g.to(torch.float32) + err
    d127 = torch.tensor(127.0, dtype=torch.float32, device=g.device)
    scale = torch.clamp(torch.max(torch.abs(corrected)), min=1e-12) / d127
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_err = corrected - q.to(torch.float32) * scale
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads: dict[str, torch.Tensor], state: CompressState
                   ) -> tuple[dict[str, tuple[torch.Tensor, torch.Tensor]], CompressState]:
    """Quantise every gradient: ``({name: (q, scale)}, new state)``."""
    qs, errs = {}, {}
    for n, g in grads.items():
        q, s, ne = quantize(g, state.error[n])
        qs[n], errs[n] = (q, s), ne
    return qs, CompressState(error=errs)


def decompress_grads(qgrads: dict[str, tuple[torch.Tensor, torch.Tensor]]
                     ) -> dict[str, torch.Tensor]:
    return {n: dequantize(q, s) for n, (q, s) in qgrads.items()}
