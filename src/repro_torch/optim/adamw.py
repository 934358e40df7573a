"""AdamW with a configurable state dtype (counterpart of
``repro/optim/adamw.py``): decoupled weight decay (Loshchilov & Hutter),
bias correction and global-norm clipping, written out as the reference
writes them, so the two agree to f32 rounding.

``params``, ``grads`` and the moments ``m`` and ``v`` are dicts keyed by
the model's ``named_parameters()`` names.  :func:`adamw_update` writes the
new values into the parameters in place, under ``torch.no_grad()``, so the
``nn.Module`` stays the one object that holds the weights.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor  # [] int32
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def adamw_init(params: dict[str, torch.Tensor], state_dtype=torch.float32) -> AdamWState:
    """Zero moments in ``state_dtype`` beside each parameter; step 0."""
    first = next(iter(params.values()), None)
    dev = first.device if first is not None else torch.device("cpu")
    # zeros_like: a DTensor parameter gets DTensor moments of its placements (ZeRO)
    m = {n: torch.zeros_like(p, dtype=state_dtype, requires_grad=False)
         for n, p in params.items()}
    v = {n: t.clone() for n, t in m.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), m=m, v=v)


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    s = torch.sum(torch.square(g.to(torch.float32)))
    return s.full_tensor() if hasattr(s, "full_tensor") else s


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor: a divisor held as a tensor, since CUDA turns division
    by a Python number into a multiply by its reciprocal."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def clip_by_global_norm(
    grads: dict[str, torch.Tensor], max_norm: float
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """``(grads · min(1, max_norm / max(gn, 1e-9)), gn)``, ``gn`` the f32
    square root of the sum of the leaves' f32 squares; each leaf cast back
    to its dtype.  A DTensor leaf's sum of squares is taken over the whole
    tensor (``full_tensor``), so every rank scales by the same ``gn``."""
    gn = torch.sqrt(sum(_square_sum(g) for g in grads.values()))
    scale = torch.clamp(_scalar(max_norm, gn) / torch.clamp(gn, min=1e-9), max=1.0)
    return {n: (g.to(torch.float32) * scale).to(g.dtype) for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: AdamWState,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> tuple[dict[str, torch.Tensor], AdamWState]:
    """One AdamW step.  Each parameter is overwritten in place with
    ``p − lr·(m̂ / (√v̂ + eps) + wd·p)`` in f32, cast back to its dtype;
    ``m̂ = m / (1 − b1^t)`` and ``v̂ = v / (1 − b2^t)`` at ``t`` the new
    step.  Returns ``(params, new state)``; the new moments are new tensors
    in the state's dtype."""
    step = state.step + 1
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(_scalar(b1, sf), sf)
    c2 = 1.0 - torch.pow(_scalar(b2, sf), sf)
    m_out, v_out = {}, {}
    for n, p in params.items():
        g, m, v = grads[n], state.m[n], state.v[n]
        gf = g.to(torch.float32)
        m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
        v_new = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        m_out[n], v_out[n] = m_new.to(m.dtype), v_new.to(v.dtype)
    return params, AdamWState(step=step, m=m_out, v=v_out)
