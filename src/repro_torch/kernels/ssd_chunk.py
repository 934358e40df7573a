"""Mamba2 SSD (state-space duality) chunked scan.

Counterpart of ``repro/kernels/ssd_chunk.py``.  The recurrence
``h_t = a_t·h_{t-1} + B_t ⊗ u_t``, ``y_t = C_t·h_t`` (``a_t = exp(ld_t)``) is
evaluated a chunk of :data:`CHUNK` steps at a time:

    ca      = inclusive cumsum of the chunk's log-decays
    y_intra = (C Bᵀ ⊙ L) U,        L[t, s] = exp(ca_t − ca_s)·1[s ≤ t]
    y_inter = exp(ca) ⊙ (C H)
    H      <- exp(ca_last)·H + (exp(ca_last − ca) ⊙ B)ᵀ U

On CUDA :func:`ssd_scan` is the kernel in ``csrc/ssd_chunk.cu``: one call
runs three CUDA kernels (chunk states, the state pass across chunks, chunk
outputs; every product on the tensor cores in 3xTF32) and counts as one
launch.  On the CPU it is :func:`ssd_chunked`, the reference's pure-tensor
chunked form (``repro/models/layers.py``), which ``impl="plain"`` also runs.
``ca`` is summed in another order than the TPU kernel's triangular matmul,
so results agree to f32 rounding: the tests hold them at the reference's
``atol=2e-3, rtol=1e-2``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

CHUNK = 128
# the kernel's limits: ds and dh are the MMA's n and k, multiples of 8; its
# output phase holds C, B and the state (then U) in shared memory (135.5 KB
# at ds = 128) and an accumulator of 8 × 8 columns a warp row (dh <= 64)
MAX_DS = 128
MAX_DH = 64
MMA_STEP = 8


def decay_matrix(ca: torch.Tensor) -> torch.Tensor:
    """``L[..., t, s] = exp(ca_t − ca_s)·1[s ≤ t]`` over the last axis of
    ``ca``.  The reference multiplies ``exp`` of the full square by the
    triangle; above the diagonal ``ca_t − ca_s`` is the decay of steps
    (t, s] negated, which passes 88 within a chunk of 128 identical tokens
    (a long left padding) and makes ``inf·0 = NaN``.  Here the upper
    triangle is masked before ``exp``: the same values wherever the
    reference's are finite, and 0 instead of NaN elsewhere."""
    n = ca.shape[-1]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool, device=ca.device), diagonal=1)
    return torch.exp((ca[..., :, None] - ca[..., None, :]).masked_fill(upper, float("-inf")))


def ssd_chunked(
    u: torch.Tensor,  # [B, H, S, dh] (dt-scaled inputs)
    ldecay: torch.Tensor,  # [B, H, S]
    bmat: torch.Tensor,  # [B, H, S, ds]
    cmat: torch.Tensor,  # [B, H, S, ds]
    chunk: int,
    return_state: bool = False,
):
    """The reference's pure-tensor chunked SSD (every chunk's intra-chunk
    term at once, then the state carried across chunks), on any device."""
    b, h, s, dh = u.shape
    ds_ = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"pad the sequence to a multiple of {chunk}")
    nc = s // chunk

    def rs(t):
        return t.reshape(b, h, nc, chunk, *t.shape[3:])

    uc, ldc, bc, cc = rs(u), rs(ldecay), rs(bmat), rs(cmat)
    ca = torch.cumsum(ldc, dim=-1)  # [B, H, nc, Q]
    L = decay_matrix(ca)
    scores = torch.einsum("bhnts,bhnqs->bhntq", cc, bc) * L
    # a bf16 operand meets an f32 one: promoted to f32, as jnp.einsum does
    # (a no-op on f32 operands)
    y_intra = torch.einsum("bhntq,bhnqd->bhntd", scores, uc.to(scores.dtype))
    # carried state across chunks
    wb = torch.exp(ca[..., -1:] - ca)[..., None] * bc  # [B,H,nc,Q,ds]
    h_chunk = torch.einsum("bhnqs,bhnqd->bhnsd", wb, uc.to(wb.dtype))  # state injected per chunk
    decay = torch.exp(ca[..., -1])  # [B,H,nc]
    hprev = torch.zeros((b, h, ds_, dh), dtype=torch.float32, device=u.device)
    hprevs = []  # hprevs[n] = state before chunk n
    for n in range(nc):
        hprevs.append(hprev)
        hprev = decay[:, :, n, None, None] * hprev + h_chunk[:, :, n]
    hprevs = torch.stack(hprevs, dim=2)  # [B,H,nc,ds,dh]
    y_inter = torch.exp(ca)[..., None] * torch.einsum("bhnts,bhnsd->bhntd",
                                                      cc.to(hprevs.dtype), hprevs)
    y = (y_intra + y_inter).reshape(b, h, s, dh)
    if return_state:
        return y.to(u.dtype), hprev
    return y.to(u.dtype)


def _check_bc(name: str, t: torch.Tensor, shape: tuple, dev: torch.device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"ssd_scan: {name} must be a float32 tensor of shape {shape}")
    if t.device != dev:
        raise ValueError(f"ssd_scan: tensors on {t.device} and {dev}")
    if t.stride(3) != 1 or t.stride(2) != shape[3]:
        raise ValueError(f"ssd_scan: {name} needs contiguous (S, ds) rows")


@_lib.no_gradient
def ssd_scan(
    u: torch.Tensor,  # [B, H, S, dh] f32
    ldecay: torch.Tensor,  # [B, H, S] f32
    bmat: torch.Tensor,  # [B, H, S, ds] f32
    cmat: torch.Tensor,  # [B, H, S, ds] f32
    return_state: bool = False,
):
    """``y [B, H, S, dh]``, with ``return_state`` ``(y, h_final [B, H, ds,
    dh] f32)``, the state after the last step, as ``ssd_chunked(...,
    return_state=True)`` returns them.  S must be a multiple of
    :data:`CHUNK` (pad upstream, as the reference does).

    ``bmat`` and ``cmat`` are read through their batch and head strides:
    ``mamba_block`` hands over its ``[B, S, ds]`` projections expanded to
    every head (head stride 0), and the kernel reads them so, without
    materialising ``H`` copies.  Only their ``(S, ds)`` rows must be
    contiguous."""
    if u.dim() != 4 or ldecay.dim() != 3 or bmat.dim() != 4 or cmat.dim() != 4:
        raise ValueError("ssd_scan takes u [B, H, S, dh], ldecay [B, H, S], B and C [B, H, S, ds]")
    b, h, s, dh = u.shape
    ds = bmat.shape[-1]
    if tuple(ldecay.shape) != (b, h, s) or s % CHUNK:
        raise ValueError(f"ssd_scan: ldecay must be [B, H, S] and S a multiple of {CHUNK}")
    if all(t.device.type == "cpu" for t in (u, ldecay, bmat, cmat)):
        return ssd_chunked(u, ldecay, bmat, cmat, CHUNK, return_state=return_state)
    _lib.require_cuda("ssd_scan", u, ldecay)
    if u.dtype != torch.float32 or ldecay.dtype != torch.float32:
        raise ValueError("ssd_scan: u and ldecay must be float32")
    _check_bc("B", bmat, (b, h, s, ds), u.device)
    _check_bc("C", cmat, (b, h, s, ds), u.device)
    if not (dh % MMA_STEP == 0 and 0 < dh <= MAX_DH and ds % MMA_STEP == 0 and 0 < ds <= MAX_DS):
        raise ValueError(f"ssd_scan: the kernel takes dh, ds multiples of {MMA_STEP} with "
                         f"dh <= {MAX_DH}, ds <= {MAX_DS}; got dh={dh}, ds={ds}")
    y = torch.empty_like(u)
    state = (torch.empty((b, h, ds, dh), dtype=torch.float32, device=u.device)
             if return_state else None)
    if y.numel() == 0:  # no steps: the state stays at its start, 0
        return (y, state.zero_()) if return_state else y
    nc = s // CHUNK
    # chunk states, overwritten by each chunk's incoming state; chunk decays
    scratch = torch.empty((b, h, nc, ds, dh), dtype=torch.float32, device=u.device)
    decays = torch.empty((b, h, nc), dtype=torch.float32, device=u.device)
    lib = _lib.load()
    with torch.cuda.device(u.device):
        rc = lib.nt_ssd_scan(
            u.data_ptr(), ldecay.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            y.data_ptr(), None if state is None else state.data_ptr(), scratch.data_ptr(),
            decays.data_ptr(), b, h, s, dh, ds, bmat.stride(0), bmat.stride(1),
            cmat.stride(0), cmat.stride(1), _lib.stream_of(u),
        )
    _lib.launched("ssd_scan", rc)
    return (y, state) if return_state else y
