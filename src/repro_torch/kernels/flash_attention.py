"""Tiled online-softmax attention (flash attention).

Counterpart of ``repro/kernels/flash_attention.py``: causal and
sliding-window masks, GQA (q head ``h`` reads kv head ``h // (Hq / Hkv)``),
queries right-aligned to the end of the kv sequence (``q_pos = i + T − S``),
masked logits at −1e30.

On CUDA :func:`flash_attention` is the kernel in ``csrc/flash_attention.cu``
(FlashAttention-2 on the tensor cores: one block of 4 warps per (batch,
q head, 64-row q tile), each warp's 16 rows, softmax state and output in
registers, the kv tiles of 32 keys walked in order through a two-stage
``cp.async`` ring; every product in 3xTF32, f32-class accuracy; any head
dim D >= 1, as the TPU kernel, in column groups of 256 past 256); on the
CPU it is
:func:`attention_plain`, a port of the reference oracle
``repro/kernels/ref.py`` ``attention_ref``: the full softmax over the masked
logits, which the kernel's tiling and kv padding do not change.  The kernel
adds in another order and splits each f32 product into three TF32 ones, so
results agree to rounding: the tests hold f32 at 2e-3, the reference's own
tolerance (``tests/test_torch_tf32.py`` pins the split's arithmetic at
1e-5).  In bf16 the kernel sums the bf16 values in f32 and rounds only its
output, so the card's checks hold it against this version on the same
values upcast to f32, to one bf16 ulp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def attention_plain(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, T, D]
    v: torch.Tensor,  # [B, Hkv, T, D]
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version (``attention_ref``); any device."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    kk = torch.repeat_interleave(k, g, dim=1)
    vv = torch.repeat_interleave(v, g, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q, kk).to(torch.float32) * scale
    t = kk.shape[2]
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)  # right-aligned
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask[None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p.to(vv.dtype), vv)


@_lib.no_gradient
def flash_attention(
    q: torch.Tensor,  # [B, Hq, S, D] f32 or bf16
    k: torch.Tensor,  # [B, Hkv, T, D]
    v: torch.Tensor,  # [B, Hkv, T, D]
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """``o [B, Hq, S, D]`` in q's dtype; f32 accumulation."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B, Hq, S, D], k and v [B, Hkv, T, D]")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, t, d) or tuple(v.shape) != (b, hkv, t, d):
        raise ValueError("flash_attention: k and v must both be [B, Hkv, T, D]")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of Hkv={hkv}")
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return attention_plain(q, k, v, causal, window, scale)
    _lib.require_cuda("flash_attention", q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must all be float32 or all bfloat16")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if d < 1 or t < 1:
        raise ValueError(f"flash_attention: the kernel takes D >= 1 and T >= 1; got D={d}, T={t}")
    scale = scale if scale is not None else 1.0 / (d**0.5)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = _lib.load()
    with torch.cuda.device(q.device):
        rc = lib.nt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hkv, s, t, d,
            int(causal), -1 if window is None else int(window), float(scale),
            int(q.dtype == torch.bfloat16), _lib.stream_of(q),
        )
    _lib.launched("flash_attention", rc)
    return o
