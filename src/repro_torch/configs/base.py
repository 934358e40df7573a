"""Config system: architecture + run configs.

The port's own copy of ``repro/configs/base.py`` (plain data, no JAX): every
architecture is one ``src/repro_torch/configs/<id>.py`` exporting
``CONFIG: ArchConfig``; ``repro_torch.configs.get_config(name)`` resolves
them, and ``reduced()`` derives the CPU-test variant of the same family.
The tests hold these copies equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    moe_dff: int  # per-expert FFN hidden dim
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64  # SSD head dim (d_inner / n_heads)
    expand: int = 2  # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    # layer pattern, cycled over depth: 'G' global attn, 'L' local (SWA) attn,
    # 'M' mamba2 block, 'A' shared attention block (zamba). Must divide layers
    # into whole cycles for scan; a trailing partial cycle is run unscanned.
    layer_pattern: str = "G"
    attn_window: int | None = None  # SWA window for 'L' layers
    norm: Literal["rms", "ln"] = "rms"
    act: Literal["silu", "gelu"] = "silu"
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # enc-dec (whisper): encoder layers + fixed encoder sequence (stub frames)
    enc_layers: int = 0
    enc_seq: int = 0
    # vlm: number of prefix patch-embedding positions (stub frontend)
    num_patches: int = 0
    # which shapes this arch supports (decode needs a decoder; long needs
    # sub-quadratic attention — see DESIGN.md §Arch-applicability)
    supports_long_context: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab padded to a 512 multiple (TP-divisible)."""
        return -(-self.vocab // 512) * 512

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D MODEL_FLOPS and memory checks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.qkv_bias:
            attn += (nh + 2 * nkv) * hd
        mlp_dense = 3 * d * f  # SwiGLU (gate+up+down); GELU uses 2·d·f
        if self.act == "gelu":
            mlp_dense = 2 * d * f
        if self.moe:  # MoE replaces the dense MLP
            mixer_ffn = (
                self.moe.num_experts * 3 * d * self.moe.moe_dff
                + d * self.moe.num_experts  # router
            )
        else:
            mixer_ffn = mlp_dense
        ssm = 0
        if self.ssm:
            di, ds_ = self.d_inner, self.ssm.d_state
            nh_s = self.n_ssm_heads
            ssm = d * (2 * di + 2 * ds_ + nh_s) + di * d + di * self.ssm.conv_width
        total = 0
        for ch in _full_pattern(self):
            if ch in ("G", "L"):
                total += attn + mixer_ffn + 2 * d
            elif ch == "M":
                total += ssm + d
        if "A" in self.layer_pattern:  # shared attention block counted once
            total += attn + mlp_dense + 2 * d
        emb = v * d
        total += emb if self.tie_embeddings else 2 * emb
        if self.family == "encdec":
            # encoder layers + decoder cross-attention
            total += self.enc_layers * (attn + mlp_dense + 2 * d)
            total += self.num_layers * (attn + d)  # cross-attn per dec layer
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        n_moe = sum(1 for ch in _full_pattern(self) if ch in ("G", "L"))
        all_experts = n_moe * self.moe.num_experts * 3 * d * self.moe.moe_dff
        active = n_moe * self.moe.top_k * 3 * d * self.moe.moe_dff
        return int(self.param_count() - all_experts + active)


def _full_pattern(cfg: ArchConfig) -> str:
    pat = cfg.layer_pattern
    reps = -(-cfg.num_layers // len(pat))
    return (pat * reps)[: cfg.num_layers]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests (one step, no NaNs)."""
    pat_unit = cfg.layer_pattern
    layers = max(len(pat_unit), 2)
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = max(kv, 4) if cfg.num_heads >= 4 else cfg.num_heads
    # keep heads a multiple of kv for GQA
    heads = (heads // kv) * kv or kv
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=128,
        vocab=512,
        moe=dataclasses.replace(cfg.moe, num_experts=min(cfg.moe.num_experts, 4), top_k=min(cfg.moe.top_k, 2), moe_dff=64) if cfg.moe else None,
        ssm=dataclasses.replace(cfg.ssm, d_state=16, head_dim=16) if cfg.ssm else None,
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq=min(cfg.enc_seq, 32) if cfg.enc_seq else 0,
        num_patches=min(cfg.num_patches, 8),
        attn_window=min(cfg.attn_window, 16) if cfg.attn_window else None,
    )
