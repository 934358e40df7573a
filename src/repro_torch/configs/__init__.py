"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()`` (a copy of
``repro/configs/__init__.py``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, reduced

_ARCH_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "grok-1-314b": "grok_1_314b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "yi-9b": "yi_9b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "gemma3-12b": "gemma3_12b",
    "qwen1.5-4b": "qwen1_5_4b",
    "zamba2-7b": "zamba2_7b",
    "mamba2-130m": "mamba2_130m",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def shape_supported(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell (DESIGN.md §Arch-applicability)."""
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, "SKIP(full-attn): 500k decode needs sub-quadratic attention"
    if shape.kind == "decode" and cfg.family == "encdec" and cfg.num_layers == 0:
        return False, "SKIP(encoder-only)"
    return True, ""


__all__ = [
    "ArchConfig", "SHAPES", "ShapeConfig", "get_config", "list_archs",
    "reduced", "shape_supported",
]
