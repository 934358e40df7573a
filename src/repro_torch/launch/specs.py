"""Stand-ins for every model input and for the train state: fake tensors
(``FakeTensorMode``), the counterpart of the reference's
``ShapeDtypeStruct`` / ``jax.eval_shape``.  They have shapes and dtypes and
no memory, so a production cell builds in a process of any size.

The modality frontends are stubs, as in the reference: whisper gets
precomputed frame embeddings, phi-3-vision precomputed patch embeddings.
Every function builds its tensors under ``mode`` (a ``FakeTensorMode``,
a new one when ``None``) on ``device``.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import decode as D
from repro_torch.models.lm import LM


def _stub_inputs(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    extra = {}
    if cfg.family == "encdec":
        extra["enc_frames"] = torch.empty((batch, cfg.enc_seq, cfg.d_model), dtype=dtype,
                                          device=device)
    if cfg.family == "vlm":
        extra["patch_embeds"] = torch.empty((batch, cfg.num_patches, cfg.d_model), dtype=dtype,
                                            device=device)
    return extra


def input_specs(cfg: ArchConfig, shape: ShapeConfig, dtype=torch.bfloat16,
                mode: FakeTensorMode | None = None, device: str = "cpu") -> dict:
    """Model-input fake tensors for one (arch × shape) cell: ``tokens`` and
    ``labels`` ``[B, S]`` int32 for a train cell, ``tokens`` for prefill,
    ``tokens [B]``, ``pos []`` and the whole decode ``cache`` for decode."""
    b, s = shape.global_batch, shape.seq_len
    with mode or FakeTensorMode():
        if shape.kind == "train":
            return {"tokens": torch.empty((b, s), dtype=torch.int32, device=device),
                    "labels": torch.empty((b, s), dtype=torch.int32, device=device),
                    **_stub_inputs(cfg, b, dtype, device)}
        if shape.kind == "prefill":
            return {"tokens": torch.empty((b, s), dtype=torch.int32, device=device),
                    **_stub_inputs(cfg, b, dtype, device)}
        if shape.kind == "decode":
            return {"tokens": torch.empty((b,), dtype=torch.int32, device=device),
                    "pos": torch.empty((), dtype=torch.int32, device=device),
                    "cache": D.init_cache(cfg, batch=b, max_seq=s, dtype=dtype, device=device)}
    raise ValueError(shape.kind)


def abstract_model(cfg: ArchConfig, param_dtype=torch.bfloat16,
                   mode: FakeTensorMode | None = None, device: str = "cpu") -> LM:
    """An :class:`LM` of fake parameters (the reference's
    ``abstract_params``)."""
    with mode or FakeTensorMode():
        return LM(cfg, device, param_dtype)


def abstract_train_state(cfg: ArchConfig, param_dtype=torch.bfloat16,
                         opt_dtype=torch.bfloat16, mode: FakeTensorMode | None = None,
                         device: str = "cpu"):
    """A fake :class:`~repro_torch.launch.steps.TrainState`: the model's
    parameters, AdamW moments in ``opt_dtype`` and the step."""
    from repro_torch.launch.steps import make_train_state

    mode = mode or FakeTensorMode()
    model = abstract_model(cfg, param_dtype, mode, device)
    with mode:
        return make_train_state(model, opt_dtype)
