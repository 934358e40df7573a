"""State carried across from the JAX package.

:func:`store_from_reference` builds the port's :class:`BlockStore` and
DensityMap index from the numpy arrays of a reference store, so both
packages answer the same queries on the same bytes;
:func:`lm_params_from_reference` builds the port's :class:`LM` from a
reference parameter tree, so both packages compute the same function;
:func:`cost_model_from_reference` carries a reference ``CostModel``'s
numbers, so both packages price and place with the same presets.  The
caller does the ``np.asarray`` on the reference side; this module imports
nothing of it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost_model import CostModel
from repro_torch.core.density_map import DensityMapIndex, PredicateVocab
from repro_torch.data.block_store import BlockStore
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM

#: the arrays a reference store hands over
REFERENCE_ARRAYS = (
    "dims", "measures", "valid_rows", "densities", "sorted_block_ids",
    "sorted_densities", "attr_offsets", "attr_cards",
)


def store_from_reference(
    arrays: Mapping[str, np.ndarray],
    records_per_block: int,
    num_records: int,
    device: str | torch.device = "cuda",
) -> BlockStore:
    """``arrays`` holds :data:`REFERENCE_ARRAYS`: the reference store's
    ``dims [λ, R, r]`` int32, ``measures [λ, R, s]`` f32, ``valid_rows
    [λ, R]`` bool, its index's ``densities`` / ``sorted_block_ids`` /
    ``sorted_densities`` ``[rows, λ]`` and its vocab's ``attr_offsets`` /
    ``attr_cards``."""
    missing = [k for k in REFERENCE_ARRAYS if k not in arrays]
    if missing:
        raise KeyError(f"missing reference arrays: {missing}")
    dev = resolve_device(device)

    def t(name: str, dtype) -> torch.Tensor:
        # a copy: the reference hands over read-only buffers
        return torch.from_numpy(np.array(arrays[name], dtype=dtype)).to(dev)

    index = DensityMapIndex(
        vocab=PredicateVocab(
            attr_offsets=np.asarray(arrays["attr_offsets"], dtype=np.int64),
            attr_cards=np.asarray(arrays["attr_cards"], dtype=np.int64),
        ),
        densities=t("densities", np.float32),
        sorted_block_ids=t("sorted_block_ids", np.int32),
        sorted_densities=t("sorted_densities", np.float32),
        records_per_block=records_per_block,
        num_records=num_records,
    )
    return BlockStore(
        dims=t("dims", np.int32),
        measures=t("measures", np.float32),
        valid_rows=t("valid_rows", bool),
        index=index,
        records_per_block=records_per_block,
        num_records=num_records,
    )


@torch.no_grad()
def lm_params_from_reference(params_np: Mapping, cfg: ArchConfig,
                             device: str | torch.device = "cuda") -> LM:
    """The port's :class:`LM` holding a reference parameter tree
    (``repro.models.init_params``'s dicts and lists, leaves handed over as
    numpy arrays).  ``params["cycles"]`` holds one dict per pattern position
    with leaves stacked ``[n_cycles, ...]``: cycle ``c``'s position ``i``
    becomes layer ``c·len(pattern) + i``.  ``params["rest"]`` fills the
    trailing partial cycle, ``params["shared_attn"]`` the shared block.
    Every parameter of the model must be filled exactly once."""
    model = LM(cfg, device, torch.float32)
    filled: set[int] = set()

    def put(module, tree: Mapping, index=None) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                put(getattr(module, name), leaf, index)
                continue
            param = getattr(module, name)
            arr = np.asarray(leaf if index is None else leaf[index])
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{name}: reference shape {arr.shape}, port {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)).to(param.dtype))
            if id(param) in filled:
                raise ValueError(f"{name} filled twice")
            filled.add(id(param))

    top = {k: v for k, v in params_np.items() if k in ("embed", "final_norm", "lm_head")}
    put(model, top)
    period = len(cfg.layer_pattern)
    n_cycles = cfg.num_layers // period
    for i, sub in enumerate(params_np.get("cycles", [])):
        for c in range(n_cycles):
            put(model.layers[c * period + i], sub, c)
    for i, sub in enumerate(params_np.get("rest", [])):
        put(model.layers[n_cycles * period + i], sub)
    if "shared_attn" in params_np:
        put(model.shared_attn, params_np["shared_attn"])
    missing = [n for n, p in model.named_parameters() if id(p) not in filled]
    if missing:
        raise ValueError(f"the reference tree left {missing} unfilled")
    return model


def cost_model_from_reference(model) -> CostModel:
    """The port's :class:`CostModel` with a reference model's name, costs,
    plateau and curve (a numpy function of the distance, taken as it is)."""
    return CostModel(
        name=str(model.name), seq_cost=float(model.seq_cost), max_dist=int(model.max_dist),
        far_cost=float(model.far_cost), curve=model.curve,
        first_block_cost=float(model.first_block_cost),
    )
