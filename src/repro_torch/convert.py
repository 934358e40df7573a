"""State carried across from the JAX package.

:func:`store_from_reference` builds the port's :class:`BlockStore` and
DensityMap index from the numpy arrays of a reference store, so both
packages answer the same queries on the same bytes.  The caller does the
``np.asarray`` on the reference side; this module imports nothing of it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.density_map import DensityMapIndex, PredicateVocab
from repro_torch.data.block_store import BlockStore
from repro_torch.device import resolve_device

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
