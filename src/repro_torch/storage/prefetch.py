"""Demand I/O pricing under the engine's cache state.

Counterpart of ``repro/storage/prefetch.py``, reduced to
:func:`effective_block_cost` on an engine with the flat block cache.  The
``TierStack`` branch, the prefetcher and the residency probes arrive with
the tiered-storage slice of the port.
"""
from __future__ import annotations

import numpy as np

_TIERS = "tiered storage (TierStack) arrives with the tiered-storage slice of the port"


def effective_block_cost(engine, block_ids) -> float:
    """Modeled demand I/O of reading ``block_ids`` now: the blocks the
    engine's flat block cache does not hold, priced by its cost model
    (§4.1 ascending order).  0.0 for no blocks or a fully cached set."""
    ids = np.asarray(block_ids, dtype=np.int64)
    if ids.size == 0:
        return 0.0
    cache = engine.block_cache
    if hasattr(cache, "effective_io_time") and hasattr(cache, "residency_tier"):
        raise NotImplementedError(_TIERS)
    missed = np.asarray([int(b) for b in ids if int(b) not in cache], dtype=np.int64)
    return float(engine.cost.io_time(missed))
