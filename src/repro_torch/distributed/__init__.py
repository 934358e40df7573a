"""Sharding rules over a ``DeviceMesh`` (counterpart of ``repro/distributed``)."""
from repro_torch.distributed.sharding import (
    batch_spec,
    cache_specs,
    make_rules,
    param_specs,
    train_state_specs,
)

__all__ = [
    "batch_spec", "cache_specs", "make_rules", "param_specs", "train_state_specs",
]
