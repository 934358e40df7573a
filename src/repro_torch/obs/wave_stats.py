"""One ``last_wave_stats`` schema for every serving pool.

Counterpart of ``repro/obs/wave_stats.py``.  :func:`make_wave_stats` gives
every wave ledger **all** the keys of :data:`WAVE_STATS_KEYS`, with
defaults for what a pool cannot measure (``None`` for an absent subsystem:
tiers on a flat cache, prefetch when off, ``plan_qerror`` without a ledger;
zeros for counts).  An unknown key raises, so the schema cannot fork.
:func:`record_wave_metrics` mirrors a wave into a
:class:`~repro_torch.obs.metrics.MetricsRegistry` under ``wave.<kind>.*``.
"""
from __future__ import annotations

from repro_torch.obs.metrics import MetricsRegistry

#: The closed key set of every ``last_wave_stats`` dict, all pools.
WAVE_STATS_KEYS: tuple[str, ...] = (
    "kind",                  # "exemplar" | "lm" | "aggregate"
    "wave_size",             # active slots this round
    "rounds",                # refill rounds executed (1 per continuous tick)
    "device_transfers",      # packed device→host plan transfers this wave
    "store_blocks_fetched",  # blocks read from the store this wave
    "cache_hits",            # block reads served from the cache this wave
    "unique_blocks",         # first-touched unique blocks this wave
    "tiers",                 # per-tier placement delta dict, None on a flat cache
    "slot_occupancy",        # busy-slot fraction per round
    "modeled_store_io_s",    # modeled cost of this wave's demand store reads
    "pending",               # requests still queued in admission after the wave
    "prefetch",              # PrefetchStats snapshot, None when off
    "plan_qerror",           # running placement q-error, None without a ledger
    "answered",              # aggregate answer records (rid/reason/...), [] else
)

_DEFAULTS = {
    "wave_size": 0, "rounds": 0, "device_transfers": 0,
    "store_blocks_fetched": 0, "cache_hits": 0, "unique_blocks": 0,
    "tiers": None, "slot_occupancy": 0.0, "modeled_store_io_s": 0.0,
    "pending": 0, "prefetch": None, "plan_qerror": None,
}


def make_wave_stats(kind: str, **values) -> dict:
    """A schema-complete wave-stats dict for pool ``kind``; unspecified keys
    take their defaults, unknown keys raise."""
    stats = {"kind": kind, **_DEFAULTS, "answered": []}  # WAVE_STATS_KEYS order
    unknown = set(values) - set(stats)
    if unknown:
        raise ValueError(f"unknown wave-stats keys: {sorted(unknown)}")
    stats.update(values)
    return stats


def record_wave_metrics(metrics: MetricsRegistry, stats: dict) -> None:
    """Mirror one wave ledger into the registry (``wave.<kind>.*``)."""
    p = f"wave.{stats['kind']}"
    metrics.inc(f"{p}.waves")
    metrics.inc(f"{p}.rounds", stats["rounds"])
    metrics.inc(f"{p}.device_transfers", stats["device_transfers"])
    metrics.inc(f"{p}.store_blocks_fetched", stats["store_blocks_fetched"])
    metrics.inc(f"{p}.cache_hits", stats["cache_hits"])
    metrics.inc(f"{p}.unique_blocks", stats["unique_blocks"])
    metrics.observe(f"{p}.wave_size", stats["wave_size"])
    metrics.observe(f"{p}.modeled_store_io_s", stats["modeled_store_io_s"])
    metrics.set_gauge(f"{p}.slot_occupancy", stats["slot_occupancy"])
    metrics.set_gauge(f"{p}.pending", stats["pending"])
    if stats["plan_qerror"] is not None:
        metrics.observe(f"{p}.plan_qerror", stats["plan_qerror"])
    if stats["tiers"]:
        for k, v in stats["tiers"].items():
            metrics.inc(f"tiers.{k}", v)
    if stats["prefetch"]:
        metrics.absorb("prefetch", stats["prefetch"])
