"""Device idle share of the profiled stretch, in the browse mix."""
from bench.readers import device_idle_pct as read  # noqa: F401
