"""Ms a round's record extraction takes (``wave.records``), in the sample mix."""
from bench.host_steps import record_ms as read  # noqa: F401
