"""Host ms a device plan round takes, in the browse mix."""
from bench.readers import plan_ms as read  # noqa: F401
