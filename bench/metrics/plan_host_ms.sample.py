"""Ms a device plan round's host choice takes (``plan.choose``), in the sample mix."""
from bench.host_steps import plan_host_ms as read  # noqa: F401
