"""Bytes copied to the host per record extracted, in the sample mix."""
from bench.host_steps import d2h_bytes_per_record as read  # noqa: F401
