"""Rows read per record returned, in the browse mix."""
from bench.readers import rows_read_per_record as read  # noqa: F401
