"""Rows read per record returned, in the sample mix."""
from bench.readers import rows_read_per_record as read  # noqa: F401
