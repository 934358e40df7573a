"""Roofline share of the union gather #7, in the sample mix."""
from bench.readers import block_gather_roofline as read  # noqa: F401
