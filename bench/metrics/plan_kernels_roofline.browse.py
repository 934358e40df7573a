"""Roofline share of the plan kernels #2, #5, #6, in the browse mix."""
from bench.readers import plan_kernels_roofline as read  # noqa: F401
