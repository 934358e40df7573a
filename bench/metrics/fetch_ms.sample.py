"""Ms a round's union fetch and record copy take, in the sample mix."""
from bench.readers import fetch_ms as read  # noqa: F401
