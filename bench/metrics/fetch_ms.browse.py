"""Ms a round's union fetch and record copy take, in the browse mix."""
from bench.readers import fetch_ms as read  # noqa: F401
