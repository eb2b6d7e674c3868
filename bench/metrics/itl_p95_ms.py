"""95th percentile of every gap between consecutive output tokens of one
request, both inside the window, over all requests."""
from bench.core import percentile


def read(rec):
    return percentile(rec["samples"]["itl_ms"], 95)
