"""90th percentile of time to first token over every request whose first
token reached its user inside the window: from when the request was due to
when the scheduler step that produced the token returned."""
from bench.core import percentile


def read(rec):
    return percentile(rec["samples"]["ttft_ms"], 90)
