"""95th percentile of a query's milliseconds in the window: the harness's
host span around ``IncrementalAnalyticsEngine.query``, which returns with
the model on the host."""
from bench.core import percentile


def read(rec):
    return percentile(rec["samples"]["query_ms"], 95)
