"""Mean base-table rows a query's plan scanned (``Plan.base_points``)."""
from bench.core import mean


def read(rec):
    return mean(rec["samples"]["rows_scanned"])
