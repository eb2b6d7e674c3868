"""Mean milliseconds the planner took per query (``Plan.optimizer_seconds``)."""
from bench.core import mean


def read(rec):
    return mean(rec["samples"]["planner_ms"])
