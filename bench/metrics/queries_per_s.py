"""Queries completed inside the window, each with its model on the host,
over the window's seconds (the paper's workload time T, inverted)."""
from bench.core import rate


def read(rec):
    return rate(rec["counts"]["queries"], rec["window_s"])
