"""Mean milliseconds of one ``SessionManager.step`` in the window (the
harness's host span around each call, which ends in the step's own wait for
its tokens)."""
from bench.core import mean


def read(rec):
    return mean(rec["samples"]["step_ms"])
