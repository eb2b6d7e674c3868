"""Rows per decode call over the window (``SchedulerStats``: decode rows
over decode calls): how many sessions share one read of the weights."""


def read(rec):
    c = rec["counts"]
    return c["decode_rows"] / c["decode_calls"] if c["decode_calls"] else None
