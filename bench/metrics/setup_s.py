"""Seconds from the process's start to the window's: loading, drawing the
weights or tables, building kernels, set-up the traffic needs, warm-up."""


def read(rec):
    return rec["setup_s"]
