"""Host milliseconds the planner spent per request submitted in the window
(``ServeStats.planner_s``)."""


def read(rec):
    c = rec["counts"]
    return c["planner_s"] * 1e3 / c["requests"] if c["requests"] else None
