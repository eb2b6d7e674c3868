"""Share of the traced window in which no operation ran on the card, in
percent (the profiler's device intervals, their union)."""


def read(rec):
    s = rec.get("summary") or {}
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s.get("window_s") else None
