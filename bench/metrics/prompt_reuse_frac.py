"""Share of the window's prompt tokens served from stored segments
(``ServeStats``: reused over reused plus computed), in percent."""


def read(rec):
    c = rec["counts"]
    total = c["tokens_reused"] + c["tokens_computed"]
    return 100.0 * c["tokens_reused"] / total if total else None
