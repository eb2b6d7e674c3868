"""Share of the window's queries whose chosen plan reads a stored model, in
percent."""


def read(rec):
    c = rec["counts"]
    return 100.0 * c["reused"] / c["queries"] if c["queries"] else None
