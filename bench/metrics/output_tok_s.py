"""Output tokens that reached their users inside the window, over the
window's seconds."""
from bench.core import rate


def read(rec):
    return rate(rec["counts"]["output_tokens"], rec["window_s"])
