"""Model FLOPs of every token prefilled, extended or decoded in the traced
window (``bench/work.py``, from the model's entry points as the scheduler
called them), over the traced seconds at the card's 989 TFLOP/s bf16, in
percent."""
from bench import work


def read(rec):
    s = rec.get("summary") or {}
    if not rec.get("model_flops") or not s.get("window_s"):
        return None
    return 100.0 * rec["model_flops"] / (s["window_s"] * work.PEAK_FLOPS["bf16"])
