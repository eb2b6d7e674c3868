from .loop import TrainState, make_train_step
from .optim import adafactor, adamw, clip_by_global_norm, warmup_cosine

__all__ = [
    "TrainState",
    "adafactor",
    "adamw",
    "clip_by_global_norm",
    "make_train_step",
    "warmup_cosine",
]
