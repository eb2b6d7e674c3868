"""Command-line entry points of the port: serving, analytics and training."""
from __future__ import annotations

import torch


def resolve_device(name: str, prog: str) -> torch.device:
    """The torch device a command line asked for; exits with a hint to pass
    ``--device cpu`` where CUDA is asked for and no card is available."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"{prog}: no CUDA device is available; pass "
            "--device cpu to run the port on the CPU")
    return device
