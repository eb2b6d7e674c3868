"""Shared kernel utilities: padding, bucketing and device routing.

Routing rule of the port: a kernel wrapper decides by the device of the
tensor it is given, and by nothing else.  A CUDA tensor goes to the
hand-written Hopper kernel (and the wrapper raises if the card is older
than compute capability 9.0, if the kernel fails to build, or if the
launch fails); a CPU tensor goes to the kernel's plain PyTorch version.
There is no fallback from one to the other and no switch that overrides
the rule.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def cdiv(x: int, m: int) -> int:
    return (x + m - 1) // m


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def bucket_len(x: int, bucket: int, *, floor: int = 1) -> int:
    """Pad-to-bucket length: smallest bucket multiple ≥ max(x, floor).

    Serving pads caches to a bucketed capacity so the set of shapes the
    kernels and the store see stays small and reusable.
    """
    return round_up(max(x, floor), bucket)


def pad_axis(x: torch.Tensor, axis: int, target: int, value: float = 0.0):
    """Pad ``x`` with ``value`` along ``axis`` up to length ``target``."""
    cur = x.shape[axis]
    if cur == target:
        return x
    axis = axis % x.ndim
    pads = [0, 0] * (x.ndim - axis - 1) + [0, target - cur]
    return F.pad(x, pads, value=value)


def uses_kernel(x: torch.Tensor) -> bool:
    """True when ``x`` lives on a CUDA device and must go to the kernel.

    Raises on a CUDA device below compute capability 9.0: the kernels are
    built for ``sm_90a`` only.  CPU tensors return False (plain version).
    """
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel route for device {x.device}")
    cap = torch.cuda.get_device_capability(x.device)
    if cap < (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(x.device)} has compute capability "
            f"{cap[0]}.{cap[1]}; the port's kernels need 9.0 (Hopper)")
    return True


def to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """A kernel's small results as float64 numpy arrays, in one copy (which
    also waits for the device, so the caller's clock times real work)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].astype(np.float64).reshape(t.shape))
        at += t.numel()
    return out
