"""Plain PyTorch version of the fused linear-regression statistics kernel."""
from __future__ import annotations

import torch


def linreg_stats_ref(X: torch.Tensor, y: torch.Tensor):
    """``A = XᵀX`` (d,d), ``B = Xᵀy`` (d,) and ``yᵀy`` (0-d), fp32
    accumulation (the inputs are widened to fp32 first)."""
    Xf = X.float()
    yf = y.float()
    return Xf.T @ Xf, Xf.T @ yf, yf @ yf
