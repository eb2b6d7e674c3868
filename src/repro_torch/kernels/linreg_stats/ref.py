"""Plain PyTorch versions of the fused linear-regression statistics kernel."""
from __future__ import annotations

import torch


def linreg_stats_ref(X: torch.Tensor, y: torch.Tensor):
    """``A = XᵀX`` (d,d), ``B = Xᵀy`` (d,) and ``yᵀy`` (0-d), fp32
    accumulation (the inputs are widened to fp32 first)."""
    Xf = X.float()
    yf = y.float()
    return Xf.T @ Xf, Xf.T @ yf, yf @ yf


def zt_z_ref(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``G = [X | y]ᵀ[X | y]`` (d+1, d+1) fp32, assembled from
    :func:`linreg_stats_ref`'s A, B and yᵀy, so its blocks are bitwise
    theirs."""
    A, B, yty = linreg_stats_ref(X, y)
    d = A.shape[0]
    G = torch.empty((d + 1, d + 1), dtype=torch.float32, device=A.device)
    G[:d, :d] = A
    G[:d, d] = B
    G[d, :d] = B
    G[d, d] = yty
    return G


def zt_z_split(X: torch.Tensor, y: torch.Tensor, splits: int,
               rows_per_split: int) -> torch.Tensor:
    """The kernel's reduction in plain form: one fp32 partial
    ``Z_kᵀZ_k`` per row split k (rows ``[k·rows, (k+1)·rows)``), summed in
    split order 0, 1, 2, … in fp32."""
    Z = torch.cat([X.float(), y.float()[:, None]], 1)
    G = torch.zeros((Z.shape[1], Z.shape[1]), dtype=torch.float32, device=Z.device)
    for k in range(splits):
        Zk = Z[k * rows_per_split:(k + 1) * rows_per_split]
        G = G + Zk.T @ Zk
    return G
