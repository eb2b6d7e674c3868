"""Plain PyTorch version of the Naive Bayes grouped-statistics kernel."""
from __future__ import annotations

import torch


def nb_stats_ref(X: torch.Tensor, y: torch.Tensor, n_classes: int):
    """Per-class ``N_c`` (C,), ``S_jc`` (C,d), ``SS_jc`` (C,d), fp32.

    A one-hot product, as ``repro``'s oracle computes it; rows whose label
    lies outside ``[0, C)`` match no class.
    """
    Xf = X.float()
    y = y.long()
    valid = (y >= 0) & (y < n_classes)
    onehot = torch.nn.functional.one_hot(torch.where(valid, y, 0), n_classes)
    onehot = (onehot * valid[:, None]).float()
    return onehot.sum(0), onehot.T @ Xf, onehot.T @ (Xf * Xf)


def grouped_stats_ref(X: torch.Tensor, y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """``G = [N_c | S_c | SS_c]`` (C, 1 + 2d) fp32, assembled from
    :func:`nb_stats_ref`'s three results, so its blocks are bitwise theirs."""
    counts, S, SS = nb_stats_ref(X, y, n_classes)
    return torch.cat([counts[:, None], S, SS], 1)


def grouped_stats_split(X: torch.Tensor, y: torch.Tensor, n_classes: int,
                        splits: int, rows_per_split: int) -> torch.Tensor:
    """The kernel's reduction in plain form: one fp32 partial G per row split
    k (rows ``[k·rows, (k+1)·rows)``), summed in split order 0, 1, 2, … in
    fp32."""
    G = torch.zeros((n_classes, 1 + 2 * X.shape[1]), dtype=torch.float32, device=X.device)
    for k in range(splits):
        rows = slice(k * rows_per_split, (k + 1) * rows_per_split)
        G = G + grouped_stats_ref(X[rows], y[rows], n_classes)
    return G
