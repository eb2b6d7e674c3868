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
