"""The analytics tables, made from the seed on the card in float32.

The paper's synthesizer (arXiv:1509.05066 §6 "Data"): features from a
random-covariance Gaussian (identity blended with a random rotation, so the
features depend on each other) and targets from a planted linear model plus
noise, or class labels with per-class Gaussian centres.  A copy of the
port's ``data/synthetic.py`` (``make_regression``, ``make_classification``)
that draws with a ``torch.Generator`` on the device, in the float32 the
tables are served in, and hands back host arrays: a 5M-row table takes a
fraction of a second.
"""
from __future__ import annotations

import numpy as np
import torch


def _mixing(gen: torch.Generator, d: int, dependency: float, device) -> torch.Tensor:
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=gen, device=device,
                                       dtype=torch.float64))
    eye = torch.eye(d, device=device, dtype=torch.float64)
    return ((1.0 - dependency) * eye + dependency * q).float()


def regression(gen: torch.Generator, n: int, d: int, *, noise: float = 0.5,
               dependency: float = 0.3) -> tuple[np.ndarray, np.ndarray]:
    dev = gen.device
    m = _mixing(gen, d, dependency, dev)
    w = torch.randn(d, generator=gen, device=dev)
    X = torch.randn((n, d), generator=gen, device=dev) @ m
    y = X @ w + noise * torch.randn(n, generator=gen, device=dev)
    return X.cpu().numpy(), y.cpu().numpy()


def classification(gen: torch.Generator, n: int, d: int, *, classes: int = 2,
                   sep: float = 1.5, dependency: float = 0.3) -> tuple[np.ndarray, np.ndarray]:
    dev = gen.device
    m = _mixing(gen, d, dependency, dev)
    centers = torch.randn((classes, d), generator=gen, device=dev) * sep
    y = torch.randint(0, classes, (n,), generator=gen, device=dev, dtype=torch.int32)
    X = (centers[y.long()] + torch.randn((n, d), generator=gen, device=dev)) @ m
    return X.cpu().numpy(), y.cpu().numpy()
