"""Public wrappers for the Naive Bayes grouped-statistics kernel.

``repro``'s wrapper pads X to 128 lanes and the rows to the block with
class −1; the CUDA kernel reads X and y in place and needs neither.
``grouped_stats`` returns the kernel's ``G = [N_c | S_c | SS_c]`` itself
(what the analytics path copies to the host, once); ``nb_stats`` slices
counts, S and SS out of it.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:mod:`.ref`); see :mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import WORK, uses_kernel

from .kernel import grouped_stats_cuda
from .ref import grouped_stats_ref, nb_stats_ref


def _labels(y):
    return y if y.dtype == torch.int32 else y.to(torch.int32)


def _contiguous(t):
    return t if t.is_contiguous() else t.contiguous()


def grouped_work(X, y, n_classes: int) -> tuple:
    """(FLOPs, bytes) of one call.  FLOPs: the plain version's two one-hot
    products (S and SS), 2 · 2·C·n·d; bytes: X and y read once, G
    (C, 1 + 2d) fp32 written once."""
    n, d = X.shape
    return 4 * n_classes * n * d, (X.numel() * X.element_size()
                                   + y.numel() * y.element_size()
                                   + n_classes * (1 + 2 * d) * 4)


def grouped_stats(X, y, n_classes: int):
    """``G`` (C, 1 + 2d) fp32 from one fused pass over X (n, d) float32 with
    labels y (n,): ``G[:, 0]`` the class counts, ``G[:, 1:1+d]`` S and
    ``G[:, 1+d:]`` SS."""
    counter = getattr(WORK, "counter", None)
    if counter is not None:
        return counter.kernel("nb_stats", grouped_work, _grouped_stats, X, y, n_classes)
    return _grouped_stats(X, y, n_classes)


def _grouped_stats(X, y, n_classes: int):
    y = _labels(y)
    if not uses_kernel(X):
        return grouped_stats_ref(X, y, n_classes)
    return grouped_stats_cuda(_contiguous(X), _contiguous(y), n_classes)


def nb_stats(X, y, n_classes: int):
    """Per-class ``(counts, S, SS)`` from one fused pass over X (n, d)
    float32 with labels y (n,); fp32 results."""
    counter = getattr(WORK, "counter", None)
    if counter is not None:
        return counter.kernel("nb_stats", grouped_work, _nb_stats, X, y, n_classes)
    return _nb_stats(X, y, n_classes)


def _nb_stats(X, y, n_classes: int):
    if not uses_kernel(X):
        return nb_stats_ref(X, _labels(y), n_classes)
    d = X.shape[1]
    G = grouped_stats(X, y, n_classes)
    return G[:, 0], G[:, 1:1 + d], G[:, 1 + d:]
