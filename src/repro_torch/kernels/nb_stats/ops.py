"""Public wrapper for the Naive Bayes grouped-statistics kernel.

``repro``'s wrapper pads X to 128 lanes and the rows to the block with
class −1; the CUDA kernel reads X and y in place and needs neither.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:mod:`.ref`); see :mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import uses_kernel

from .kernel import grouped_stats_cuda
from .ref import nb_stats_ref


def nb_stats(X, y, n_classes: int):
    """Per-class ``(counts, S, SS)`` from one fused pass over X (n, d)
    float32 with labels y (n,); fp32 results."""
    y = y.to(torch.int32)
    if not uses_kernel(X):
        return nb_stats_ref(X, y, n_classes)
    d = X.shape[1]
    G = grouped_stats_cuda(X.contiguous(), y.contiguous(), n_classes)
    return G[:, 0], G[:, 1:1 + d], G[:, 1 + d:]
