"""Public wrapper for the fused linear-regression statistics kernel.

``repro``'s wrapper builds a padded copy ``Z = [X | y]`` for the TPU kernel
(128 lanes, 512-row blocks); the CUDA kernel reads X and y in place, so
this wrapper only casts y to X's type and slices A, B and yᵀy out of the
(d+1, d+1) result.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:mod:`.ref`); see :mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

from repro_torch.kernels.common import uses_kernel

from .kernel import zt_z_cuda
from .ref import linreg_stats_ref


def linreg_stats(X, y, *, with_yty: bool = False):
    """Fused ``A = XᵀX``, ``B = Xᵀy`` (optionally ``yᵀy``) in one pass over
    X (n, d) and y (n,), fp32 or bf16; fp32 results."""
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"X must be (n, d) and y (n,); got {tuple(X.shape)}, "
                         f"{tuple(y.shape)}")
    y = y.to(X.dtype)
    if not uses_kernel(X):
        A, B, yty = linreg_stats_ref(X, y)
    else:
        d = X.shape[1]
        G = zt_z_cuda(X.contiguous(), y.contiguous())
        A, B, yty = G[:d, :d], G[:d, d], G[d, d]
    return (A, B, yty) if with_yty else (A, B)
