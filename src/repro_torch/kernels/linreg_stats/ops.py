"""Public wrappers for the fused linear-regression statistics kernel.

``repro``'s wrapper builds a padded copy ``Z = [X | y]`` for the TPU kernel
(128 lanes, 512-row blocks); the CUDA kernel reads X and y in place, so
these wrappers only cast y to X's type.  ``zt_z`` returns the kernel's
``G = ZᵀZ`` itself (what the analytics path copies to the host, once);
``linreg_stats`` slices A, B and yᵀy out of it.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:mod:`.ref`); see :mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

from repro_torch.kernels.common import WORK, uses_kernel

from .kernel import zt_z_cuda
from .ref import linreg_stats_ref, zt_z_ref


def _check(X, y):
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"X must be (n, d) and y (n,); got {tuple(X.shape)}, "
                         f"{tuple(y.shape)}")
    return y if y.dtype == X.dtype else y.to(X.dtype)


def _contiguous(t):
    return t if t.is_contiguous() else t.contiguous()


def stats_work(X, y, **_) -> tuple:
    """(FLOPs, bytes) of one call.  FLOPs: the plain version's one matrix
    product XᵀX, 2·n·d² (its Xᵀy and yᵀy are a matrix-vector and a vector
    product, which ``FlopCounterMode`` does not count); bytes: X and y read
    once, G (d+1)² fp32 written once."""
    n, d = X.shape
    return 2 * n * d * d, (X.numel() * X.element_size() + y.numel() * y.element_size()
                           + (d + 1) ** 2 * 4)


def zt_z(X, y):
    """``G = [X | y]ᵀ[X | y]`` (d+1, d+1) fp32 in one pass over X (n, d) and
    y (n,), fp32 or bf16: ``G[:d, :d]`` is XᵀX, ``G[:d, d]`` Xᵀy and
    ``G[d, d]`` yᵀy."""
    counter = getattr(WORK, "counter", None)
    if counter is not None:
        return counter.kernel("linreg_stats", stats_work, _zt_z, X, y)
    return _zt_z(X, y)


def _zt_z(X, y):
    y = _check(X, y)
    if not uses_kernel(X):
        return zt_z_ref(X, y)
    return zt_z_cuda(_contiguous(X), _contiguous(y))


def linreg_stats(X, y, *, with_yty: bool = False):
    """Fused ``A = XᵀX``, ``B = Xᵀy`` (optionally ``yᵀy``) in one pass over
    X (n, d) and y (n,), fp32 or bf16; fp32 results."""
    counter = getattr(WORK, "counter", None)
    if counter is not None:
        return counter.kernel("linreg_stats", stats_work, _linreg_stats, X, y,
                              with_yty=with_yty)
    return _linreg_stats(X, y, with_yty=with_yty)


def _linreg_stats(X, y, *, with_yty: bool = False):
    y = _check(X, y)
    if not uses_kernel(X):
        A, B, yty = linreg_stats_ref(X, y)
    else:
        d = X.shape[1]
        G = zt_z_cuda(_contiguous(X), _contiguous(y))
        A, B, yty = G[:d, :d], G[:d, d], G[d, d]
    return (A, B, yty) if with_yty else (A, B)
