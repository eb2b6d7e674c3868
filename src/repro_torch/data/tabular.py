"""Columnar base-data backends with range fetch.

Mirrors ``repro.data.tabular``.  The port's backends hold or deliver the
base table as tensors on a device (default ``cuda``): X in float32 and y in
the type its kernel reads (int32 class labels, else float32), so every
statistics pass of the engine runs on the card.  ``device=None`` keeps the
table in host numpy arrays instead, where fetches take ``repro``'s float64
path.

``ArrayBackend`` holds the table in memory (on the device, a fetch is a
view of its rows: the kernels read them in place).  ``TabularBackend``
memory-maps ``X``/``y`` on disk and copies each fetched range to its device.
``RemoteStoreBackend`` wraps either with a simulated remote-store latency.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cost import CostModel
from repro_torch.core.descriptors import Range


def _n_classes(y: np.ndarray) -> int:
    return int(y.max()) + 1 if len(y) else 0


def to_device(X: np.ndarray, y: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table as kernel-ready tensors on ``device``: X float32, y int32
    when it holds class labels, else float32."""
    y_dtype = np.int32 if np.issubdtype(np.asarray(y).dtype, np.integer) else np.float32
    Xt = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))
    yt = torch.from_numpy(np.ascontiguousarray(y, dtype=y_dtype))
    return Xt.to(device), yt.to(device)


def _check(rng: Range, n_rows: int) -> None:
    if rng.lo < 0 or rng.hi > n_rows:
        raise IndexError(f"range {rng} outside [0, {n_rows})")


class ArrayBackend:
    def __init__(self, X: np.ndarray, y: np.ndarray, n_classes: int | None = None, *,
                 device="cuda") -> None:
        if len(X) != len(y):
            raise ValueError(f"X has {len(X)} rows, y {len(y)}")
        y = np.asarray(y)
        self.n_classes = n_classes if n_classes is not None else _n_classes(y)
        self.device = None if device is None else torch.device(device)
        if self.device is None:
            self.X = np.ascontiguousarray(X)
            self.y = np.ascontiguousarray(y)
        else:
            self.X, self.y = to_device(X, y, self.device)

    @property
    def n_rows(self) -> int:
        return len(self.X)

    @property
    def dim(self) -> int:
        return self.X.shape[1]

    def fetch(self, rng: Range):
        _check(rng, self.n_rows)
        if self.device is not None:
            return self.X[rng.lo : rng.hi], self.y[rng.lo : rng.hi]
        # host copies force the bytes to actually move (honest F(n))
        return self.X[rng.lo : rng.hi].copy(), self.y[rng.lo : rng.hi].copy()


class RemoteStoreBackend:
    """Disaggregated-storage wrapper: per-request latency + bounded scan rate.

    The 2015 prototype fetched base data from MySQL (seek + SQL overhead);
    at pod scale base data lives in a remote columnar store (blob storage /
    disaggregated parquet), whose cost structure is the same shape:
    ``F(n) = fixed + n/rows_per_s``.  This wrapper imposes that cost on any
    in-memory backend so wall-clock benchmarks reflect the deployment the
    planner is optimizing for.  Defaults model a warm object store
    (~1 ms/request, 2M rows/s/stream) — far *faster* than the paper's
    MySQL, i.e. conservative for reuse benefits.
    """

    def __init__(self, inner, fixed_s: float = 1e-3, rows_per_s: float = 2e6):
        self.inner = inner
        self.fixed_s = fixed_s
        self.rows_per_s = rows_per_s
        self.requests = 0
        self.rows_served = 0

    @property
    def n_rows(self) -> int:
        return self.inner.n_rows

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def n_classes(self) -> int:
        return self.inner.n_classes

    def fetch(self, rng: Range):
        out = self.inner.fetch(rng)
        self.requests += 1
        self.rows_served += rng.size
        deadline = time.perf_counter() + self.fixed_s + rng.size / self.rows_per_s
        # deterministic delay (sleep granularity is too coarse for sub-ms)
        while time.perf_counter() < deadline:
            pass
        return out

    def cost_model(self) -> CostModel:
        """A CostModel calibrated to this backend (what the planner should use)."""
        cm = CostModel()
        cm.io_fixed_s = self.fixed_s
        cm.bytes_per_row = 1.0
        cm.io_bytes_per_s = 2.0 * self.rows_per_s      # half the slope…
        cm.flops_per_row = 1.0
        cm.flops_per_s = 2.0 * self.rows_per_s          # …in each term
        return cm


class TabularBackend:
    """Disk-resident dataset: ``<root>/X.npy`` + ``<root>/y.npy`` (mmap);
    each fetched range is copied to ``device``."""

    def __init__(self, root: str | Path, n_classes: int | None = None, *,
                 device="cuda") -> None:
        self.root = Path(root)
        self.X = np.load(self.root / "X.npy", mmap_mode="r")
        self.y = np.load(self.root / "y.npy", mmap_mode="r")
        self.device: Optional[torch.device] = None if device is None else torch.device(device)
        meta = self.root / "meta.npz"
        if n_classes is not None:
            self.n_classes = n_classes
        elif meta.exists():
            self.n_classes = int(np.load(meta)["n_classes"])
        else:
            self.n_classes = 0

    @classmethod
    def write(cls, root: str | Path, X: np.ndarray, y: np.ndarray,
              n_classes: int | None = None, *, device="cuda") -> "TabularBackend":
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        np.save(root / "X.npy", np.ascontiguousarray(X))
        np.save(root / "y.npy", np.ascontiguousarray(y))
        if n_classes is None and np.issubdtype(np.asarray(y).dtype, np.integer):
            n_classes = int(y.max()) + 1
        np.savez(root / "meta.npz", n_classes=n_classes or 0)
        return cls(root, n_classes=n_classes, device=device)

    @property
    def n_rows(self) -> int:
        return len(self.X)

    @property
    def dim(self) -> int:
        return self.X.shape[1]

    def fetch(self, rng: Range):
        _check(rng, self.n_rows)
        X, y = np.array(self.X[rng.lo : rng.hi]), np.array(self.y[rng.lo : rng.hi])
        return (X, y) if self.device is None else to_device(X, y, self.device)
