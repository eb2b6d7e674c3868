"""Checkpointing in ``repro.train.checkpoint``'s layout, written off the
training thread.

  <dir>/step_<N>/MANIFEST.json    — leaf paths, shapes, dtypes, file map, hashes
  <dir>/step_<N>/arr_<i>.npy      — one file per leaf

Leaves are numbered in ``jax.tree_util``'s flatten order (dict keys sorted)
and named by ``repro``'s keypath strings (``['params']/['segments']/[0]/
['p0']/['ln1']``), so a checkpoint written by either package restores in
the other.  A bf16 leaf goes to disk as ``|V2`` holding its bytes (the
segment store's encoding: no ``ml_dtypes`` needed) and reads back as bf16.
The manifest is published by an atomic rename, after every array.
"""
from __future__ import annotations

import hashlib
import json
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.store import to_numpy, to_torch
from repro_torch.models.common import tree_items_sorted, tree_map_with_path


def _keypath(path: tuple) -> str:
    """A leaf path as ``jax.tree_util``'s keypath string."""
    return "/".join(f"[{p!r}]" if isinstance(p, str) else f"[{p}]" for p in path)


def _flatten_with_paths(tree):
    items = tree_items_sorted(tree)
    return [_keypath(p) for p, _ in items], [x for _, x in items]


def save_checkpoint(path: str | Path, tree: Any, *, extra_meta: dict | None = None) -> None:
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    paths, leaves = _flatten_with_paths(tree)
    manifest = {"version": 1, "leaves": [], "meta": extra_meta or {},
                "written_s": time.time()}
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        arr = to_numpy(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(root / fname, arr)
        digest = hashlib.sha256((root / fname).read_bytes()).hexdigest()
        manifest["leaves"].append(
            {"path": p, "file": fname, "shape": list(arr.shape),
             "dtype": str(arr.dtype), "sha256": digest})
    tmp = root / "MANIFEST.json.tmp"
    tmp.write_text(json.dumps(manifest))
    tmp.rename(root / "MANIFEST.json")   # atomic publish


def restore_checkpoint(path: str | Path, like: Any, *, shardings: Any = None,
                       verify: bool = False, device=None) -> Any:
    """Restore into the structure of ``like`` (leaves with a ``shape``).

    Each leaf comes back as a tensor in its dtype on disk, on ``device``
    (the CPU when None); a leaf missing from the checkpoint or of another
    shape than ``like``'s raises, and ``verify`` checks every file's
    sha256 against the manifest.

    ``shardings`` (the elastic re-shard path) is a tree with ``like``'s
    structure of ``(mesh, placements)`` pairs (``sharding.safe_sharding``,
    ``shardings_for``): each leaf comes back as
    ``distribute_tensor(leaf, mesh, placements)`` on the mesh's device
    type, whatever mesh wrote the checkpoint.
    """
    root = Path(path)
    manifest = json.loads((root / "MANIFEST.json").read_text())
    by_path = {ent["path"]: ent for ent in manifest["leaves"]}

    def load(path, leaf):
        p = _keypath(path)
        ent = by_path.get(p)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        f = root / ent["file"]
        if verify:
            digest = hashlib.sha256(f.read_bytes()).hexdigest()
            if digest != ent["sha256"]:
                raise IOError(f"checksum mismatch for {ent['file']}")
        arr = np.load(f)
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {p}: ckpt {arr.shape} vs model {want}")
        x = to_torch(arr).reshape(arr.shape)      # a 0-d leaf stays 0-d
        return x if device is None else x.to(device)

    if shardings is None:
        return tree_map_with_path(load, like)
    from torch.distributed.tensor import distribute_tensor

    def place(path, leaf, sharding):
        mesh, placements = sharding
        return distribute_tensor(load(path, leaf).to(mesh.device_type), mesh, placements)

    return tree_map_with_path(place, like, shardings)


def latest_step(dirpath: str | Path) -> Optional[int]:
    root = Path(dirpath)
    if not root.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in root.iterdir()
             if d.is_dir() and d.name.startswith("step_") and (d / "MANIFEST.json").exists()]
    return max(steps) if steps else None


def _host_copy(x):
    """A leaf's value now, on the host: the training step updates the
    parameters in place, and ``.cpu()`` of a CPU tensor is no copy."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x.detach().to("cpu", copy=True))
    return np.array(x)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with a bounded queue.

    ``save`` copies the tree to host memory on the calling thread (the
    values at that step) and queues it; serialization and IO happen
    off-thread, and the writer keeps the newest ``keep`` checkpoints.  A
    full queue blocks rather than dropping a checkpoint; a writer's error
    is raised by the next ``save`` or ``wait``.
    """

    def __init__(self, dirpath: str | Path, keep: int = 3) -> None:
        self.dir = Path(dirpath)
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Any) -> None:
        if self._err is not None:
            raise self._err
        self._q.put((step, tree_map_with_path(lambda _, x: _host_copy(x), tree)))

    def wait(self) -> None:
        self._q.join()
        if self._err is not None:
            raise self._err

    def _run(self) -> None:
        while True:
            step, tree = self._q.get()
            try:
                save_checkpoint(self.dir / f"step_{step}", tree,
                                extra_meta={"step": step})
                self._gc()
            except Exception as e:  # surfaced on next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self) -> None:
        steps = sorted(
            int(d.name.split("_")[1])
            for d in self.dir.iterdir()
            if d.is_dir() and d.name.startswith("step_") and (d / "MANIFEST.json").exists())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
