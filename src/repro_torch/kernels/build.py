"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Every ``kernels/*/csrc/*.cu`` file exposes a plain C interface and is
compiled on its own into a shared library under ``build/repro_torch_kernels/``
at the repository root (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -I kernels/csrc -o <name>-<hash>.so <name>.cu

``kernels/csrc/`` holds the headers the sources share.  The library name
carries a hash of the source and of those headers, so an edited source or
header is rebuilt and a stale library is never loaded.  Nothing is built at import
time: :class:`CudaKernel` builds its library at first launch, and
:func:`build_all` starts one ``nvcc`` per source at once (as a smoke run
does before it touches the card).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = KERNELS_DIR / "csrc"
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()

#: this thread's launches made while its stream captures a CUDA graph: the
#: capture sets ``CAPTURED.launches`` to a dict, which each launch adds one
#: to under its :class:`CudaKernel` (``models/graphs.py``)
CAPTURED = threading.local()


def sources() -> list[Path]:
    """Every CUDA source of the port, in a stable order."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels are built from source")
    return found


def headers() -> list[Path]:
    """The headers the sources share, in a stable order."""
    return sorted(INCLUDE_DIR.glob("*.cuh"))


def library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in headers():
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def _nvcc_cmd(src: Path, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(out), str(src)]


def build_all(srcs=None) -> dict[str, str]:
    """Build every missing library, one ``nvcc`` process per source, all
    started together.  Returns ``{source stem: ptxas report}`` for the
    sources compiled by this call; raises on any failed build."""
    srcs = list(sources() if srcs is None else srcs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    with _lock:
        for src in srcs:
            out = library_path(src)
            if out.exists():
                continue
            tmp = out.with_name(f".{out.name}.tmp-{os.getpid()}")
            procs.append((src, out, tmp, subprocess.Popen(
                _nvcc_cmd(src, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        reports, failed = {}, []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            (BUILD_DIR / f"{src.stem}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            reports[src.stem] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


class CudaKernel:
    """One C entry point of one CUDA source, plus its launch counter.

    ``launches`` counts the kernel's launches that ran on the card.  A call
    adds one, unless the current stream is capturing a CUDA graph: the launch
    then runs only when the graph replays, so it is noted in
    :data:`CAPTURED` instead, and each replay of the graph adds what its
    capture noted.
    """

    def __init__(self, source: Path, symbol: str, argtypes: list) -> None:
        self.source = Path(source)
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def function(self):
        if self._fn is None:
            path = library_path(self.source)
            if not path.exists():
                build_all([self.source])
            fn = getattr(ctypes.CDLL(str(path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        err = self.function()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} failed to launch: CUDA error {err}")
        if torch.cuda.is_current_stream_capturing():
            noted = getattr(CAPTURED, "launches", None)
            if noted is not None:
                noted[self] = noted.get(self, 0) + 1
            return
        self.launches += 1
