"""Shared kernel utilities: padding, bucketing and device routing.

Routing rule of the port: a kernel wrapper decides by the device of the
tensor it is given, and by nothing else.  A CUDA tensor goes to the
hand-written Hopper kernel (and the wrapper raises if the card is older
than compute capability 9.0, if the kernel fails to build, or if the
launch fails); a CPU tensor goes to the kernel's plain PyTorch version.
There is no fallback from one to the other and no switch that overrides
the rule.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F


#: this thread's work counter (``launch/op_analysis.py::OpCounter``), read
#: by every kernel wrapper as ``getattr(WORK, "counter", None)``: while one
#: is active a wrapper reports the FLOPs and bytes of its call to it and
#: runs its body through ``counter.kernel``
WORK = threading.local()


def cdiv(x: int, m: int) -> int:
    return (x + m - 1) // m


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def bucket_len(x: int, bucket: int, *, floor: int = 1) -> int:
    """Pad-to-bucket length: smallest bucket multiple ≥ max(x, floor).

    Serving pads caches to a bucketed capacity so the set of shapes the
    kernels and the store see stays small and reusable.
    """
    return round_up(max(x, floor), bucket)


def pad_axis(x: torch.Tensor, axis: int, target: int, value: float = 0.0):
    """Pad ``x`` with ``value`` along ``axis`` up to length ``target``."""
    cur = x.shape[axis]
    if cur == target:
        return x
    axis = axis % x.ndim
    pads = [0, 0] * (x.ndim - axis - 1) + [0, target - cur]
    return F.pad(x, pads, value=value)


#: compute capability per CUDA device index, read once
_CAPABILITY: dict[int, tuple[int, int]] = {}


def uses_kernel(x: torch.Tensor) -> bool:
    """True when ``x`` lives on a CUDA device and must go to the kernel.

    Raises on a CUDA device below compute capability 9.0: the kernels are
    built for ``sm_90a`` only.  CPU tensors return False (plain version).
    """
    if not x.is_cuda:
        if x.device.type == "cpu":
            return False
        raise ValueError(f"no kernel route for device {x.device}")
    index = x.get_device()
    cap = _CAPABILITY.get(index)
    if cap is None:
        cap = _CAPABILITY[index] = torch.cuda.get_device_capability(index)
    if cap < (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(index)} has compute capability "
            f"{cap[0]}.{cap[1]}; the port's kernels need 9.0 (Hopper)")
    return True


def current_stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device ``index``:
    the stream a wrapper launches on.  PyTorch's own accessor (what its
    compiled kernels launch on) returns it without building a
    ``torch.cuda.Stream`` object per call; CUDA builds only."""
    return torch._C._cuda_getCurrentRawStream(index)


class StreamWorkspace:
    """Scratch a kernel keeps across calls, one buffer per (device, stream).

    Zeroed once when it is made and grown (made anew, zeroed) when a call
    needs more, so a wrapper allocates nothing per call but its output.
    Keyed by stream as well as device: a kernel that leaves state in its
    scratch between launches (a ticket that returns to 0) never shares it
    with a launch in flight on another stream.
    """

    def __init__(self) -> None:
        self._buffers: dict[tuple[int, int], torch.Tensor] = {}

    def get(self, index: int, stream: int, floats: int) -> torch.Tensor:
        buf = self._buffers.get((index, stream))
        if buf is None or buf.numel() < floats:
            # made on the current stream (the one it is keyed by), so the
            # zeroing is ordered before every launch that uses it
            buf = torch.zeros(floats, dtype=torch.float32,
                              device=torch.device("cuda", index))
            self._buffers[(index, stream)] = buf
        return buf


#: CUgraphNodeType (cuda.h): the kinds of operation a graph node holds
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
                    5: "empty", 6: "wait_event", 7: "event_record",
                    8: "ext_semaphore_signal", 9: "ext_semaphore_wait",
                    10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
                    13: "conditional"}


def enqueued(fn) -> dict[str, int]:
    """What one call of ``fn`` enqueues on the current CUDA device, by kind
    of operation (``{"kernel": 1}`` for a wrapper that launches its kernel
    and nothing else), read from a CUDA graph captured around the call and
    never replayed.  Exact where a profiler trace is not: a trace can miss
    a kernel that ran (``kernels/profiler_count.py``).  ``fn`` runs once on
    the capturing stream first, so the state a wrapper keeps per stream
    (its workspace) exists before the capture."""
    import ctypes

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_size_t)]
    libcuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(handle, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    if not err and count.value:
        err = libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    kinds: dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        err = err or libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        name = GRAPH_NODE_KINDS.get(kind.value, f"type {kind.value}")
        kinds[name] = kinds.get(name, 0) + 1
    graph.reset()
    if err:
        raise RuntimeError(f"reading the captured graph failed: CUresult {err}")
    return kinds


def to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """A kernel's small results as float64 numpy arrays, in one copy (which
    also waits for the device, so the caller's clock times real work)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].astype(np.float64).reshape(t.shape))
        at += t.numel()
    return out


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x|, elementwise (0 where x is 0).

    The bf16 attention kernels are held to ``|got − want| ≤ bf16_ulp(want)
    + 1e-6`` against their fp32 plain versions: the output's own rounding
    takes half an ulp, which leaves half an ulp for the kernel's arithmetic.
    """
    x = x.float()
    _, e = torch.frexp(x.abs())                  # |x| = m·2^e, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)  # 8 significant bits
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def within_bf16_ulp(got: torch.Tensor, want: torch.Tensor,
                    atol: float = 1e-6) -> tuple[bool, float]:
    """Whether ``got`` is within one bf16 ulp of ``want`` (plus ``atol``)
    everywhere, and the largest ratio of an error to its bound (≤ 1 passes)."""
    err = (got.float() - want.float()).abs()
    ulp = bf16_ulp(want)
    ok = bool((err <= ulp + atol).all())
    return ok, float((err / (ulp + atol)).max())
