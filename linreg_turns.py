#!/usr/bin/env python3
"""Time variants of the linreg-statistics kernel in turns, on one card.

    python3 linreg_turns.py [--rounds 2] [--out build/linreg_turns/turns.json]

Each variant is a copy of ``linreg_stats.cu`` with one change, built by
``kernels/build.py`` under ``build/linreg_turns/`` and launched through the
port's wrapper (``zt_z_cuda(kernel=, splits=)``):

  base       the source as it is;
  butterfly  a butterfly of 5 shuffles per sum within each warp (330 for
             the 66 sums of d 10) in place of the recursive halving (67);
  fenced     a __threadfence in every thread that wrote a partial and a
             relaxed atomicAdd for the ticket (the threadFenceReduction
             pattern of NVIDIA's CUDA samples), in place of one
             atom.acq_rel.gpu;
  noload     the last block sums its lane's quad indices in place of the
             partials (its G is wrong; it times the last block's loads);
  notail     the narrow form returns once its partial is written: no ticket,
             no last-block sum (its G is wrong; it times what the tail costs).

``base``, ``butterfly`` and ``fenced`` are first held against the plain version
(rtol 5e-4, atol n·2e-2·rtol) and shown bitwise repeatable.  Then each
(variant, split count) is timed in turns (v1 … vn, vn … v1 each round) at
the analytics query's 50K × 10 fp32 and the table's 5M × 10: ``call_ms``,
the median of CUDA-event times around one call with the L2 cache flushed
before it (``chip_smoke.Timer``), and ``device_ms``, the kernel time per
call from ``torch.profiler`` (L2 warm).  Prints each variant's ptxas line
for the fp32 d 10 kernel, one JSON line per (variant, splits, shape), and
writes them all to ``--out``; exits non-zero on a failed build or check.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.linreg_stats.kernel import KERNEL, SOURCE, zt_z_cuda  # noqa: E402
from repro_torch.kernels.linreg_stats.ref import zt_z_ref  # noqa: E402

HALVING = """  int base = 0, end = K;
  halve<K + 1, K, 16>(acc, lane, base, end);
#pragma unroll
  for (int i = 0; i < L::KH; ++i)
    if (base + i < end) red[warp][base + i] = acc[i];
"""
BUTTERFLY = """#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][k] = v;
  }
"""
ACQREL = """    if (blockIdx.x == 0)
      for (int c = splits; c < stride; ++c) partial[(size_t)k * stride + c] = 0.f;
  }
  __syncthreads();               // the block's partial is written
  if (tid == 0) last = ticket_add(ticket) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;
"""
FENCED = """    if (blockIdx.x == 0)
      for (int c = splits; c < stride; ++c) partial[(size_t)k * stride + c] = 0.f;
    __threadfence();
  }
  __syncthreads();               // the block's partial is written
  if (tid == 0) last = atomicAdd(ticket, 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
"""
LOAD = """          const float4 v =
              __ldcg(reinterpret_cast<const float4*>(partial + (size_t)k * stride) + c);
"""
TAIL = "  __syncthreads();               // the block's partial is written\n"
#: variants that compute G (held against the plain version)
EXACT = ("base", "butterfly", "fenced")
VARIANTS = {
    "base": lambda text: text,
    "butterfly": lambda text: _sub(text, HALVING, BUTTERFLY),
    "fenced": lambda text: _sub(text, ACQREL, FENCED),
    "noload": lambda text: _sub(text, LOAD, "          const float4 v = make_float4(c, c, c, c);\n"),
    "notail": lambda text: _sub(text, TAIL, "  return;\n" + TAIL),
}
SPLITS = {50_000: (66, 132, 196), 5_000_000: (132, 264)}
D = 10


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{SOURCE} holds {text.count(old)} copies of {old!r}, expected 1")
    return text.replace(old, new)


def source_of(name: str) -> Path:
    path = build.BUILD_DIR.parent / "linreg_turns" / f"{SOURCE.stem}_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(VARIANTS[name](SOURCE.read_text()))
    return path


def registers(log: str, entry: str) -> str:
    """ptxas's resource line for the kernel whose mangled name holds
    ``entry``."""
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
        elif current and entry in current and "Used" in line:
            return line.split(":", 1)[1].strip()
    return "not found"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "linreg_turns" / "turns.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    srcs = {name: source_of(name) for name in VARIANTS}
    for src in srcs.values():                 # rebuild, so ptxas reports
        build.library_path(src).unlink(missing_ok=True)
    reports = build.build_all(list(srcs.values()))
    kernels = {name: build.CudaKernel(src, KERNEL.symbol, KERNEL.argtypes)
               for name, src in srcs.items()}
    for name, src in srcs.items():
        print(f"  {name}: ztz_narrow<float, 11>: "
              f"{registers(reports[src.stem], 'ztz_narrowIfLi11E')}")

    n_max = max(SPLITS)
    X = chip_smoke.randn((n_max + 1, D), torch.float32, dev, 42)
    y = chip_smoke.randn((n_max + 1,), torch.float32, dev, 43)
    timer = chip_smoke.Timer(dev)
    records = []
    for n, counts in SPLITS.items():
        Xn, yn = X[1:n + 1], y[1:n + 1]              # a view from an odd row
        want = zt_z_ref(Xn, yn)
        calls = {}
        for name in VARIANTS:
            for splits in counts:
                fn = (lambda k=kernels[name], s=splits: zt_z_cuda(Xn, yn, kernel=k, splits=s))
                calls[f"{name} splits {splits}"] = fn
                if name not in EXACT:
                    continue
                got, again = fn(), fn()
                torch.cuda.synchronize()
                ok, err = chip_smoke.within(got, want, 5e-4, n * 2e-2 * 5e-4)
                same = torch.equal(got, again)
                print(f"  {name} splits {splits} at {n} x {D}: max |err| {err:.3g}; "
                      f"bitwise repeatable: {same}")
                chip_smoke.check(ok and same, f"variant {name} splits {splits} fails at {n}")
        times = {label: {"call_ms": [], "device_ms": []} for label in calls}
        for _ in range(args.rounds):
            for label in list(calls) + list(calls)[::-1]:
                times[label]["call_ms"].append(timer.ms(calls[label]))
                times[label]["device_ms"].append(chip_smoke.device_ms(calls[label], ""))
        for label, t in times.items():
            rec = {"variant": label, "n": n, "d": D, "dtype": "float32",
                   "call_ms": t["call_ms"], "device_ms": t["device_ms"],
                   "median_call_ms": float(np.median(t["call_ms"])),
                   "median_device_ms": float(np.median(t["device_ms"])), "card": smi}
            records.append(rec)
            print(json.dumps(rec))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(r) for r in records) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
