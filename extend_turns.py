#!/usr/bin/env python3
"""Time the bf16 extend kernel with q's A fragments held in registers or read
from shared memory, in turns, on one card.

    python3 extend_turns.py [--rounds 2] [--out chiprun_out/extend_turns.json]

``extend_mma_kernel`` holds q's A fragments in registers for the whole K/V
walk up to a staged q·k width of 128 and reads them from the resident q
tile at each k-step past it (``HOLD_Q`` in the source).  This script builds
the source as it is ("read") and a copy that holds them up to 192 too
("held"), under ``build/extend_turns/``, prints each build's ``ptxas``
registers and spills for the 192-wide instances, holds both against the
fp32 plain version within one bf16 ulp (+1e-6) and against each other
bitwise, then times them in turns (read, held, held, read each round) at
the two shapes past 128 columns: nemotron's (192, 192) at B1 KV8 G12 nb128
capacity 4160 t_real 4096, and MLA's packed (192, 128) at B1 H128 G1, the
same nb, capacity and t_real.  Two times each: ``call_ms`` (CUDA events, L2
flushed: ``chip_smoke.Timer``) and ``device_ms`` (``torch.profiler``).
Prints one JSON line per variant and shape and writes them to ``--out``;
exits non-zero on a failed build or check.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.common import within_bf16_ulp  # noqa: E402
from repro_torch.kernels.extend_attention.kernel import (  # noqa: E402
    KERNEL, SOURCE, extend_attention_cuda)
from repro_torch.kernels.extend_attention.ops import pack_mla  # noqa: E402
from repro_torch.kernels.extend_attention.ref import extend_attention_ref  # noqa: E402

HOLD_LINE = "constexpr bool HOLD_Q = KD <= 128;"
NB, CAP, T_REAL = 128, 4160, 4096


def source_held() -> Path:
    """A copy of the kernel's source that holds q's fragments up to 192."""
    text = SOURCE.read_text()
    if text.count(HOLD_LINE) != 1:
        raise RuntimeError(f"{SOURCE} has no single line {HOLD_LINE!r}")
    path = build.BUILD_DIR.parent / "extend_turns" / "held" / SOURCE.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text.replace(HOLD_LINE, "constexpr bool HOLD_Q = KD <= 192;"))
    return path


def inputs(shape: str, dev):
    """bf16 (q, k, v) of the shape: G 12 at hd 192, or MLA's packed 192 / 128."""
    dt = torch.bfloat16
    if shape == "gqa192":
        return (chip_smoke.randn((1, NB, 96, 192), dt, dev, 1),
                chip_smoke.randn((1, CAP, 8, 192), dt, dev, 2),
                chip_smoke.randn((1, CAP, 8, 192), dt, dev, 3))
    qn, qr, kn, kr, v = chip_smoke.mla_operands(1, NB, 128, CAP, (128, 64, 128), dt, dev, 31)
    return (*pack_mla(qn, qr, kn, kr), v)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "extend_turns.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    held = source_held()
    for name, src in (("read", SOURCE), ("held", held)):
        # both copies log to the same name: read each build's log before the next
        log = build.build_all([src]).get(src.stem)
        if log is None:                     # built before, by this process's caller
            log = (build.BUILD_DIR / f"{src.stem}.log").read_text()
        for line in chip_smoke.ptxas_summary(log):
            if "<192," in line:
                print(f"  {name}: {line}")
    kernels = {"read": KERNEL, "held": build.CudaKernel(held, KERNEL.symbol, KERNEL.argtypes)}

    t_real = torch.tensor(T_REAL, dtype=torch.int32, device=dev)
    timer = chip_smoke.Timer(dev)
    records = []
    for shape in ("gqa192", "mla"):
        q, k, v = inputs(shape, dev)
        calls = {name: (lambda kern=kern: extend_attention_cuda(q, k, v, t_real, kernel=kern))
                 for name, kern in kernels.items()}
        want = extend_attention_ref(q.float(), k.float(), v.float(), t_real=T_REAL)
        outs = {name: fn() for name, fn in calls.items()}
        torch.cuda.synchronize()
        for name, out in outs.items():
            ok, worst = within_bf16_ulp(out, want)
            print(f"  {shape} {name}: error up to {worst:.3f}x one bf16 ulp + 1e-6")
            chip_smoke.check(ok, f"{shape} {name}: past one bf16 ulp ({worst:.3f}x)")
        same = torch.equal(outs["read"], outs["held"])
        print(f"  {shape}: read and held bitwise equal: {same}")
        chip_smoke.check(same, f"{shape}: the two builds differ")
        times = {name: {"call_ms": [], "device_ms": []} for name in calls}
        for _ in range(args.rounds):
            for name in list(calls) + list(calls)[::-1]:
                times[name]["call_ms"].append(timer.ms(calls[name]))
                times[name]["device_ms"].append(chip_smoke.device_ms(calls[name], ""))
        for name, t in times.items():
            rec = {"variant": name, "shape": shape, "q": list(q.shape), "k": list(k.shape),
                   "v": list(v.shape), "t_real": T_REAL, **t,
                   "median_call_ms": float(np.median(t["call_ms"])),
                   "median_device_ms": float(np.median(t["device_ms"])), "card": smi}
            records.append(rec)
            print(json.dumps(rec))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(r) for r in records) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
