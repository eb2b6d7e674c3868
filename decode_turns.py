#!/usr/bin/env python3
"""Time the decode-attention kernel at several split lengths in turns, on one card.

    python3 decode_turns.py [--split 64 --split 128 --split 256] [--rounds 2]
        [--out chiprun_out/decode_turns.json]

Each split length is a copy of ``decode_attention.cu`` with its ``SPLIT``
constant set (the port's own build keeps 128), built by ``kernels/build.py``
and launched through the port's wrapper.  Each build is first held against
``ref.py::decode_attention_split`` at its split, at ``chip_smoke.py``'s
phase 2 shape, in fp32 (rtol 1e-4 / atol 1e-5) and bf16 (2e-2).  Then the
builds and ``scaled_dot_product_attention`` are timed in turns (v1 … vn,
vn … v1 each round) at two bf16 shapes: phase 2's (B4 KV8 G8 hd128 cap
4096, pos 0/1000/2049/4095) and the serving path's decode step (B1, cap
3088, pos 3072).  Two times each: ``call_ms``, the median of CUDA-event
times around one call with the L2 cache flushed before it
(``chip_smoke.Timer``), and ``device_ms``, the device time per call from
``torch.profiler`` (L2 warm), split and combine kernels apart.  Prints one
JSON line per build and shape and writes them all to ``--out``; exits
non-zero on a failed build or check.
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
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    KERNEL, SOURCE, decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import decode_attention_split  # noqa: E402

SHAPES = {"B4": (4, 4096, [0, 1000, 2049, 4095]),
          "B1": (1, 3088, [3072])}
KV, G, HD = 8, 8, 128
SPLIT_LINE = re.compile(r"constexpr int SPLIT = \d+;")


def source_at(split: int) -> Path:
    """A copy of the kernel's source with ``SPLIT`` set to ``split``."""
    text, n = SPLIT_LINE.subn(f"constexpr int SPLIT = {split};", SOURCE.read_text())
    if n != 1:
        raise RuntimeError(f"{SOURCE} has {n} SPLIT definitions, expected 1")
    path = build.BUILD_DIR.parent / "decode_turns" / f"split{split}" / SOURCE.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def inputs(shape: str, dtype, dev):
    b, cap, pos = SHAPES[shape]
    q = chip_smoke.randn((b, 1, KV * G, HD), dtype, dev, 4)
    k = chip_smoke.randn((b, cap, KV, HD), dtype, dev, 5)
    v = chip_smoke.randn((b, cap, KV, HD), dtype, dev, 6)
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device=dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split", type=int, action="append", default=None,
                    help="positions per split (repeatable; default 64 128 256)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "decode_turns.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    splits = args.split or [64, 128, 256]
    srcs = {s: source_at(s) for s in splits}
    build.build_all(list(srcs.values()))
    kernels = {s: build.CudaKernel(src, KERNEL.symbol, KERNEL.argtypes)
               for s, src in srcs.items()}

    def run(split, q, k, v, pos):
        return decode_attention_cuda(q, k, v, pos, kernel=kernels[split], split=split)

    for split in splits:
        for dtype, (rtol, atol) in ((torch.float32, (1e-4, 1e-5)),
                                    (torch.bfloat16, (2e-2, 2e-2))):
            q, k, v, pos = inputs("B4", dtype, dev)
            got = run(split, q, k, v, pos)
            want = decode_attention_split(q[:, 0].reshape(-1, KV, G, HD).float(),
                                          k.float(), v.float(), pos, split=split)
            torch.cuda.synchronize()
            ok, err = chip_smoke.within(got.reshape(want.shape), want, rtol, atol)
            print(f"  split {split} {str(dtype)[6:]}: max |err| {err:.3g} "
                  f"(rtol {rtol}, atol {atol})")
            chip_smoke.check(ok, f"split {split} disagrees with its plain version "
                                 f"({dtype}, max err {err})")

    from torch.nn.functional import scaled_dot_product_attention as sdpa

    timer = chip_smoke.Timer(dev)
    records = []
    for shape in SHAPES:
        q, k, v, pos = inputs(shape, torch.bfloat16, dev)
        cap = k.shape[1]
        mask = (torch.arange(cap, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        calls = {f"split{s}": (lambda s=s: run(s, q, k, v, pos)) for s in splits}
        calls["sdpa"] = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        parts = {name: ("split_kernel", "combine_kernel") for name in calls}
        parts["sdpa"] = ("",)                       # every kernel it launches
        keys = float((pos + 1).sum())
        nbytes = 2 * (2 * q.numel() + 2 * keys * KV * HD) + 4 * len(pos)
        bound_ms, bound_by = chip_smoke.bound(4.0 * HD * KV * G * keys, nbytes,
                                              torch.bfloat16)
        times = {name: {"call_ms": [], **{p: [] for p in parts[name]}} for name in calls}
        for _ in range(args.rounds):
            for name in list(calls) + list(calls)[::-1]:
                times[name]["call_ms"].append(timer.ms(calls[name]))
                for p in parts[name]:
                    times[name][p].append(chip_smoke.device_ms(calls[name], p))
        for name, t in times.items():
            device = [sum(ms) for ms in zip(*(t[p] for p in parts[name]))]
            rec = {"variant": name, "shape": shape, "pos": pos.tolist(), "cap": cap,
                   "call_ms": t["call_ms"], "device_ms": device,
                   "median_call_ms": float(np.median(t["call_ms"])),
                   "median_device_ms": float(np.median(device)),
                   "device_ms_by_kernel": {p or "all": float(np.median(t[p]))
                                           for p in parts[name]},
                   "bound_ms": bound_ms, "bound_by": bound_by, "card": smi}
            records.append(rec)
            print(json.dumps(rec))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(r) for r in records) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
