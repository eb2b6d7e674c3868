"""Time variants of the chunked logistic-SGD kernel in turns, on one card.

    PYTHONPATH=src:. python3 -m repro_torch.kernels.logreg_sgd.turns \
        [--rounds 2] [--out build/logreg_turns/turns.json]

(run from the repository root: it reuses ``chip_smoke.py``'s timer and
checks).  Each variant is a copy of ``logreg_sgd.cu`` with one change, built
by ``kernels/build.py`` under ``build/logreg_turns/`` and launched through
the port's wrapper (``sgd_segment_cuda(kernel=)``):

  base       the source as it is (the warp form: one warp per chunk);
  block      the entry point launches the block form (one 256-thread block
             per chunk, three block barriers per step) for d 10, batch 64;
  nostage    each warp stages no minibatch (its weights are wrong; it times
             what staging costs a step);
  noreduce   no cross-lane sum of the gradient (its weights are wrong; it
             times the reduction);
  nosigmoid  z in place of sigmoid(z) (its weights are wrong; it times the
             sigmoid);
  ieee       the sigmoid's reciprocal and the step size lr / sqrt(t + 1) in
             IEEE arithmetic, as the reference writes them, in place of the
             approximate reciprocal and rsqrt (1 and 2 ulp);
  divide     the update divides each gradient sum by the batch's row count,
             as the reference writes it, in place of one reciprocal per step.

Every variant but ``nostage``, ``noreduce`` and ``nosigmoid`` is first held
against the plain version (rtol 2e-4, atol 2e-5) and shown bitwise
repeatable.  Then each variant is
timed in turns (v1 … vn, vn … v1 each round) on segments of 1, 5 and 500
chunks of 10,000 x 10 rows (batch 64, int32 labels, a view from row 1):
``call_ms``, the median of CUDA-event times around one call with the L2
cache flushed before it (``chip_smoke.Timer``), and ``device_ms``, the
kernel time per call from ``torch.profiler``.  Prints each variant's ptxas
line for ``sgd_warp<10>``, one JSON line per (variant, chunks), and writes
them all to ``--out``; exits non-zero on a failed build or check.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.logreg_sgd.kernel import KERNEL, SOURCE, sgd_segment_cuda
from repro_torch.kernels.logreg_sgd.ref import sgd_segment_ref

ROOT = Path(__file__).resolve().parents[4]

STAGE = "    if (s < steps) {\n"
REDUCE = "      for (int j = 0; j <= D; ++j) part[j] += __shfl_xor_sync(0xffffffffu, part[j], o);\n"
EXP = "const float e = 1.f + expf(-((s0 + s1) + b));"
RCP = "rcp_approx(e) - label"
STEP = "lr * rsqrtf((float)t + 1.f)"
UPDATE = ("    for (int j = 0; j < D; ++j) w[j] = w[j] - step * (part[j] * inv + two_lam * w[j]);\n"
          "    b = b - step * (part[D] * inv);\n")
DIVIDE = ("    for (int j = 0; j < D; ++j) w[j] = w[j] - step * (part[j] / (float)m + two_lam * w[j]);\n"
          "    b = b - step * (part[D] / (float)m);\n")
WARP_FORM = "  if (warp_form) {\n"
#: each variant's changes to the source: (old text, new text)
VARIANTS = {
    "base": (),
    "block": ((WARP_FORM, "  if (false) {\n"),),
    "nostage": ((STAGE, "    if (false) {\n"),),
    "noreduce": ((REDUCE, "      for (int j = 0; j <= D; ++j) part[j] += 0.f;\n"),),
    "nosigmoid": ((EXP, "const float e = (s0 + s1) + b;"), (RCP, "e - label")),
    "ieee": ((RCP, "1.f / e - label"), (STEP, "lr / sqrtf((float)t + 1.f)")),
    "divide": ((UPDATE, DIVIDE),),
}
EXACT = ("base", "block", "ieee", "divide")
L, D, BATCH = 10_000, 10, 64
CHUNKS = (1, 5, 500)


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{SOURCE} holds {text.count(old)} copies of {old!r}, expected 1")
    return text.replace(old, new)


def source_of(name: str) -> Path:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        text = _sub(text, old, new)
    path = build.BUILD_DIR.parent / "logreg_turns" / f"{SOURCE.stem}_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
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
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "logreg_turns" / "turns.json"))
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
    libs = {name: build.CudaKernel(src, KERNEL.symbol, KERNEL.argtypes)
            for name, src in srcs.items()}
    for name, src in srcs.items():
        print(f"  {name}: sgd_warp<10>: {registers(reports[src.stem], 'sgd_warpILi10E')}")

    n_max = max(CHUNKS) * L
    X = chip_smoke.randn((n_max + 1, D), torch.float32, dev, 60)
    y = (chip_smoke.randn((n_max + 1,), torch.float32, dev, 61) > 0).to(torch.int32)
    timer = chip_smoke.Timer(dev)
    records = []
    for p in CHUNKS:
        Xp, yp = X[1:p * L + 1], y[1:p * L + 1]      # a view from an odd row
        want = sgd_segment_ref(Xp[:5 * L].cpu(), yp[:5 * L].cpu(), chunk_size=L, lam=1e-3,
                               lr=0.5, batch=BATCH).to(dev)
        calls = {}
        for name in VARIANTS:
            fn = (lambda k=libs[name]:
                  sgd_segment_cuda(Xp, yp, chunk_size=L, lam=1e-3, lr=0.5, batch=BATCH,
                                   kernel=k))
            calls[name] = fn
            if name not in EXACT:
                continue
            got, again = fn(), fn()
            torch.cuda.synchronize()
            ok, err = chip_smoke.within(got[:5], want[:min(p, 5)], 2e-4, 2e-5)
            same = torch.equal(got, again)
            print(f"  {name} at {p} chunk(s): max |err| {err:.3g}; bitwise repeatable: {same}")
            chip_smoke.check(ok and same, f"variant {name} fails at {p} chunks")
        times = {label: {"call_ms": [], "device_ms": []} for label in calls}
        for _ in range(args.rounds):
            for label in list(calls) + list(calls)[::-1]:
                times[label]["call_ms"].append(timer.ms(calls[label]))
                times[label]["device_ms"].append(chip_smoke.device_ms(calls[label], ""))
        for label, t in times.items():
            rec = {"variant": label, "chunks": p, "l": L, "d": D, "batch": BATCH,
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
