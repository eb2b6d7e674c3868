"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Loads and warms up the cell's system (counted
as ``setup_s``), measures for ``--seconds``, checks what the window produced
against the plain reference, and prints one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``compared``, each
number the check compared beside its limit (also the last lines of standard
error).  Exits non-zero, printing no result, without a CUDA card or with
fewer cards than the cell asks for, when the program cannot be imported, and
when a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own nvcc builds go to build/repro_torch_kernels/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"bench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from bench import core, trace

    man = core.manifest()
    cell = core.cell(man, args.workload)
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        return fail(f"the program (src/repro_torch) cannot be imported: {exc}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: the benchmark runs on a CUDA card")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} cards; "
                    f"{torch.cuda.device_count()} visible")
    config = core.config(man, cell["config"])
    traffic = core.traffic(cell["traffic"])
    limits = core.limits(cell["name"])
    metrics = core.metrics_of(man, cell["name"], trace=bool(args.trace))
    readers = {m["name"]: core.metric_reader(m["name"]) for m in metrics}
    driver = core.driver(traffic["driver"])
    torch.cuda.set_device(0)
    rec = driver.run(config=config, traffic=traffic, limits=limits, seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace), device="cuda:0",
                     t_start=T_START)
    bad = core.forbidden_loaded()
    if bad:
        return fail(f"modules of JAX or of the JAX package were loaded: {bad}", 3)
    out = {}
    for m in metrics:
        v = readers[m["name"]](rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    chk = rec["check"]
    result = {"correct": chk["correct"], "attempted": rec["counts"]["attempted"],
              "failed": rec["counts"]["failed"], "metrics": out, "device": dev}
    if args.trace:
        s = rec["summary"]
        dev["busy_s"] = s["busy_s"]
        dev["window_s"] = s["window_s"]
        result["breakdown"] = trace.breakdown(s)
    result["compared"] = chk["numbers"]
    print("bench: " + json.dumps({
        "workload": cell["name"], "seed": args.seed, "trace": args.trace,
        "setup_s": rec["setup_s"], "window_s": rec["window_s"], "counts": rec["counts"],
        "check_s": rec["check_s"], "total_s": time.perf_counter() - T_START,
        "check": {k: v for k, v in chk.items() if k not in ("correct", "numbers")},
        "diag": rec.get("diag")}),
        file=sys.stderr)
    for name, v in chk["numbers"].items():
        print(f"compared {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
