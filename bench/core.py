"""The harness's lookups and arithmetic: the manifest, the files it names,
percentiles, and the check that nothing of JAX was loaded.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found by the name that ``BENCHMARK.json`` gives:

    bench/configs/<config>.json     sizes, the deployment, what was cut
    bench/traffic/<traffic>.json    the mix's parameters; ``driver`` names
                                    the generator in bench/drivers/<driver>.py
    bench/limits/<cell>.json        the limit of each number ``correct``
                                    compares in that cell
    bench/metrics/<metric>.py       ``read(rec)``: the metric from a run's
                                    record, or None where there is nothing
                                    to read
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"

#: top-level module names that no run may load: JAX, its libraries and the
#: JAX package the port was made from (compared whole: ``repro_torch`` is
#: not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Path = MANIFEST) -> dict:
    return load_json(path)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in the manifest; have "
                   f"{[w['name'] for w in man['workloads']]}")


def config(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in the manifest")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(BENCH / "limits" / f"{cell_name}.json")


def driver(name: str):
    """The generator and loop of one traffic kind: bench/drivers/<name>.py."""
    return _module(BENCH / "drivers" / f"{name}.py", f"bench_driver_{name}")


def metric_reader(name: str):
    """``read(rec)`` of one metric: bench/metrics/<name>.py."""
    return _module(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}").read


def _module(path: Path, modname: str):
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(man: dict, cell_name: str, *, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


# ---------------------------------------------------------------------------
# arithmetic over all samples of a window
# ---------------------------------------------------------------------------

def percentile(xs, q: float):
    """The q-th percentile of every sample, linear between the two nearest
    ranks (numpy's default rule); None for no samples."""
    s = sorted(xs)
    if not s:
        return None
    h = (len(s) - 1) * q / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (h - lo) * (s[hi] - s[lo])


def rate(count: float, seconds: float):
    """``count`` over ``seconds``; None for an empty window."""
    return count / seconds if seconds > 0 and count > 0 else None


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def sync(device) -> None:
    """Wait for the card (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Drop unreferenced objects and return the card's cached blocks."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the JAX check
# ---------------------------------------------------------------------------

def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names of ``FORBIDDEN`` packages present in ``sys.modules``."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)
