"""Analytics-workload driver of the PyTorch port — the paper's own
end-to-end scenario.

Replays a model-construction workload (mixed linreg / NB / logreg queries
over an ordered data set) through the IncrementalAnalyticsEngine and
reports the Fig 2/5-style summary vs the no-reuse baseline.

  PYTHONPATH=src python -m repro_torch.launch.analytics --points 1000000 --queries 200

runs on the CUDA device (the base tables live there and every statistics
pass goes through a Hopper kernel); ``--device cpu`` runs the same path on
the CPU with the kernels' plain versions.  The flags are those of
``python -m repro.launch.analytics``; ``--store-dir`` (persistence) raises
``NotImplementedError`` naming the ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "repro_torch.launch.analytics: no CUDA device is available; pass "
            "--device cpu to run the port on the CPU")
    return device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=500_000)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--coverage", type=float, default=0.6)
    ap.add_argument("--model-size", type=int, default=20_000)
    ap.add_argument("--query-size", type=int, default=20_000)
    ap.add_argument("--families", default="linreg,gaussian_nb,logreg")
    ap.add_argument("--store-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device holding the base tables (default cuda; "
                         "'cpu' runs the kernels' plain versions)")
    return ap


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.store_dir:
        raise NotImplementedError(
            "--store-dir is not ported to repro_torch yet: ROADMAP.md §1 "
            "item 6 (persistence)")
    device = resolve_device(args.device)

    from repro_torch.core.descriptors import Range, coalesce
    from repro_torch.core.engine import IncrementalAnalyticsEngine
    from repro_torch.data.synthetic import make_classification, make_regression
    from repro_torch.data.tabular import ArrayBackend, RemoteStoreBackend

    rng = np.random.default_rng(args.seed)
    Xr, yr = make_regression(args.points, d=args.dim, seed=args.seed)
    Xc, yc = make_classification(args.points, d=args.dim, n_classes=2,
                                 seed=args.seed + 1)
    # base data behind disaggregated storage (the deployment the planner
    # optimizes for), resident on the device
    cls_backend = RemoteStoreBackend(ArrayBackend(Xc, yc, device=device))
    backends = {
        "linreg": RemoteStoreBackend(ArrayBackend(Xr, yr, device=device)),
        "gaussian_nb": cls_backend,
        "logreg": cls_backend,
    }

    for family in args.families.split(","):
        be = backends[family]
        eng = IncrementalAnalyticsEngine(be, materialize="chunks" if family == "logreg" else "always")
        # warm to target coverage
        ranges = []
        while True:
            cov = sum(r.size for r in coalesce(ranges)) / args.points
            if cov >= args.coverage:
                break
            lo = int(rng.integers(0, args.points - args.model_size))
            ranges.append(Range(lo, lo + args.model_size))
        params = {"chunk_size": args.model_size} if family == "logreg" else {}
        eng.warm(family, ranges, **params)

        t_ours = t_base = 0.0
        reused = 0
        for _ in range(args.queries):
            size = max(int(rng.normal(args.query_size, args.query_size / 4)), 1000)
            size = min(size, args.points - 1)
            lo = int(rng.integers(0, args.points - size))
            q = Range(lo, lo + size)
            t0 = time.perf_counter()
            r = eng.query(family, q, **params)
            synchronize(device)
            t_ours += time.perf_counter() - t0
            reused += int(r.used_reuse)
            t0 = time.perf_counter()
            eng.baseline(family, q, **params)
            synchronize(device)
            t_base += time.perf_counter() - t0
        print(f"{family:14s} coverage {eng.coverage(family):.0%}  "
              f"speedup {t_base / t_ours:.2f}x  "
              f"reused {reused}/{args.queries} queries  "
              f"store {eng.store.nbytes()/1e6:.2f} MB  on {device}")


if __name__ == "__main__":
    sys.exit(main())
