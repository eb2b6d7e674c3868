"""The controls of ``correct``: the reference in the program's place, one
precision below the configuration's, read with the same numbers as the
program's runs.

    python3 bench/controls.py --workload <cell> --seeds 11 12 13 [--seconds 10]

From the root of a checkout, on the card.  For each seed: the cell's set-up
and a short window at its own load, then over the same sample the check
takes, the program's reading and the control's.  Serving (bf16): at each
served position, how far below the fp32 reference's best lies the token an
fp8 forward (weights per channel, activations per token) ranks first.
Analytics (fp32 tables): the family's model computed from rows, statistics
and weights rounded to bfloat16, against the float64 reference.  Prints one
JSON line per seed and exits non-zero if a control passes every limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def serve_judge(config, params, finished, traffic, limits, seed, device) -> dict:
    from bench.reference import dense_lm

    drv = _driver("serve_sessions")
    picked = drv.sample(finished, traffic["check_requests"], seed)
    seqs = [(r.prompt, r.out) for r in picked]
    a = drv.arch(config)
    prog = max(max(g) for g in dense_lm.served_gaps(params, a, seqs, device=device))
    ctrl = max(max(g) for g in dense_lm.control_gaps(params, a, seqs, device=device))
    lim = limits["logit_gap"]
    return {"correct": prog <= lim, "numbers": {"logit_gap": {"value": prog, "limit": lim}},
            "control": {"logit_gap": ctrl}, "control_fails": ctrl > lim,
            "served_tokens": sum(len(r.out) for r in picked)}


def analytics_judge(config, data, window, traffic, limits, seed) -> dict:
    import torch

    drv = _driver("analytics_queries")
    prog = drv.check(config, data, window, traffic, limits, seed)
    ctrl: dict[str, float] = {}
    for q in drv.sample(window, traffic["check_per_family"], seed):
        err, _ = drv.answer_error(config, data, q, dtype=torch.bfloat16)
        ctrl[f"{q[0]}_err"] = max(ctrl.get(f"{q[0]}_err", 0.0), err)
    prog["control"] = ctrl
    prog["control_fails"] = any(v > limits[k] for k, v in ctrl.items())
    return prog


def _driver(name):
    from bench import core

    return core.driver(name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    import torch

    from bench import core

    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 2
    man = core.manifest()
    cell = core.cell(man, args.workload)
    config = core.config(man, cell["config"])
    traffic = core.traffic(cell["traffic"])
    limits = core.limits(cell["name"])
    drv = core.driver(traffic["driver"])
    judge = serve_judge if traffic["driver"] == "serve_sessions" else analytics_judge
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = drv.run(config=config, traffic=traffic, limits=limits, seed=seed,
                      seconds=args.seconds, trace=False, device="cuda:0", t_start=t0,
                      judge=judge)
        c = rec["check"]
        failed_all &= bool(c["control_fails"])
        print(json.dumps({"workload": cell["name"], "seed": seed, "program": c["numbers"],
                          "control": c["control"], "control_fails": c["control_fails"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
