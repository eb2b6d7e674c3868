"""How often ``torch.profiler`` misses a kernel of a short session, on one card.

    PYTHONPATH=src:. python3 -m repro_torch.kernels.profiler_count \\
        [--sessions 300] [--out build/profiler_count.json]

``chip_smoke.py`` and the ``gpu`` tests count a wrapper's device kernels per
call with ``torch.profiler`` sessions of a few calls.  This script asks
whether a count short of the launches is the profiler's or the kernels'.
Each session launches the port's ``linreg_stats`` kernel five times on 3
rows, at d 1, 2, 3, 4 and 5: five instances of one template, so the trace
names which launch it holds.  Every launch writes its own output, filled
with NaN before the session, so after it the outputs show which launches
ran: all five when each equals the plain version.  Three ways to run a
session, taken in turns:

  plain    the five launches, synchronise, leave;
  settle   the same, with a 10 ms wait before leaving;
  lead-in  one fill kernel and a synchronise first (not counted: only the
           linreg kernels are), then as plain.

Prints one JSON line per way: sessions, those whose trace held fewer or
more kernels than launches, how often each launch was missing from the
trace, and how many launches did not run (``--label`` tags the lines, for
runs under different environments).  Exits non-zero if a launch did not
run or an output disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels.linreg_stats import kernel as lk
from repro_torch.kernels.linreg_stats.ref import zt_z_ref

ROOT = Path(__file__).resolve().parents[3]
WIDTHS = (1, 2, 3, 4, 5)
ROWS = 3
#: (lead-in fill, wait before leaving in s)
WAYS = {"plain": (False, 0.0), "settle": (False, 0.010), "lead-in": (True, 0.0)}


def session(Xs, y, outs, lead: torch.Tensor | None, wait: float) -> dict:
    """One profiled session of five launches, each into its own output; the
    linreg kernels it traced, by d."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    index = y.get_device()
    stream = lk.current_stream(index)
    for out in outs:
        out.fill_(float("nan"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if lead is not None:
            lead.fill_(1.0)
            torch.cuda.synchronize()
        for d, out in zip(WIDTHS, outs):
            splits, rows, narrow, floats = lk.plan(ROWS, d)
            ws = lk.WORKSPACE.get(index, stream, floats)
            lk.KERNEL(Xs[d].data_ptr(), y.data_ptr(), ws.data_ptr(), ws.numel(),
                      out.data_ptr(), ROWS, d, splits, rows, narrow, 0, stream)
        torch.cuda.synchronize()
        if wait:
            time.sleep(wait)
    traced = dict.fromkeys(WIDTHS, 0)
    for e in prof.key_averages():
        m = re.search(r"ztz_narrow<float, (\d+)>", e.key)
        if e.device_type == DeviceType.CUDA and m:
            traced[int(m.group(1)) - 1] += e.count
    return traced


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=300)
    ap.add_argument("--out", default=str(ROOT / "build" / "profiler_count.json"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_count: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(70)
    Xs = {d: torch.randn((ROWS, d), generator=g, device=dev) for d in WIDTHS}
    y = torch.randn((ROWS,), generator=g, device=dev)
    want = {d: zt_z_ref(Xs[d], y) for d in WIDTHS}
    outs = [torch.empty((d + 1, d + 1), device=dev) for d in WIDTHS]
    # the widest width's workspace, made before any session, serves them all
    lk.WORKSPACE.get(0, lk.current_stream(0), max(lk.plan(ROWS, d)[3] for d in WIDTHS))
    lead = torch.empty(16, device=dev)
    tally = {way: {"sessions": 0, "fewer": 0, "more": 0, "not_run": 0, "wrong": 0,
                   "missing_by_d": dict.fromkeys(WIDTHS, 0)} for way in WAYS}
    for i in range(args.sessions):
        for way in (list(WAYS) if i % 2 == 0 else list(WAYS)[::-1]):
            has_lead, wait = WAYS[way]
            traced = session(Xs, y, outs, lead if has_lead else None, wait)
            t = tally[way]
            t["sessions"] += 1
            total = sum(traced.values())
            t["fewer"] += total < len(WIDTHS)
            t["more"] += total > len(WIDTHS)
            for d, out in zip(WIDTHS, outs):
                t["missing_by_d"][d] += traced[d] == 0
                t["not_run"] += bool(out.isnan().any())
                t["wrong"] += not torch.allclose(out, want[d], rtol=1e-5, atol=1e-6)
    card = torch.cuda.get_device_name(0)
    lines = [json.dumps({"label": args.label, "way": way, "launches_per_session": len(WIDTHS),
                         "card": card, **t}) for way, t in tally.items()]
    print("\n".join(lines))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")
    return int(any(t["not_run"] or t["wrong"] for t in tally.values()))


if __name__ == "__main__":
    sys.exit(main())
