"""A kernel's share of its roofline in a traced window: the least time of
every launch the window made (``bench/work.py``) over the device time the
profiler gave the kernel.  Read only when the profiler saw each launch: its
count of the kernel must equal the wrapper's ``KERNEL.launches`` and the
launches the kernel hook recorded, or the run fails."""
from __future__ import annotations

from bench import trace, work


def share(rec: dict, *, hook: str, module: str, kernels: tuple, work_of):
    calls = rec.get("launches", {}).get(hook)
    if not calls or not rec["summary"].get("ops"):
        return None
    secs, seen, _ = trace.kernel_time(rec["summary"], kernels)
    counted = rec.get("kernel_launches", {}).get(module, 0)
    if not seen == counted == len(calls):
        raise RuntimeError(
            f"{hook}: the profiler saw {seen} launches of {kernels[0]}, the wrapper "
            f"counted {counted} and the kernel hook recorded {len(calls)}")
    if secs <= 0:
        return None
    least = sum(work.bound_s(*work_of(args, kw)) for args, kw in calls)
    return 100.0 * least / secs


def precision(elt: int) -> str:
    return "bf16" if elt == 2 else "fp32"
