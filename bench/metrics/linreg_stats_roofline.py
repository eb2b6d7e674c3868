"""The linear-regression statistics kernel's share of its roofline over the
traced window (``work.linreg_stats``: X and y read once), against the
profiler's time of its ``ztz_*`` kernels."""
from bench import roofline, work


def _work(args, kw):
    X = args[0]
    n, d = X["shape"]
    f, b = work.linreg_stats(n=n, d=d, elt=X["elt"])
    return f, b, "fp32"


def read(rec):
    return roofline.share(rec, hook="linreg_stats",
                          module="repro_torch.kernels.linreg_stats.kernel",
                          kernels=("ztz_narrow", "ztz_partial", "ztz_reduce"), work_of=_work)
