"""The Gaussian Naive Bayes statistics kernel's share of its roofline over
the traced window (``work.nb_stats``: X and the labels read once), against
the profiler's time of ``nb_narrow`` / ``nb_wide``."""
from bench import roofline, work


def _work(args, kw):
    X = args[0]
    n, d = X["shape"]
    classes = args[2] if len(args) > 2 else kw["n_classes"]
    f, b = work.nb_stats(n=n, d=d, classes=classes, elt=X["elt"])
    return f, b, "fp32"


def read(rec):
    return roofline.share(rec, hook="nb_stats", module="repro_torch.kernels.nb_stats.kernel",
                          kernels=("nb_narrow", "nb_wide"), work_of=_work)
