"""The chunked SGD kernel's share of its roofline over the traced window
(``work.logreg_sgd``: X and y read once), against the profiler's time of
``sgd_warp`` / ``sgd_block``.  Each chunk is a chain of dependent minibatch
steps, so the share is small by design."""
from bench import roofline, work


def _work(args, kw):
    X = args[0]
    n, d = X["shape"]
    f, b = work.logreg_sgd(n=n, d=d, chunk=kw["chunk_size"], elt=X["elt"])
    return f, b, "fp32"


def read(rec):
    return roofline.share(rec, hook="logreg_sgd", module="repro_torch.kernels.logreg_sgd.kernel",
                          kernels=("sgd_warp", "sgd_block"), work_of=_work)
