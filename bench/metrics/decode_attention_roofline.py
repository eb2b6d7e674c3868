"""The decode kernel's share of its roofline over the traced window: each
launch's rows over their valid positions only, not the pack's capacity
(``work.decode_attention``), against the profiler's time of its
``split_kernel`` and ``combine_kernel``."""
from bench import roofline, work


def _work(args, kw):
    q, k, v = args[:3]
    _, _, h, hd = q["shape"]
    f, n = work.decode_attention(pos=kw["pos"], h=h, kv=k["shape"][2], hd=hd,
                                 hd_v=v["shape"][3], elt=q["elt"])
    return f, n, roofline.precision(q["elt"])


def read(rec):
    return roofline.share(rec, hook="decode_attention",
                          module="repro_torch.kernels.decode_attention.kernel",
                          kernels=("split_kernel", "combine_kernel"), work_of=_work)
