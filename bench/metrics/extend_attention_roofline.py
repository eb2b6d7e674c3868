"""The extend kernel's share of its roofline over the traced window: each
launch's causal q·k and p·v over its valid keys, or its q, valid K/V and
output bytes (``work.extend_attention``), against the profiler's time of
``extend_mma_kernel``."""
from bench import roofline, work


def _work(args, kw):
    q, k, v = args[:3]
    b, nb, h, hd = q["shape"]
    t_real = kw["t_real"][0]
    f, n = work.extend_attention(b=b, nb=nb, h=h, kv=k["shape"][2], hd=hd,
                                 hd_v=v["shape"][3], t_real=t_real, elt=q["elt"])
    return f, n, roofline.precision(q["elt"])


def read(rec):
    return roofline.share(rec, hook="extend_attention",
                          module="repro_torch.kernels.extend_attention.kernel",
                          kernels=("extend_mma_kernel", "extend_kernel"), work_of=_work)
