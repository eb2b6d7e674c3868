"""Operations of every statistics launch in the traced window
(``bench/work.py``), over the traced seconds at the card's 67 TFLOP/s fp32,
in percent: the share of the card's peak the whole query stream used."""
from bench import work

_WORK = {
    "linreg_stats": lambda a, kw: work.linreg_stats(n=a[0]["shape"][0], d=a[0]["shape"][1])[0],
    "nb_stats": lambda a, kw: work.nb_stats(n=a[0]["shape"][0], d=a[0]["shape"][1],
                                            classes=a[2] if len(a) > 2 else kw["n_classes"])[0],
    "logreg_sgd": lambda a, kw: work.logreg_sgd(n=a[0]["shape"][0], d=a[0]["shape"][1],
                                                chunk=kw["chunk_size"])[0],
}


def read(rec):
    s = rec.get("summary") or {}
    launches = rec.get("launches") or {}
    flops = sum(_WORK[name](a, kw) for name, calls in launches.items() if name in _WORK
                for a, kw in calls)
    if not flops or not s.get("window_s"):
        return None
    return 100.0 * flops / (s["window_s"] * work.PEAK_FLOPS["fp32"])
