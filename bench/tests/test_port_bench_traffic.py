"""Each traffic generator repeats itself exactly for one seed, differs for
another, and offers every seed the same spread of sizes."""
import numpy as np
import pytest

from bench import core

SERVE = core.driver("serve_sessions")
ANALYTICS = core.driver("analytics_queries")
BIG = 2**31 + 12345


def serve_requests(traffic, seed, n=40):
    load = SERVE.Load(traffic, 102400, seed)
    out = []
    for j in range(n):
        r = load.next(j % traffic["clients"])
        out.append((r.client, r.doc, r.prefix, r.n_new, r.tokens.tobytes()))
    return out, [d.tobytes() for d in load.docs]


@pytest.mark.parametrize("mix", ["docqa-reuse", "chat-fresh"])
def test_serving_mix_repeats_per_seed(mix):
    t = core.traffic(mix)
    assert serve_requests(t, BIG) == serve_requests(t, BIG)
    assert serve_requests(t, BIG) != serve_requests(t, BIG + 1)


@pytest.mark.parametrize("mix", ["docqa-reuse", "chat-fresh"])
def test_serving_sizes_stay_in_range_and_cover_it(mix):
    t = core.traffic(mix)
    load = SERVE.Load(t, 102400, 7)
    reqs = [load.next(c) for _ in range(32) for c in range(t["clients"])]
    pre = np.array([r.prefix for r in reqs])
    new = np.array([r.n_new for r in reqs])
    assert pre.min() >= t["prefix"][0] and pre.max() <= t["prefix"][1]
    assert new.min() >= t["new_tokens"][0] and new.max() <= t["new_tokens"][1]
    # every quarter of each range gets about a quarter of the requests
    for x, (lo, hi) in ((pre, t["prefix"]), (new, t["new_tokens"])):
        q = np.histogram(x, bins=4, range=(lo, hi + 1))[0] / len(x)
        assert np.all(np.abs(q - 0.25) < 0.05), q


def test_seeds_offer_the_same_mean_work():
    t = core.traffic("docqa-reuse")
    means = []
    for seed in (1, 2, 3, BIG):
        load = SERVE.Load(t, 102400, seed)
        reqs = [load.next(c) for _ in range(20) for c in range(8)]
        means.append(np.mean([r.prefix for r in reqs]))
    assert np.ptp(means) / np.mean(means) < 0.02, means


def test_zipf_documents():
    t = core.traffic("docqa-reuse")
    load = SERVE.Load(t, 102400, 5)
    docs = np.array([load.next(c).doc for _ in range(200) for c in range(8)])
    share = np.bincount(docs, minlength=8) / len(docs)
    w = 1.0 / np.arange(1, 9)
    assert np.allclose(share, w / w.sum(), atol=0.03), share


def test_chat_documents_are_unshared():
    t = core.traffic("chat-fresh")
    load = SERVE.Load(t, 102400, 5)
    reqs = [load.next(c % 8) for c in range(64)]
    assert all(r.doc == -1 and len(r.tokens) == r.prefix for r in reqs)
    assert len({r.tokens.tobytes() for r in reqs}) == len(reqs)


def small_config():
    cfg = core.config(core.manifest(), "paper-5m-d10")
    cfg.update(n_points=100_000, model_size_mean=5000, model_size_std=1250,
               query_mean=5000, query_std=1250)
    return cfg


def queries(cfg, seed, n=30):
    q = ANALYTICS.Queries(cfg, seed)
    return [q.next() for _ in range(n)]


def test_analytics_queries_repeat_per_seed():
    cfg = small_config()
    assert queries(cfg, BIG) == queries(cfg, BIG)
    assert queries(cfg, BIG) != queries(cfg, BIG + 1)
    qs = queries(cfg, 3, 300)
    assert all(0 <= lo < hi <= cfg["n_points"] for _, lo, hi in qs)
    fams = [f for f, _, _ in qs]
    assert all(sorted(fams[i:i + 3]) == sorted(cfg["families"]) for i in range(0, 300, 3))
    sizes = np.array([hi - lo for _, lo, hi in qs])
    assert abs(sizes.mean() / cfg["query_mean"] - 1) < 0.03


def test_tables_and_warm_ranges_repeat_per_seed():
    cfg = small_config()
    a, b = ANALYTICS.tables(cfg, BIG), ANALYTICS.tables(cfg, BIG)
    for fam in cfg["families"]:
        assert np.array_equal(a[fam][0], b[fam][0]) and np.array_equal(a[fam][1], b[fam][1])
        assert a[fam][0].dtype == np.float32
    assert a["gaussian_nb"][1].dtype == np.int32
    w1 = ANALYTICS.warm_ranges(cfg, 0.9, np.random.default_rng(4))
    w2 = ANALYTICS.warm_ranges(cfg, 0.9, np.random.default_rng(4))
    assert w1 == w2
    cover = np.zeros(cfg["n_points"], bool)
    for r in w1:
        cover[r.lo:r.hi] = True
    assert cover.mean() >= 0.9
    cover[w1[-1].lo:w1[-1].hi] = False
    for r in w1[:-1]:
        cover[r.lo:r.hi] = True
    assert cover.mean() < 0.9 + 0.02
