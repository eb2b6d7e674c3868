"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell's driver at a reduced size on the CPU
(the harness's look for a card is skipped), with one fault planted in the
program, and checks that ``correct`` reads false under the cell's own limits;
a run with no fault reads true."""
import time

import numpy as np

from bench import core

SERVE = core.driver("serve_sessions")
ANALYTICS = core.driver("analytics_queries")


def serve_cell():
    cfg = core.config(core.manifest(), "deepseek-67b-l24")
    cfg.update(hidden_size=64, intermediate_size=160, num_hidden_layers=2,
               num_attention_heads=8, num_key_value_heads=2, vocab_size=300)
    # logits spread as widely as the published width's (0.25 · √64 ≈
    # 0.02 · √8192), so the cell's own limit applies
    cfg["assumed"] = dict(cfg["assumed"], init_std=0.25)
    cfg["serving"] = dict(cfg["serving"], chunk_tokens=32, decode_bucket=32,
                          byte_budget=8 << 20)
    tr = dict(core.traffic("docqa-reuse"), doc_tokens=192, prefix=[48, 192],
              new_tokens=[8, 24], warmup_s=0.3, check_requests=6)
    return cfg, tr, core.limits("ds67b-docqa-reuse")


def serve_run():
    cfg, tr, lim = serve_cell()
    rec = SERVE.run(config=cfg, traffic=tr, limits=lim, seed=2**31 + 3, seconds=1.0,
                    trace=False, device="cpu", t_start=time.perf_counter())
    return rec["check"]


def clone(tree):
    from repro_torch.models.common import tree_map_with_path

    return tree_map_with_path(lambda _, x: x.clone(), tree)


def restore(dst, src):
    from repro_torch.models.common import tree_map_with_path

    tree_map_with_path(lambda _, d, s: d.copy_(s), dst, src)


def test_serving_unbroken_is_correct():
    assert serve_run()["correct"]


def test_serving_token_altered(monkeypatch):
    from repro_torch.serve.session import SessionManager

    orig = SessionManager._sample

    def sample(self, s):
        orig(self, s)
        s.next_tok = (s.next_tok + 1) % self.model.cfg.vocab_size
        s.out_tokens[-1] = s.next_tok

    monkeypatch.setattr(SessionManager, "_sample", sample)
    assert not serve_run()["correct"]


def test_serving_step_returns_its_state_unchanged(monkeypatch):
    from repro_torch.models.lm import LM

    orig = LM.decode_step

    def decode_step(self, params, caches, tokens, pos):
        before = clone(caches)
        logits, out = orig(self, params, caches, tokens, pos)
        restore(out, before)
        return logits, out

    monkeypatch.setattr(LM, "decode_step", decode_step)
    assert not serve_run()["correct"]


def test_serving_half_the_batch_left_out(monkeypatch):
    from repro_torch.models.lm import LM

    orig = LM.decode_step

    def decode_step(self, params, caches, tokens, pos):
        logits, out = orig(self, params, caches, tokens, pos)
        b = logits.shape[0]
        if b >= 2:
            logits = logits.clone()
            logits[b // 2:] = logits[:b // 2].float().mean(0).to(logits.dtype)
        return logits, out

    monkeypatch.setattr(LM, "decode_step", decode_step)
    assert not serve_run()["correct"]


def analytics_run():
    cfg = core.config(core.manifest(), "paper-5m-d10")
    cfg.update(n_points=150_000, model_size_mean=15_000, model_size_std=3750,
               query_mean=15_000, query_std=3750, logreg_chunk=5000)
    tr = dict(core.traffic("queries-cov90"), warmup_s=0.2, check_per_family=4)
    rec = ANALYTICS.run(config=cfg, traffic=tr, limits=core.limits("paper-cov90"), seed=5,
                        seconds=0.8, trace=False, device="cpu", t_start=time.perf_counter())
    return rec["check"]


def test_analytics_unbroken_is_correct():
    assert analytics_run()["correct"]


def test_analytics_answer_altered(monkeypatch):
    from repro_torch.core import linreg, logreg, naive_bayes

    for mod, name in ((linreg, "solve"), (logreg, "solve"), (naive_bayes, "solve_gaussian")):
        orig = getattr(mod, name)

        def altered(*a, _orig=orig, **kw):
            m = _orig(*a, **kw)
            for field in ("weights", "mu"):
                if hasattr(m, field):
                    setattr(m, field, np.asarray(getattr(m, field)) * 1.01)
            return m

        monkeypatch.setattr(mod, name, altered)
    assert not analytics_run()["correct"]


def test_analytics_half_the_rows_left_out(monkeypatch):
    from repro_torch.core.descriptors import Range
    from repro_torch.data.tabular import ArrayBackend

    orig = ArrayBackend.fetch

    def fetch(self, rng):
        return orig(self, Range(rng.lo, rng.lo + max(rng.size // 2, 1)))

    monkeypatch.setattr(ArrayBackend, "fetch", fetch)
    assert not analytics_run()["correct"]


def test_analytics_combine_returns_its_state_unchanged(monkeypatch):
    from repro_torch.core.suffstats import Combinable

    def stale(self, other):
        # the accumulated state comes back as it was (an empty start takes
        # the first operand, so the program does not fail outright)
        empty = all(not np.any(np.asarray(v)) for v in vars(self).values())
        return other if empty else self

    monkeypatch.setattr(Combinable, "__add__", stale)
    assert not analytics_run()["correct"]
