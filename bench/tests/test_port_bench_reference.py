"""Both references against the port at reduced sizes on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from bench import core
from bench.reference import analytics as aref
from bench.reference import dense_lm

SERVE = core.driver("serve_sessions")
ANALYTICS = core.driver("analytics_queries")


def tiny_lm_config(**kw):
    cfg = core.config(core.manifest(), "deepseek-67b-l24")
    cfg.update(hidden_size=64, intermediate_size=160, num_hidden_layers=3,
               num_attention_heads=8, num_key_value_heads=2, vocab_size=300, **kw)
    cfg["assumed"] = dict(cfg["assumed"], init_std=0.08)
    return cfg


def test_drawn_weights_have_the_ports_layout():
    from repro_torch.models.common import tree_map_with_path
    from repro_torch.models.lm import param_specs

    def leaves(tree):
        out = {}
        tree_map_with_path(lambda p, x: out.setdefault(p, x), tree)
        return out

    cfg = tiny_lm_config()
    w = leaves(SERVE.draw_weights(cfg, 3, "cpu"))
    specs = leaves(param_specs(SERVE.arch_config(cfg)))
    assert {p: tuple(x.shape) for p, x in w.items()} == \
        {p: tuple(s.shape) for p, s in specs.items()}
    assert all(x.dtype == torch.bfloat16 for x in w.values())


def test_drawn_weights_repeat_per_seed():
    cfg = tiny_lm_config()
    a, b = SERVE.draw_weights(cfg, 2**31 + 5, "cpu"), SERVE.draw_weights(cfg, 2**31 + 5, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["segments"][0]["p0"]["mlp"]["w_down"],
                       b["segments"][0]["p0"]["mlp"]["w_down"])


def fp32_port(cfg):
    from repro_torch.models.lm import LM

    arch = dataclasses.replace(SERVE.arch_config(cfg), param_dtype="float32",
                               compute_dtype="float32")
    return LM(arch, device="cpu")


def test_dense_reference_matches_the_port_in_fp32():
    cfg = tiny_lm_config()
    a = SERVE.arch(cfg)
    w = SERVE.draw_weights(cfg, 7, "cpu")
    w32 = torch.utils._pytree.tree_map(lambda x: x.float(), w)
    model = fp32_port(cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 300, (1, 41)))
    with torch.no_grad():
        logits, caches = model.prefill(w32, {"tokens": toks[:, :40]})
        # one decode step through the cache
        from repro_torch.serve.kv_cache import pad_cache_to

        caches = pad_cache_to(caches, 48)
        nxt, _ = model.decode_step(w32, caches, toks[:, 40:41],
                                   torch.tensor([40], dtype=torch.int32))
    ref = dense_lm.logits_at(w, a, [toks[0].tolist()], [[39, 40]], device="cpu")[0]
    assert torch.allclose(ref[0], logits[0], atol=2e-4, rtol=1e-4)
    assert torch.allclose(ref[1], nxt[0], atol=2e-4, rtol=1e-4)


def test_served_gap_reads_zero_for_the_references_own_tokens():
    cfg = tiny_lm_config()
    a = SERVE.arch(cfg)
    w = SERVE.draw_weights(cfg, 8, "cpu")
    prompt = list(range(5, 30))
    toks = []
    seq = list(prompt)
    for _ in range(4):   # greedy under the reference itself
        lg = dense_lm.logits_at(w, a, [seq], [[len(seq) - 1]], device="cpu")[0]
        toks.append(int(lg.argmax()))
        seq.append(toks[-1])
    gaps = dense_lm.served_gaps(w, a, [(np.array(prompt), toks)], device="cpu")
    assert max(gaps[0]) == 0.0
    wrong = [(t + 1) % 300 for t in toks]
    assert max(dense_lm.served_gaps(w, a, [(np.array(prompt), wrong)], device="cpu")[0]) > 0


def test_fp8_control_moves_logits():
    cfg = tiny_lm_config()
    a = SERVE.arch(cfg)
    w = SERVE.draw_weights(cfg, 9, "cpu")
    seq = list(range(3, 60))
    hi = dense_lm.logits_at(w, a, [seq], [list(range(57))], device="cpu")[0]
    lo = dense_lm.logits_at(w, a, [seq], [list(range(57))], device="cpu", quant="fp8")[0]
    rel = float((hi - lo).norm() / hi.norm())
    assert 1e-3 < rel < 0.5


def small_analytics():
    cfg = core.config(core.manifest(), "paper-5m-d10")
    cfg.update(n_points=60_000, model_size_mean=6000, model_size_std=1500,
               query_mean=6000, query_std=1500, logreg_chunk=2000)
    return cfg


@pytest.mark.parametrize("family", ["linreg", "gaussian_nb", "logreg"])
def test_analytics_reference_matches_the_ports_float64_path(family):
    from repro_torch.core.descriptors import Range
    from repro_torch.core.engine import IncrementalAnalyticsEngine
    from repro_torch.data.tabular import ArrayBackend

    cfg = small_analytics()
    X, y = ANALYTICS.tables(cfg, 11)[family]
    X64 = X.astype(np.float64)
    yh = y.astype(np.float64) if family == "linreg" else y.astype(np.int64)
    be = ArrayBackend(X64, yh, n_classes=2 if family != "linreg" else None, device=None)
    eng = IncrementalAnalyticsEngine(be, materialize="never")
    params = ANALYTICS.family_params(cfg, family)
    eng.warm(family, ANALYTICS.warm_ranges(cfg, 0.5, np.random.default_rng(1)), **params)
    for lo, hi in ((1000, 9000), (20_000, 27_500), (33_333, 41_000)):
        res = eng.query(family, Range(lo, hi), **params)
        q = (family, lo, hi, 0.0, 0.0, res)
        err, exact = ANALYTICS.answer_error(cfg, {family: (X, y)}, q)
        assert exact and err < 1e-9, (family, lo, hi, err)


def test_plan_cover_check():
    assert aref.covers_exactly([(1, 0, 10), (1, 10, 25)], 0, 25)
    assert aref.covers_exactly([(1, 0, 30), (-1, 25, 30)], 0, 25)
    assert not aref.covers_exactly([(1, 0, 10), (1, 11, 25)], 0, 25)
    assert not aref.covers_exactly([(1, 0, 10), (1, 5, 25)], 0, 25)
