"""The controls of ``correct``: the reference one precision below the
configuration's reads worse than the program, and on the card, at each
cell's own size, fails the cell's limits.

On the card (marked ``gpu``): ``bench/controls.py`` over three seeds a cell,
as its runs were made when the limits were set (PERF.md).  On the CPU, at a
reduced size, the same judges: the control reads more than the program."""
import time

import pytest

from bench import controls, core

CELLS = [w["name"] for w in core.manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limits_on_the_card(card, cell):
    assert controls.main(["--workload", cell, "--seeds", "11", "12", "13"]) == 0


def test_serving_control_reads_worse_than_the_program():
    serve = core.driver("serve_sessions")
    cfg = core.config(core.manifest(), "deepseek-67b-l24")
    cfg.update(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=8, num_key_value_heads=2, vocab_size=512)
    cfg["assumed"] = dict(cfg["assumed"], init_std=0.08)
    cfg["serving"] = dict(cfg["serving"], chunk_tokens=32, decode_bucket=32,
                          byte_budget=8 << 20)
    tr = dict(core.traffic("docqa-reuse"), doc_tokens=256, prefix=[64, 256],
              new_tokens=[8, 16], warmup_s=0.3, check_requests=6)
    rec = serve.run(config=cfg, traffic=tr, limits=core.limits("ds67b-docqa-reuse"),
                    seed=21, seconds=1.0, trace=False, device="cpu",
                    t_start=time.perf_counter(), judge=controls.serve_judge)
    c = rec["check"]
    assert c["control"]["logit_gap"] > c["numbers"]["logit_gap"]["value"]


def test_analytics_control_fails_the_cells_limits():
    an = core.driver("analytics_queries")
    cfg = core.config(core.manifest(), "paper-5m-d10")
    cfg.update(n_points=150_000, model_size_mean=15_000, model_size_std=3750,
               query_mean=15_000, query_std=3750, logreg_chunk=5000)
    tr = dict(core.traffic("queries-cov90"), warmup_s=0.2, check_per_family=4)
    rec = an.run(config=cfg, traffic=tr, limits=core.limits("paper-cov90"), seed=22,
                 seconds=0.8, trace=False, device="cpu", t_start=time.perf_counter(),
                 judge=controls.analytics_judge)
    c = rec["check"]
    assert c["correct"] and c["control_fails"]
