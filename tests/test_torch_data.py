"""The port's token pipeline against ``repro``'s, and the training CLI.

``TokenStream`` and ``lm_pipeline`` batches bitwise ``repro``'s for the
same (vocab, seed, shard, step); ``repro``'s pipeline contracts (snapshot
and resume, hedged fetch, the planted bigram); and ``python -m
repro_torch.launch.train --device cpu --reduced`` printing ``repro``'s
lines, writing its metrics and its checkpoints.
"""
import json
import re
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data.tokens import TokenStream as JaxTokenStream  # noqa: E402
from repro_torch.data.pipeline import PipelineState, ShardedPipeline, lm_pipeline  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from test_torch_train_model import one_thread  # noqa: E402,F401  (autouse)


@pytest.mark.parametrize("vocab,seed", [(512, 0), (1000, 3), (102400, 7)])
def test_token_stream_is_the_reference(vocab, seed):
    ours, ref = TokenStream(vocab, seed=seed), JaxTokenStream(vocab, seed=seed)
    assert ours.shift == ref.shift
    for shard, step in ((0, 0), (1, 0), (3, 17)):
        a, b = ours.batch(shard, step, 4, 33), ref.batch(shard, step, 4, 33)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_lm_pipeline_is_the_reference(n_shards):
    ours = lm_pipeline(512, batch=8, seq=16, n_shards=n_shards, seed=1)
    ref = jax_pipeline.lm_pipeline(512, batch=8, seq=16, n_shards=n_shards, seed=1)
    try:
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.snapshot() == ref.snapshot() == {"step": 3, "n_shards": n_shards}
    finally:
        ours.close()
        ref.close()


def test_deterministic_and_resumable():
    p1 = lm_pipeline(1000, batch=8, seq=16, n_shards=4, seed=0)
    for _ in range(3):
        next(p1)
    snap = p1.snapshot()
    b_next = next(p1)
    p1.close()
    p2 = ShardedPipeline.resume(snap, p1.fetch, n_shards=4)
    assert isinstance(p2.state, PipelineState) and p2.state.step == 3
    b_resumed = next(p2)
    p2.close()
    np.testing.assert_array_equal(b_next["tokens"], b_resumed["tokens"])


def test_hedged_fetch():
    calls = {"n": 0}

    def slow_fetch(shard, step):
        calls["n"] += 1
        if calls["n"] == 1:      # first call stalls
            time.sleep(0.5)
        return {"x": np.full((2, 2), step)}

    p = ShardedPipeline(slow_fetch, n_shards=1, hedge_deadline_s=0.05)
    batch = next(p)
    p.close()
    assert p.hedges_issued >= 1
    np.testing.assert_array_equal(batch["x"], np.zeros((2, 2)))


def test_fetch_error_reaches_the_consumer():
    def broken(shard, step):
        raise OSError("shard unreachable")

    p = ShardedPipeline(broken, n_shards=2)
    with pytest.raises(OSError, match="unreachable"):
        next(p)
    p.close()


def test_planted_signal_learnable():
    st = TokenStream(100, seed=2)
    b = st.batch(0, 0, 64, 32)
    follows = (b["targets"] == (b["tokens"] + st.shift) % 100).mean()
    assert 0.35 < follows < 0.75


# repro's lines: every tenth step, and the summary
STEP_LINE = re.compile(r"^step +\d+  loss \d+\.\d{4}  gnorm \d+\.\d{3}  lr \d\.\d{2}e[-+]\d{2}$")
DONE_LINE = re.compile(r"^done: loss \d+\.\d{4} → \d+\.\d{4} \(\d+ steps, [\d,]+ params\)$")


@pytest.mark.parametrize("arch", ["deepseek-67b", "whisper-large-v3"])
def test_train_cli_on_cpu(arch, tmp_path, capsys):
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import latest_step

    metrics = tmp_path / "m.json"
    train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "12",
                "--batch", "4", "--seq", "32", "--microbatches", "2",
                "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "5",
                "--metrics-out", str(metrics)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "10"]
    assert all(STEP_LINE.match(ln) for ln in lines[:-1]), lines
    assert DONE_LINE.match(lines[-1]), lines[-1]
    hist = json.loads(metrics.read_text())
    assert [h["step"] for h in hist] == list(range(12))
    assert all(np.isfinite(h["loss"]) and h["retries"] == 0 for h in hist)
    assert latest_step(tmp_path / "ck") == 12
    assert sorted(int(d.name.split("_")[1]) for d in (tmp_path / "ck").iterdir()) == [5, 10, 12]


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train.main(["--arch", "deepseek-67b", "--reduced", "--steps", "1"])


def test_reference_cli_prints_the_same_lines(monkeypatch, capsys):
    """The line formats above are ``repro``'s: its own CLI matches them."""
    import sys

    from repro.launch import train as jax_train

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "deepseek-67b", "--reduced",
                                      "--steps", "12", "--batch", "4", "--seq", "32"])
    jax_train.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "10"]
    assert all(STEP_LINE.match(ln) for ln in lines[:-1]), lines
    assert DONE_LINE.match(lines[-1]), lines[-1]
