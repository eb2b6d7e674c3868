"""Serving reduced ``deepseek-v2-236b`` (MLA + MoE) in the port, against
``repro``: the counterparts of ``tests/test_serve.py``'s MLA cases.

Weights come from ``repro``'s ``LM.init`` through ``params_from_jax``, the
192-token document from ``np.random.default_rng``; chunk 32.  Required,
greedy only (``jax.random`` and ``torch.Generator`` draw different numbers):

* reuse equals scratch inside the port (``test_serve.py:31``);
* the port's tokens, plans and segment ids equal ``repro``'s with its
  extend on the Pallas kernel in interpret mode (``REPRO_EXTEND_KERNEL=1``,
  the TPU's route, ``test_serve.py:46``) and on its blocked path (``=0``);
* the serve CLI on the CPU prints ``repro``'s lines with the same flags,
  sampled tokens and times aside (each CLI draws its own weights).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "deepseek-v2-236b"


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config(ARCH))
    jm = JaxLM(jax_reduced(jax_get_config(ARCH)))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = LM(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 192).astype(np.int32)
    return jm, jparams, tm, params, doc


def _steps(plan):
    return [(s.rng.lo, s.rng.hi, s.model_id) for s in plan.steps]


def test_reuse_matches_scratch(setup):
    _, _, tm, params, doc = setup
    warm = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu")
    warm.generate(96, 3)
    reused0 = warm.stats.tokens_reused
    toks, plan = warm.generate(160, 3)
    cold = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu")
    toks_ref, _ = cold.generate(160, 3)
    assert toks == toks_ref
    assert warm.stats.tokens_reused > reused0
    assert len(plan.models_used) > 0


@pytest.mark.parametrize("mode", ["1", "0"], ids=["kernel", "blocked"])
def test_serve_matches_reference(setup, mode, monkeypatch):
    """``test_serve.py:46``'s requests and a longer one: the same tokens,
    plans (with segment ids) and store as ``repro`` in either extend mode;
    the warm repeat is served from stored segments."""
    monkeypatch.setenv("REPRO_EXTEND_KERNEL", mode)
    jm, jparams, tm, params, doc = setup
    jeng = JaxEngine(jm, jparams, doc, chunk_tokens=32)
    teng = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu")
    for prefix, n_new in ((96, 3), (96, 2), (160, 3)):
        jt, jp = jeng.generate(prefix, n_new)
        tt, tp = teng.generate(prefix, n_new)
        assert tt == jt, (prefix, tt, jt)
        assert _steps(tp) == _steps(jp)
    assert sorted(teng.store._segs) == sorted(jeng.store._segs)
    assert teng.stats.tokens_reused == jeng.stats.tokens_reused > 0
    assert teng.builder.lowerings == jeng.builder.lowerings


def _report(out: str) -> list:
    """The CLI's reuse lines: request lines up to their tokens, the summary
    up to its timings, and the tier and precision lines."""
    keep = []
    for line in out.splitlines():
        if line.startswith("req "):
            keep.append(line.split("tokens")[0])
        elif " requests: reuse " in line:
            keep.append(line.split(", planner")[0])
        elif line.startswith(("  tiers", "  tier traffic", "  precision")):
            keep.append(line)
    return keep


def test_cli_on_cpu_matches_reference(capsys, monkeypatch):
    from repro.launch import serve as jax_cli
    from repro_torch.launch import serve as cli

    flags = ["--arch", ARCH, "--reduced", "--doc-len", "256", "--requests", "3",
             "--new-tokens", "3", "--chunk-tokens", "64"]
    cli.main(["--device", "cpu", *flags])
    port = _report(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve", *flags])
    jax_cli.main()
    ref = _report(capsys.readouterr().out)
    assert len(port) == 3 + 1 + 3 and port == ref
    assert "reused-models   1" in port[1]
