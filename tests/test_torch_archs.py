"""The four configs whose layers the port already ran before
``nemotron-4-340b``, against ``repro``: ``phi3-medium-14b`` (GQA, G 4 at
full width), ``qwen3-32b`` (``qk_norm``), ``mixtral-8x7b`` (MoE on every
layer) and ``kimi-k2-1t-a32b`` (a first dense layer, then MoE with a shared
expert: the first MoE-on-GQA stack the port serves).

Weights come from ``repro``'s ``LM.init`` through ``params_from_jax``;
tokens and documents from ``np.random.default_rng``.  Both sides run fp32
on the CPU (``repro``'s blocked paths, the port's plain versions), so what
differs is the reduction order: logits are held to ``LOGIT_ATOL``
(measured on the CPU: at most 3e-7 over prefill, extend and decode), greedy
tokens, plans and segment ids must be equal.  And every config ``repro``
registers builds in the port with ``repro``'s parameter count.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve import kv_cache as jax_kv  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from _port_config import jax_fields  # noqa: E402

#: fp32 logits of a reduced model, XLA against torch
LOGIT_ATOL = 1e-4
#: each arch with the layer kinds of its reduced stack
LAYERS = {"phi3-medium-14b": ["attn/dense"],
          "qwen3-32b": ["attn/dense"],
          "mixtral-8x7b": ["attn/moe"],
          "kimi-k2-1t-a32b": ["attn/dense", "attn/moe"]}


def test_registry_holds_the_ported_archs():
    assert set(LAYERS) | {"deepseek-67b", "deepseek-v2-236b", "nemotron-4-340b",
                          "mamba2-130m", "jamba-v0.1-52b", "whisper-large-v3",
                          "llama-3.2-vision-11b"} == set(ARCHS)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_every_reference_config_builds(arch):
    """Every config ``repro`` registers has a copy here whose full-size
    stack builds (spec trees only, no allocation) with ``repro``'s
    parameter count."""
    from repro.models.common import param_count
    from repro.models.lm import param_specs as jax_param_specs
    from repro_torch.models.common import tree_leaves

    model = LM(get_config(arch), device="cpu")
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(model.specs))
    assert n == param_count(jax_param_specs(jax_get_config(arch)))


@pytest.mark.parametrize("arch", list(LAYERS))
def test_config_copy_matches_reference(arch):
    full, jfull = get_config(arch), jax_get_config(arch)
    assert jax_fields(full) == dataclasses.asdict(jfull)
    assert jax_fields(reduced(full)) == dataclasses.asdict(jax_reduced(jfull))
    assert full.head_dim == 128 and full.n_heads // full.n_kv_heads <= 8


@pytest.fixture(scope="module", params=list(LAYERS))
def models(request):
    arch = request.param
    cfg = reduced(get_config(arch))
    jm = JaxLM(jax_reduced(jax_get_config(arch)))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = LM(cfg, device="cpu")
    return arch, cfg, jm, jparams, tm, params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                                       "cpu")


def test_prefill_extend_decode_match_reference(models):
    """Prefill 40 tokens, extend 16, then four greedy decode steps: logits
    within ``LOGIT_ATOL`` and the same tokens."""
    arch, cfg, jm, jparams, tm, params = models
    assert [f"{spec.mixer}/{spec.mlp}" for period, _ in tm.segments
            for spec in period] == LAYERS[arch]
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(1)
    s, nb, cap = 40, 16, 64
    toks = rng.integers(0, cfg.vocab_size, (1, s + nb)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(tree, {"tokens": jnp.asarray(toks[:, :s])})
    with torch.no_grad():
        tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks[:, :s])})
    worst = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    jc, tc = jax_kv.pad_cache_to(jc, cap), kv_cache.pad_cache_to(tc, cap)
    jl, jc = jax.jit(jm.prefill_extend)(tree, jc, jnp.asarray(toks[:, s:]), jnp.int32(s))
    with torch.no_grad():
        tl, tc = tm.prefill_extend(params, tc, torch.from_numpy(toks[:, s:]),
                                   torch.tensor(s, dtype=torch.int32))
    worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    jdec = jax.jit(jm.decode_step)
    jtok, ttok = int(np.argmax(np.asarray(jl)[0])), int(torch.argmax(tl[0]))
    assert ttok == jtok
    for i in range(4):
        p = s + nb + i
        jl, jc = jdec(tree, jc, jnp.asarray([[jtok]], jnp.int32), jnp.asarray([p], jnp.int32))
        with torch.no_grad():
            tl, tc = tm.decode_step(params, tc, torch.tensor([[ttok]]),
                                    torch.tensor([p], dtype=torch.int32))
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
        jtok, ttok = int(np.argmax(np.asarray(jl)[0])), int(torch.argmax(tl[0]))
        assert ttok == jtok, i
    print(f"{arch}: max |logit diff| {worst:.3g}")
    assert worst < LOGIT_ATOL, worst


def test_serve_matches_reference(models):
    """``ServeEngine``: the same greedy tokens, plans (with segment ids) and
    store as ``repro``, the warm repeat served from stored segments."""
    _, cfg, jm, jparams, tm, params = models
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 192).astype(np.int32)
    jeng = JaxEngine(jm, jparams, doc, chunk_tokens=32)
    teng = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu")
    for prefix, n_new in ((96, 3), (96, 2), (160, 3)):
        jt, jp = jeng.generate(prefix, n_new)
        tt, tp = teng.generate(prefix, n_new)
        assert tt == jt, (prefix, tt, jt)
        assert [(x.rng.lo, x.rng.hi, x.model_id) for x in tp.steps] == \
            [(x.rng.lo, x.rng.hi, x.model_id) for x in jp.steps]
    assert sorted(teng.store._segs) == sorted(jeng.store._segs)
    assert teng.stats.tokens_reused == jeng.stats.tokens_reused > 0
