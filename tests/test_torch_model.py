"""The port's dense GQA model against ``repro.models.lm.LM``.

Reduced ``deepseek-67b`` (2 layers, d 64, 4 heads / 2 KV heads, hd 16,
fp32).  Weights come from the reference's ``LM.init`` through
``params_from_jax``; token ids from ``np.random.default_rng``.  The JAX
side runs its CPU paths (blocked-softmax extend and decode, the
references of its Pallas kernels), the port its kernels' plain versions.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve import kv_cache as jax_kv  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map_with_path  # noqa: E402
from repro_torch.models.lm import LM, param_specs, params_from_jax  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from _port_config import jax_fields  # noqa: E402

# measured on the CPU: max |logit| difference 1.49e-7 over prefill, extend
# and 4 decode steps (fp32 reduction order differs between XLA and torch)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_config("deepseek-67b"))
    jcfg = jax_reduced(jax_get_config("deepseek-67b"))
    jm = JaxLM(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = LM(cfg, device="cpu")
    return cfg, jm, tree, tm, params_from_jax(cfg, tree, "cpu")


def _leaves_close(port_caches, jax_caches, upto):
    pl = tree_leaves(port_caches)
    jl = jax.tree.leaves(jax_caches)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        np.testing.assert_allclose(p.numpy()[:, :, :upto],
                                   np.asarray(j)[:, :, :upto],
                                   rtol=1e-4, atol=1e-4)


def test_config_copy_matches_reference(models):
    cfg = models[0]
    jcfg = jax_reduced(jax_get_config("deepseek-67b"))
    assert jax_fields(cfg) == dataclasses.asdict(jcfg)
    full = get_config("deepseek-67b")
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.n_layers) == \
        (8192, 64, 8, 128, 22016, 102400, 95)


def test_prefill_extend_decode_match_reference(models):
    cfg, jm, tree, tm, params = models
    rng = np.random.default_rng(0)
    s, nb, cap, n_dec = 40, 16, 64, 4
    toks = rng.integers(0, cfg.vocab_size, (1, s + nb + n_dec)).astype(np.int32)
    worst = 0.0

    jl, jc = jax.jit(jm.prefill)(tree, {"tokens": jnp.asarray(toks[:, :s])})
    with torch.no_grad():
        tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks[:, :s])})
    worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    _leaves_close(tc, jc, s)

    jc = jax_kv.pad_cache_to(jc, cap)
    tc = kv_cache.pad_cache_to(tc, cap)
    jl, jc = jax.jit(jm.prefill_extend)(tree, jc, jnp.asarray(toks[:, s:s + nb]),
                                        jnp.int32(s))
    with torch.no_grad():
        tl, tc = tm.prefill_extend(params, tc, torch.from_numpy(toks[:, s:s + nb]),
                                   torch.tensor(s, dtype=torch.int32))
    worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    _leaves_close(tc, jc, s + nb)

    jdec = jax.jit(jm.decode_step)
    for i in range(n_dec):
        p = s + nb + i
        tok = toks[:, p:p + 1]
        jl, jc = jdec(tree, jc, jnp.asarray(tok), jnp.asarray([p], jnp.int32))
        with torch.no_grad():
            tl, tc = tm.decode_step(params, tc, torch.from_numpy(tok),
                                    torch.tensor([p], dtype=torch.int32))
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
        _leaves_close(tc, jc, p + 1)
    print(f"max |logit diff| = {worst:.3g}")
    assert worst < LOGIT_ATOL, worst


def test_extend_many_equals_chunked_extends(models):
    """The multi-chunk call fills a gap exactly as chunk-by-chunk extends."""
    cfg, _, _, tm, params = models
    rng = np.random.default_rng(1)
    chunk, cap = 16, 96
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 80)).astype(np.int64))
    with torch.no_grad():
        _, base = tm.prefill(params, {"tokens": toks[:, :chunk]})
        a = kv_cache.pad_cache_to(base, cap)
        b = kv_cache.clone_cache(a)
        slots = toks[:, chunk:].reshape(1, 4, chunk)
        la, a, states = tm.prefill_extend_many(params, a, slots,
                                               torch.tensor(chunk, dtype=torch.int32), 3)
        for i in range(3):
            lb, b = tm.prefill_extend(params, b, slots[:, i],
                                      torch.tensor(chunk * (i + 1), dtype=torch.int32))
    assert torch.equal(la, lb)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert all(s.numel() == 0 for s in tree_leaves(states))   # no state leaves


def test_init_layout_and_unported_layers():
    cfg = reduced(get_config("deepseek-67b"))
    tm = LM(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    jparams = JaxLM(jax_reduced(jax_get_config("deepseek-67b"))).init(
        jax.random.PRNGKey(0))
    port_shapes = {}
    tree_map_with_path(lambda path, x: port_shapes.update({path: tuple(x.shape)}),
                       params)
    jax_shapes = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
                  tuple(x.shape)
                  for path, x in jax.tree_util.tree_leaves_with_path(jparams)}
    assert port_shapes == jax_shapes
    assert all(x.dtype == torch.float32 for x in tree_leaves(params))
    np.testing.assert_allclose(float(params["embed"].std()), 0.02, rtol=0.1)
    import dataclasses

    # no layer kind is left unported: an encoder and a vision context add
    # their parameters (tests/test_torch_cross_serve.py runs them)
    specs = param_specs(dataclasses.replace(cfg, encoder_layers=2, vision_context=16))
    assert specs["encoder"]["layers"]["p0"]["mixer"]["wq"].shape == (2, 64, 4, 16)
    assert specs["vision_proj"].shape == (64, 64)
