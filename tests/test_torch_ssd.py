"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssd``) against
``repro.models.ssd`` on the same seeded numpy inputs, fp32 on the CPU.

``ssd_scan`` at one chunk, at several chunks from an ``initial_state``,
and at lengths that are not a multiple of the chunk (``repro``'s rule: a
single chunk); ``_causal_conv``; ``ssd_block`` with and without
``initial`` and its returned (conv, ssm) state; ``ssd_decode`` over a few
tokens from a block's state; ``softplus`` against ``jax.nn.softplus``.

Outputs and states are held to a normwise bound, max|Δ| / max|ref| ≤
``NORMWISE`` (the two packages contract the products in other orders).
Measured on the CPU: outputs at most 1.1e-6 (``ssd_scan`` over a ragged
127-token remainder), states at most 2.1e-6 (``ssd_scan``'s final state at
one chunk of 128).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SSMConfig as JaxSSMConfig  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.models import ssd  # noqa: E402

NORMWISE = 1e-5
D_MODEL = 64


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.array(x))


def _scan_inputs(rng, b, l, h, p, g, n, init):
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    a = (-0.2 * np.abs(rng.standard_normal((b, l, h)))).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if init else None
    return x, a, B, C, st


@pytest.mark.parametrize("l,chunk,g,init", [
    (128, 128, 1, False),     # one chunk (serving: chunk 128 over ssm.chunk 256)
    (128, 32, 1, True),       # four chunks from an initial state
    (64, 32, 2, True),        # two chunks, two groups
    (100, 32, 1, True),       # not a multiple of the chunk: one chunk of 100
    (127, 256, 1, False),     # a ragged serving remainder
], ids=["one-chunk", "four-chunks-init", "groups", "ragged-init", "remainder"])
def test_ssd_scan_matches_reference(l, chunk, g, init):
    rng = np.random.default_rng(l + chunk + g)
    x, a, B, C, st = _scan_inputs(rng, 2, l, 8, 16, g, 16, init)
    jy, jf = jssd.ssd_scan(jnp.asarray(x), jnp.asarray(a), jnp.asarray(B), jnp.asarray(C),
                           chunk, None if st is None else jnp.asarray(st))
    ty, tf = ssd.ssd_scan(_t(x), _t(a), _t(B), _t(C), chunk,
                          None if st is None else _t(st))
    assert ty.shape == (2, l, 8, 16) and tf.shape == (2, 8, 16, 16)
    assert _normwise(ty, jy) <= NORMWISE
    assert _normwise(tf, jf) <= NORMWISE


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(3)
    xbc = rng.standard_normal((2, 40, 160)).astype(np.float32)
    w = rng.standard_normal((4, 160)).astype(np.float32)
    bias = rng.standard_normal((160,)).astype(np.float32)
    want = jssd._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(bias))
    got = ssd._causal_conv(_t(xbc), _t(w), _t(bias))
    assert _normwise(got, want) <= NORMWISE


def test_softplus_is_jax_softplus_past_twenty():
    x = np.array([-40.0, -5.0, 0.0, 3.0, 19.0, 21.0, 35.0, 90.0], np.float32)
    np.testing.assert_allclose(ssd.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-7, atol=0)


def _block_params(rng, cfg):
    d_in, h = cfg.d_inner(D_MODEL), cfg.n_heads(D_MODEL)
    gn = cfg.n_groups * cfg.d_state
    ch = d_in + 2 * gn
    arrays = [
        0.1 * rng.standard_normal((D_MODEL, 2 * d_in + 2 * gn + h)),    # w_in
        0.3 * rng.standard_normal((cfg.conv_width, ch)),                # conv_w
        0.1 * rng.standard_normal((ch,)),                               # conv_b
        rng.uniform(-1.0, 1.0, (h,)),                                   # a_log
        rng.standard_normal((h,)),                                      # d_skip
        rng.uniform(-1.0, 1.0, (h,)),                                   # dt_bias
        1.0 + 0.1 * rng.standard_normal((d_in,)),                       # out_norm
        0.1 * rng.standard_normal((d_in, D_MODEL)),                     # w_out
    ]
    arrays = [x.astype(np.float32) for x in arrays]
    return (ssd.SSDParams(*(_t(x) for x in arrays)),
            jssd.SSDParams(*(jnp.asarray(x) for x in arrays)))


CFG = dict(d_state=16, head_dim=16, chunk=32)


@pytest.mark.parametrize("l,initial", [(64, False), (64, True), (50, True), (32, False)],
                         ids=["two-chunks", "two-chunks-initial", "ragged-initial",
                             "one-chunk"])
def test_ssd_block_and_state_match_reference(l, initial):
    cfg, jcfg = SSMConfig(**CFG), JaxSSMConfig(**CFG)
    rng = np.random.default_rng(10 + l)
    tp, jp = _block_params(rng, cfg)
    x = rng.standard_normal((2, l, D_MODEL)).astype(np.float32)
    init = None
    if initial:
        init = (rng.standard_normal((2, cfg.conv_width - 1, 160)).astype(np.float32),
                rng.standard_normal((2, 8, 16, 16)).astype(np.float32))
    jout, (jconv, jssm) = jssd.ssd_block(
        jp, jcfg, D_MODEL, jnp.asarray(x), return_state=True,
        initial=None if init is None else tuple(map(jnp.asarray, init)))
    tinit = None if init is None else tuple(map(_t, init))
    tout, (tconv, tssm) = ssd.ssd_block(tp, cfg, D_MODEL, _t(x), return_state=True,
                                        initial=tinit)
    assert tconv.shape == (2, 3, 160) and tssm.shape == (2, 8, 16, 16)
    for got, want in ((tout, jout), (tconv, jconv), (tssm, jssm)):
        assert _normwise(got, want) <= NORMWISE
    # without return_state: the same output
    plain = ssd.ssd_block(tp, cfg, D_MODEL, _t(x), initial=tinit)
    assert torch.equal(plain, tout)
    if tinit is not None:    # the returned state is apart from the initial one
        assert tconv.data_ptr() != tinit[0].data_ptr()
        assert tssm.data_ptr() != tinit[1].data_ptr()


def test_ssd_decode_continues_a_block():
    """A 40-token block, then four decode tokens from its state, against
    ``repro``'s: outputs and the last state within the bound; and the
    recurrence's state within the bound of the chunked block's over all 44
    tokens."""
    cfg, jcfg = SSMConfig(**CFG), JaxSSMConfig(**CFG)
    rng = np.random.default_rng(7)
    tp, jp = _block_params(rng, cfg)
    x = rng.standard_normal((2, 44, D_MODEL)).astype(np.float32)
    _, jst = jssd.ssd_block(jp, jcfg, D_MODEL, jnp.asarray(x[:, :40]), return_state=True)
    _, tst = ssd.ssd_block(tp, cfg, D_MODEL, _t(x[:, :40]), return_state=True)
    for i in range(40, 44):
        jout, jst = jssd.ssd_decode(jp, jcfg, D_MODEL, jnp.asarray(x[:, i:i + 1]), jst)
        tout, tst = ssd.ssd_decode(tp, cfg, D_MODEL, _t(x[:, i:i + 1]), tst)
        assert tout.shape == (2, 1, D_MODEL)
        assert _normwise(tout, jout) <= NORMWISE
    for got, want in zip(tst, jst):
        assert _normwise(got, want) <= NORMWISE
    # the recurrence and the chunked block agree on the same four tokens
    _, blk = ssd.ssd_block(tp, cfg, D_MODEL, _t(x), return_state=True)
    for got, want in zip(tst, blk):
        assert _normwise(got, want) <= NORMWISE
