"""The port's ``moe_ffn`` against ``repro.models.moe.moe_ffn``.

Inputs and weights come from ``np.random.default_rng``; both sides run in
fp32 on the CPU.  Held: the output within ``ATOL`` (the expert GEMMs sum in
another order in XLA and torch) and the router aux loss within ``AUX_ATOL``,
at the reduced size (E 8, top-2, capacity factor 16: nothing dropped), with
tokens dropped (capacity factor 1.25 and a router skewed toward one
expert, so the stable sort decides which assignments stay), with router
ties (two experts with identical router columns: the lower index wins, as
in ``jax.lax.top_k``), with shared experts, and at top-6 of 16.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402

#: fp32 outputs, XLA against torch (measured on the CPU: below 1e-6)
ATOL = 1e-5
AUX_ATOL = 1e-6
D = 64


def _weights(rng, cfg: MoEConfig, skew: float = 0.0, tie=None):
    e, ff = cfg.n_experts, cfg.d_ff_expert
    router = 0.3 * rng.standard_normal((D, e))
    router[:, 0] += skew                     # expert 0 favoured
    if tie is not None:
        # with input feature 0 held at 1 (a bias): expert 0 first, experts
        # tie[0] and tie[1] tied for second (identical columns), the rest
        # far below, so the tie sits on the top-2 boundary of every token
        router *= 0.05
        router[0, 0] = 5.0
        router[0, list(tie)] = 2.5
        router[:, tie[1]] = router[:, tie[0]]
    w = dict(router=router,
             w_gate=0.1 * rng.standard_normal((e, D, ff)),
             w_up=0.1 * rng.standard_normal((e, D, ff)),
             w_down=0.1 * rng.standard_normal((e, ff, D)))
    if cfg.n_shared:
        dsh = cfg.d_ff_shared * cfg.n_shared
        w["shared"] = (0.1 * rng.standard_normal((D, dsh)),
                       0.1 * rng.standard_normal((D, dsh)),
                       0.1 * rng.standard_normal((dsh, D)))
    return w


def _params(mod, conv, w):
    shared = None if "shared" not in w else tuple(conv(x) for x in w["shared"])
    return mod.MoEParams(conv(w["router"]),
                         mod.ExpertParams(conv(w["w_gate"]), conv(w["w_up"]),
                                          conv(w["w_down"])), shared)


def _both(cfg, w, x):
    jout, jaux = jax_moe.moe_ffn(_params(jax_moe, lambda a: jnp.asarray(a, jnp.float32), w),
                                 cfg, jnp.asarray(x, jnp.float32))
    tout, taux = moe.moe_ffn(_params(moe, lambda a: torch.from_numpy(np.asarray(a, np.float32)),
                                     w), cfg, torch.from_numpy(np.asarray(x, np.float32)))
    return (np.asarray(jout), float(jaux)), (tout.numpy(), float(taux))


def _assignments(cfg, w, x):
    """Per-expert assignment counts of the port's router (for the drop test)."""
    logits = np.asarray(x, np.float32).reshape(-1, D) @ np.asarray(w["router"], np.float32)
    _, ids = moe.top_k_lower_index(torch.softmax(torch.from_numpy(logits), -1), cfg.top_k)
    return np.bincount(ids.reshape(-1).numpy(), minlength=cfg.n_experts)


REDUCED = MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=0,
                    capacity_factor=16.0)


@pytest.mark.parametrize("case", ["reduced", "drops", "tie", "shared", "top6"])
def test_moe_ffn_matches_reference(case):
    rng = np.random.default_rng(["reduced", "drops", "tie", "shared", "top6"].index(case))
    cfg, skew, tie, shape = REDUCED, 0.0, None, (2, 16, D)
    if case == "drops":
        cfg, skew, shape = dataclasses.replace(REDUCED, capacity_factor=1.25), 0.8, (2, 64, D)
    elif case == "tie":
        tie = (2, 5)
    elif case == "shared":
        cfg = dataclasses.replace(REDUCED, n_shared=2, d_ff_shared=64)
    elif case == "top6":
        cfg = dataclasses.replace(REDUCED, n_experts=16, top_k=6, capacity_factor=1.25)
        shape = (1, 40, D)
    w = _weights(rng, cfg, skew, tie)
    x = rng.standard_normal(shape)
    if tie is not None:
        x[..., 0] = 1.0
    (jout, jaux), (tout, taux) = _both(cfg, w, x)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=ATOL)
    assert abs(taux - jaux) <= AUX_ATOL, (taux, jaux)
    if case == "drops":
        n = shape[0] * shape[1]
        capacity = int(np.ceil(n * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
        assert _assignments(cfg, w, x).max() > capacity    # something dropped
    if case == "tie":
        # every token took expert 0 and the lower of the tied pair
        counts = _assignments(cfg, w, x)
        n = shape[0] * shape[1]
        assert counts[0] == counts[2] == n and counts[5] == 0, counts


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_ties_go_to_the_lower_index(k):
    """``jax.lax.top_k``'s order on rows full of ties."""
    x = np.array([[0.2, 0.5, 0.5, 0.1, 0.5, 0.2],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                  [0.0, 0.3, 0.0, 0.3, 0.0, 0.3]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = moe.top_k_lower_index(torch.from_numpy(x), k)
    assert ti.tolist() == np.asarray(ji).tolist()
    assert tv.tolist() == np.asarray(jv).tolist()


def test_moe_ffn_is_bitwise_repeatable_and_refuses_groups():
    """Two calls give bitwise the same output and aux, ungrouped and at 2
    and 4 groups; groups that do not split the tokens evenly are refused."""
    rng = np.random.default_rng(9)
    cfg = dataclasses.replace(REDUCED, capacity_factor=1.25)
    w = _weights(rng, cfg, 0.5)
    p = _params(moe, lambda a: torch.from_numpy(np.asarray(a, np.float32)), w)
    x = torch.from_numpy(rng.standard_normal((2, 32, D)).astype(np.float32))
    for groups in (1, 2, 4):
        a, aux_a = moe.moe_ffn(p, cfg, x, groups=groups)
        b, aux_b = moe.moe_ffn(p, cfg, x, groups=groups)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b), groups
    with pytest.raises(ValueError, match="groups"):
        moe.moe_ffn(p, cfg, x, groups=3)


#: grouped dispatch, XLA against torch: the output (measured on the CPU:
#: below 1e-6) and the aux relative to its value, one fp32 ulp (an aux near
#: 1.26 has an ulp of 1.19e-7, and the router logits already differ by a
#: few 1e-6 between XLA's and torch's matmuls, so no absolute 1e-7 holds)
GROUPED_ATOL = 1e-6
GROUPED_AUX_RTOL = 1e-7


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("case", ["drops", "shared"])
def test_grouped_moe_matches_reference(groups, case):
    """``moe_ffn(groups=G)`` against ``repro``'s ``_moe_ffn_grouped``: each
    group routed on its own (per-group capacity), with tokens dropped
    (capacity factor 1.25, a skewed router) and with shared experts; the
    output within ``GROUPED_ATOL``, the aux (mean over groups) within
    ``GROUPED_AUX_RTOL`` of its value, and every group's sorted experts, slots, kept
    slots and token order equal to ``repro``'s ``_dispatch_group``."""
    rng = np.random.default_rng(100 + groups)
    cfg = dataclasses.replace(REDUCED, capacity_factor=1.25)
    if case == "shared":
        cfg = dataclasses.replace(cfg, n_shared=2, d_ff_shared=64)
    w = _weights(rng, cfg, 0.8)
    x = rng.standard_normal((2, 64, D))
    jp = _params(jax_moe, lambda a: jnp.asarray(a, jnp.float32), w)
    tp = _params(moe, lambda a: torch.from_numpy(np.asarray(a, np.float32)), w)
    jout, jaux = jax_moe.moe_ffn(jp, cfg, jnp.asarray(x, jnp.float32), groups=groups)
    tout, taux = moe.moe_ffn(tp, cfg, torch.from_numpy(np.asarray(x, np.float32)),
                             groups=groups)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=GROUPED_ATOL)
    assert abs(float(taux) - float(jaux)) <= GROUPED_AUX_RTOL * abs(float(jaux)), \
        (float(taux), float(jaux))
    xt = np.asarray(x, np.float32).reshape(groups, -1, D)
    dropped = 0
    for g in range(groups):
        _, se, slot, keep, tix, _, _ = jax_moe._dispatch_group(
            cfg, jp.router, jnp.asarray(xt[g]))
        r = moe.route(cfg, tp.router, torch.from_numpy(xt[g]))
        assert r.sorted_expert.tolist() == np.asarray(se).tolist()
        assert r.slot.tolist() == np.asarray(slot).tolist()
        assert r.keep.tolist() == np.asarray(keep).tolist()
        assert r.token_idx.tolist() == np.asarray(tix).tolist()
        dropped += int((~r.keep).sum())
    assert dropped > 0                                   # something dropped
