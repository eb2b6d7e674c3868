"""Optimizers (AdamW, factored Adafactor) and the LR schedule.

The counterpart of ``repro.train.optim``: the same formulas, defaults and
state trees (AdamW ``{"m", "v", "count"}``, Adafactor ``{"per_param":
{"vr", "vc"} | {"v"}, "count"}``, moments in fp32 with the parameter tree's
structure), each update computed in fp32 and cast back to the parameter's
dtype.  ``init`` places each moment like its parameter (a ``DTensor``'s
placements; Adafactor's factored moments without the dimension they drop).
``torch.optim.AdamW`` is not this AdamW: its denominator is
``sqrt(v)/sqrt(bc2) + eps`` where ``repro``'s is ``sqrt(v/bc2) + eps``.

``update(grads, state, params, lr)`` writes the new parameters and moments
**in place**, leaf by leaf (an AdamW leaf in slices of ``_SLICE``
elements, so a full-width embedding's fp32 temporaries stay small), and
returns ``(params, state)``; ``state["count"]`` is a new tensor.  In a
sharded program an AdamW leaf updates on each rank's shard, its gradient
laid out as the parameter.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.distributed.sharding import KEEP, local_region, zeros_placed
from repro_torch.models.common import tree_items_sorted, tree_leaves, tree_map_with_path

#: elements per slice of an in-place AdamW update (64 MiB of fp32)
_SLICE = 1 << 24


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state), in place


def global_norm(grads):
    """sqrt of the sum of squares over every leaf, in fp32, the leaves summed
    in ``jax.tree.leaves`` order (dict keys sorted), as ``repro``'s."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_items_sorted(grads)))


def clip_scale(gn, max_norm: float):
    """The factor :func:`clip_by_global_norm` scales every leaf by."""
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return tree_map_with_path(lambda _, g: (g.float() * scale).to(g.dtype), grads), gn


def warmup_cosine(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine to ``min_frac`` of it;
    computed in float32 tensors, as ``jnp`` computes ``repro``'s."""
    def sched(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return sched


def _count(params):
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _flat(x):
    """A leaf as a flat view (``view`` raises on a non-contiguous leaf, which
    an in-place update through a copy would silently leave unchanged)."""
    return x.view(-1)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        def zeros(_, p):
            return zeros_placed(p)
        return {"m": tree_map_with_path(zeros, params),
                "v": tree_map_with_path(zeros, params),
                "count": _count(params)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            _adamw_region(g, m, v, p, bc1, bc2, lr, b1=b1, b2=b2, eps=eps,
                          weight_decay=weight_decay)
        return params, {"m": state["m"], "v": state["v"], "count": count}

    return Optimizer(init, update)


def _adamw_leaf(g, m, v, p, bc1, bc2, lr, *, b1, b2, eps, weight_decay):
    g, m, v, p = _flat(g), _flat(m), _flat(v), _flat(p)
    for lo in range(0, p.numel(), _SLICE):
        sl = slice(lo, lo + _SLICE)
        gs, ms, vs, ps = g[sl].float(), m[sl], v[sl], p[sl]
        ms.mul_(b1).add_((1 - b1) * gs)
        vs.mul_(b2).add_((1 - b2) * gs * gs)
        step = (ms / bc1) / (torch.sqrt(vs / bc2) + eps)
        pf = ps.float()
        ps.copy_(pf - lr * (step + weight_decay * pf))


# moments and parameter keep their layout; the gradient takes the parameter's
_adamw_region = local_region(_adamw_leaf, (3, KEEP, KEEP, KEEP, (), (), ()), ())


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------

def _moment_shapes(shape: tuple) -> dict:
    """Adafactor's second-moment leaves for a parameter of ``shape``: row
    and column means for a matrix (or a stack of them), else one full."""
    return {k: shape[:d] + shape[d + 1:] if d is not None else shape
            for k, d in _moment_drops(len(shape)).items()}


def _moment_drops(ndim: int) -> dict:
    """Each second-moment leaf's dimension of the parameter it drops (None:
    the full moment)."""
    return {"vr": ndim - 1, "vc": ndim - 2} if ndim >= 2 else {"v": None}


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_exp: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def per_param(_, p):
            return {k: zeros_placed(p, d) for k, d in _moment_drops(p.ndim).items()}
        return {"per_param": tree_map_with_path(per_param, params),
                "count": _count(params)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        beta = 1.0 - (count.float() ** -decay_exp)

        def upd(_, p, g, st):
            g = g.float()
            g2 = g * g + eps
            if "vr" in st:
                vr = beta * st["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * st["vc"] + (1 - beta) * g2.mean(-2)
                denom = vr.mean(-1, keepdim=True)
                u = g * torch.rsqrt(vr[..., None] / torch.clamp(denom[..., None], min=eps))
                u = u * torch.rsqrt(vc[..., None, :])
                st["vr"].copy_(vr)
                st["vc"].copy_(vc)
            else:
                v = beta * st["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v)
                st["v"].copy_(v)
            # update clipping (RMS ≤ clip_threshold)
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.float()
            p.copy_(pf - lr * (u + weight_decay * pf))

        tree_map_with_path(upd, params, grads, state["per_param"])
        return params, {"per_param": state["per_param"], "count": count}

    return Optimizer(init, update)


def make_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor()
    raise KeyError(name)


def opt_state_from_jax(cfg, name: str, tree, device="cuda") -> dict:
    """``repro``'s optimizer state for ``cfg``'s parameters as the port's.

    ``tree`` is ``name``'s (``"adamw"`` or ``"adafactor"``) state with numpy
    leaves (``jax.tree.map(np.asarray, opt.init(params))`` or a later
    state); every moment is checked against the parameter's shape and
    placed on ``device`` in fp32, the count as a 0-d int32 tensor.
    """
    from repro_torch.models.lm import param_specs

    def conv(path, x, shape):
        x = np.array(x, np.float32)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} state {'/'.join(map(str, path))}: shape "
                             f"{tuple(x.shape)}, expected {tuple(shape)}")
        return torch.from_numpy(x).to(device)

    specs = param_specs(cfg)
    count = torch.tensor(int(np.asarray(tree["count"])), dtype=torch.int32, device=device)
    if name == "adamw":
        def moments(key):
            return tree_map_with_path(lambda p, s, x: conv((key,) + p, x, s.shape),
                                      specs, tree[key])
        return {"m": moments("m"), "v": moments("v"), "count": count}
    if name == "adafactor":
        def per_param(path, s, st):
            return {k: conv(path + (k,), st[k], shape)
                    for k, shape in _moment_shapes(s.shape).items()}
        return {"per_param": tree_map_with_path(per_param, specs, tree["per_param"]),
                "count": count}
    raise KeyError(name)
