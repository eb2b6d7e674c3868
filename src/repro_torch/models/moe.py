"""Feed-forward layers: the dense MLP and the routed mixture of experts,
SwiGLU (gate ⊙ up) or one activation of ``common.activation_fn``.

The counterpart of ``repro.models.moe``.  ``moe_ffn`` is ``repro``'s
top-k routing with a capacity-bucketed dispatch: assignments are sorted by
expert and scattered into a fixed ``(E, capacity, d)`` buffer, both expert
GEMMs run block-dense (``torch.bmm``; no kernel in ``repro`` either), and
overflow assignments are dropped (GShard-style capacity factor).

Every step is deterministic on the card, so a replayed request gives
bitwise the same tokens:

* top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
  does (a stable descending sort; ``torch.topk`` promises no order);
* the sort by expert is stable, as ``jnp.argsort``, so the drop order is
  ``repro``'s;
* the dispatch writes each kept (expert, slot) once, dropped assignments
  to one spare row that is never read;
* the combine gathers each token's k weighted outputs to ``(n, k, d)`` and
  sums them in ascending expert order, the order of ``repro``'s scatter-add
  on the CPU, with no atomic ``index_add_``.

With ``groups > 1`` each group of tokens is routed on its own, under the
same rules (``repro``'s expert-parallel dispatch, as a loop over groups).

Beside ``repro``'s router (the defaults of ``MoEConfig``) the config can
select DeepSeek-V2's (HF ``DeepseekV2MoEGate``): ``group_limited_greedy``
routing, the top ``topk_group`` of ``n_group`` groups by their best
expert's score, then the top-k among their experts, with the softmax
scores times ``routed_scaling_factor`` as gates where ``norm_topk_prob``
is false.  ``capacity_factor=None`` is dropless: every expert's bucket
holds all n tokens of its group (a token picks an expert at most once), a
size known without looking at the routing, so no host sync and a decode
step still captures into a CUDA graph.  ``experts_held=(e0, count)`` is
one device's share of an expert-parallel layer: the expert leaves hold
those ``count`` experts, the router all of them; every token is routed
over all, and the layer gives the part of the output that its own
experts give (the masking of the sharded path below), plus the shared
experts.  No exchange runs and nothing stands in for the absent devices.

``moe_ffn`` runs under the span ``serve.moe``.

In a sharded program (``DTensor`` s inside ``use_rules``) a rank holds the
experts of its ``experts`` shard and their ``ff`` slices: it gathers every
token, routes them all (the same global routing, capacity and drops), runs
its own experts on their kept assignments, and the ranks sum their outputs
by all-reduce over ``experts`` and ``ff``.  The shared experts run as
plain sharded products.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.sharding import (active, all_reduce_over, constrain, local_region,
                                              mesh_coords, once_over)

from .common import activation_fn, dense


class ExpertParams(NamedTuple):
    w_gate: torch.Tensor   # (E, d, ff)
    w_up: torch.Tensor     # (E, d, ff)
    w_down: torch.Tensor   # (E, ff, d)


class MoEParams(NamedTuple):
    router: torch.Tensor   # (d, E)
    experts: ExpertParams
    shared: Optional[tuple] = None  # (w_gate, w_up, w_down) of the shared experts


def top_k_lower_index(x, k: int):
    """(values, indices) of the k largest entries along the last axis, in
    descending order, ties to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn(tokens, w_gate, w_up, w_down, activation: str):
    """tokens (E, C, d) → (E, C, d) via per-expert matmuls."""
    if activation == "swiglu":
        h = F.silu(torch.bmm(tokens, w_gate)) * torch.bmm(tokens, w_up)
    else:
        h = activation_fn(activation)(torch.bmm(tokens, w_up))
    return torch.bmm(h, w_down)


class Route(NamedTuple):
    """One group's routing, in stable expert order (assignment ``i`` of
    the sorted order is token ``token_idx[i]``'s ``rank[i]``-th lowest
    expert ``sorted_expert[i]``, in bucket slot ``slot[i]``; ``keep``
    is false for the assignments past the expert's capacity)."""
    sorted_expert: torch.Tensor   # (n·k,)
    slot: torch.Tensor            # (n·k,)
    keep: torch.Tensor            # (n·k,) bool
    token_idx: torch.Tensor       # (n·k,)
    rank: torch.Tensor            # (n·k,)
    gates: torch.Tensor           # (n·k,) fp32 gate weights, sorted order
    capacity: int
    aux: torch.Tensor             # router load-balance loss, fp32 0-d


def select_experts(cfg: MoEConfig, probs):
    """(gates, expert ids), each (n, k), from the router's softmax scores
    ``probs`` (n, E), ties to the lower index.  ``greedy``: the top-k of
    all; ``group_limited_greedy``: the top-k of the experts in the top
    ``topk_group`` groups, a group's score its best expert's, the other
    groups' scores zeroed.  Gates renormalised to sum to one
    (``norm_topk_prob``), else the scores times ``routed_scaling_factor``."""
    k = cfg.top_k
    if cfg.topk_method == "group_limited_greedy":
        n, e = probs.shape
        by_group = probs.view(n, cfg.n_group, e // cfg.n_group)
        _, groups = top_k_lower_index(by_group.amax(-1), cfg.topk_group)    # (n, topk_group)
        kept = torch.zeros_like(by_group[..., 0], dtype=torch.bool).scatter_(1, groups, True)
        scores = torch.where(kept[..., None], by_group, 0.0).view(n, e)
    elif cfg.topk_method == "greedy":
        scores = probs
    else:
        raise ValueError(f"unknown topk_method {cfg.topk_method!r}")
    gate_vals, expert_ids = top_k_lower_index(scores, k)                  # (n, k)
    if cfg.norm_topk_prob:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    else:
        gate_vals = gate_vals * cfg.routed_scaling_factor
    return gate_vals, expert_ids


def route(cfg: MoEConfig, router, xt) -> Route:
    """Top-k routing of one group's tokens ``xt`` (n, d): ``repro``'s
    ``_dispatch_group`` without the buffer, capacity
    ``max(ceil(n·k·cf / E), 4)`` for the group's own n, or n (dropless,
    ``capacity_factor`` None)."""
    n = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = dense(xt.float(), router.float())                            # (n, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = select_experts(cfg, probs)

    # load-balance aux loss (Switch): E · Σ_e f_e · p_e
    me = probs.mean(0)
    flat_expert = expert_ids.reshape(-1)                                   # (n·k,)
    # whole counts: exact in any order (bincount would wait for the card)
    ce = probs.new_zeros(e).scatter_add_(0, flat_expert, torch.ones_like(
        flat_expert, dtype=probs.dtype)) / (n * k)
    aux = e * torch.sum(me * ce)

    if cfg.capacity_factor is None:
        capacity = n
    else:
        capacity = max(int(math.ceil(n * k * cfg.capacity_factor / e)), 4)
    # position of each assignment within its expert's bucket
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    slot = (torch.arange(n * k, device=xt.device)
            - torch.searchsorted(sorted_expert, sorted_expert))
    rank = torch.argsort(torch.argsort(expert_ids, dim=-1), dim=-1).reshape(-1)
    return Route(sorted_expert, slot, slot < capacity, order // k, rank[order],
                 gate_vals.reshape(-1)[order], capacity, aux)


def _dispatch(r: Route, xt, buf, e: int):
    """Write each kept assignment's token into row ``e·capacity + slot`` of
    ``buf`` (``(e·capacity + 1, d)``; dropped assignments go to the spare
    last row); returns the rows."""
    dest = torch.where(r.keep, r.sorted_expert * r.capacity + r.slot, e * r.capacity)
    buf[dest] = xt[r.token_idx]
    return dest


def _combine(r: Route, out_buf, dest, xt, k: int):
    """Each token's k weighted expert outputs from ``out_buf`` (E, C, d),
    summed without atomics: assignment (token t, its j-th lowest expert)
    lands at row t·k + j, then the k rows sum in that order."""
    n, d = xt.shape
    e, capacity = out_buf.shape[:2]
    gathered = out_buf.reshape(e * capacity, d)[torch.where(r.keep, dest, 0)]
    gathered = torch.where(r.keep[:, None], gathered, 0.0)
    weighted = (gathered * r.gates[:, None]).to(xt.dtype)
    contrib = xt.new_empty((n * k, d))
    contrib[r.token_idx * k + r.rank] = weighted
    contrib = contrib.view(n, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def moe_ffn(p: MoEParams, cfg: MoEConfig, x, *, activation: str = "swiglu",
            groups: int = 1):
    """x (B, S, d) → ((B, S, d), router aux loss).

    ``groups > 1`` is ``repro``'s expert-parallel dispatch: the B·S tokens
    split into ``groups`` equal groups in order, each routed on its own
    (its own capacity, drops and combine), and the aux loss is the mean
    over groups.  ``repro`` shards the groups over a mesh; here they run
    one after another on one device.
    """
    with obs.span("serve.moe"):
        if active() is not None:
            if cfg.experts_held is not None:
                raise ValueError("experts_held is the plain path's share; a sharded "
                                 "program takes its experts from the mesh")
            out, aux = _sharded_region(x, p.router, *p.experts, cfg=cfg,
                                       activation=activation, groups=groups, plain_params=p)
            if p.shared is None or not hasattr(out, "placements"):
                return out, aux
            return out + _shared_ffn(p.shared, x, activation), aux
        return _moe_ffn(p, cfg, x, activation, groups)


def _moe_ffn(p: MoEParams, cfg: MoEConfig, x, activation: str, groups: int):
    if groups > 1:
        return _moe_ffn_grouped(p, cfg, x, activation, groups)
    b, s, d = x.shape
    n = b * s
    e = cfg.n_experts
    xt = x.reshape(n, d)
    r = route(cfg, p.router, xt)
    if cfg.experts_held is not None:
        e0, e_loc = cfg.experts_held
        if p.experts.w_gate.shape[0] != e_loc:
            raise ValueError(f"experts_held {cfg.experts_held} but the expert leaves hold "
                             f"{p.experts.w_gate.shape[0]} experts")
        out = _held_part(r, xt, *p.experts, e0, e_loc, activation, cfg.top_k)
    else:
        buf = xt.new_zeros((e * r.capacity + 1, d))
        dest = _dispatch(r, xt, buf, e)
        buf = constrain(buf[:-1].view(e, r.capacity, d), "experts", None, None)
        out_buf = _expert_ffn(buf, p.experts.w_gate, p.experts.w_up, p.experts.w_down,
                              activation)
        out_buf = constrain(out_buf, "experts", None, None)
        out = _combine(r, out_buf, dest, xt, cfg.top_k)
    if p.shared is not None:
        out = out + _shared_ffn(p.shared, xt, activation)
    return out.reshape(b, s, d), r.aux


def _moe_ffn_grouped(p: MoEParams, cfg: MoEConfig, x, activation: str, groups: int):
    """``moe_ffn`` over ``groups`` groups: the dispatch buffers stack to
    (G, E, C, d) (every group has the same capacity) where ``repro``
    re-shards them, and each group's expert products run on its own slice."""
    b, s, d = x.shape
    n = b * s
    if n % groups:
        raise ValueError(f"{n} tokens do not split into {groups} MoE groups")
    if cfg.experts_held is not None:
        raise ValueError("experts_held runs with moe_groups 1")
    e = cfg.n_experts
    n_loc = n // groups
    xg = constrain(x.reshape(groups, n_loc, d), "moe_groups", None, None)
    routes = [route(cfg, p.router, xg[g]) for g in range(groups)]
    capacity = routes[0].capacity
    bufs = xg.new_zeros((groups, e * capacity + 1, d))
    dests = [_dispatch(r, xg[g], bufs[g], e) for g, r in enumerate(routes)]
    buf = bufs[:, :-1].view(groups, e, capacity, d)
    buf = constrain(buf, "moe_groups", None, None, None)
    buf = constrain(buf, None, "experts", None, None)
    out_buf = torch.stack([_expert_ffn(buf[g], p.experts.w_gate, p.experts.w_up,
                                       p.experts.w_down, activation)
                           for g in range(groups)])
    out_buf = constrain(out_buf, None, "experts", None, None)
    out_buf = constrain(out_buf, "moe_groups", None, None, None)
    out = torch.cat([_combine(r, out_buf[g], dests[g], xg[g], cfg.top_k)
                     for g, r in enumerate(routes)])
    if p.shared is not None:
        out = out + _shared_ffn(p.shared, x.reshape(n, d), activation)
    return out.reshape(b, s, d), torch.stack([r.aux for r in routes]).mean()


def _moe_plain(x, router, w_gate, w_up, w_down, *, cfg, activation, groups, plain_params):
    return _moe_ffn(plain_params, cfg, x, activation, groups)


def _moe_sharded(x, router, w_gate, w_up, w_down, *, cfg, activation, groups, plain_params):
    """One rank's part of the routed experts over every token (see the
    module docstring): (its output summed over the ranks, the aux loss)."""
    rules, mesh = active()
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    e_entry = rules.rules.get("experts") if w_gate.shape[0] < e else None
    f_entry = rules.rules.get("ff") if w_gate.shape[2] < cfg.d_ff_expert else None
    e_loc = w_gate.shape[0]
    e0 = e_loc * mesh_coords(mesh, e_entry)[0]
    if n % groups:
        raise ValueError(f"{n} tokens do not split into {groups} MoE groups")
    xg = x.reshape(groups, n // groups, d)
    outs, auxes = [], []
    for g in range(groups):
        xt = xg[g]
        r = route(cfg, router, xt)
        outs.append(_held_part(r, xt, w_gate, w_up, w_down, e0, e_loc, activation, k))
        auxes.append(r.aux)
    out = all_reduce_over(torch.cat(outs).reshape(b, s, d), "sum", e_entry)
    out = all_reduce_over(out, "sum", f_entry)
    # every rank of the split computes the whole aux loss from the replicated
    # router and tokens: its gradient reaches them once, not once a rank
    aux = auxes[0] if groups == 1 else torch.stack(auxes).mean()
    return out, once_over(aux, e_entry, f_entry)


def _held_part(r: Route, xt, w_gate, w_up, w_down, e0: int, e_loc: int, activation: str,
               k: int):
    """The part of each token's output (n, d) that experts [e0, e0 + e_loc)
    give, whose leaves ``w_*`` hold just those: their kept assignments in
    (e_loc, capacity) buckets, the others to one spare row never read."""
    d = xt.shape[1]
    mine = r.keep & (r.sorted_expert >= e0) & (r.sorted_expert < e0 + e_loc)
    spare = e_loc * r.capacity
    dest = torch.where(mine, (r.sorted_expert - e0) * r.capacity + r.slot, spare)
    buf = xt.new_zeros((spare + 1, d))
    buf[dest] = xt[r.token_idx]
    out_buf = _expert_ffn(buf[:-1].view(e_loc, r.capacity, d), w_gate, w_up, w_down,
                          activation)
    return _combine(r._replace(keep=mine), out_buf, dest, xt, k)


_EXPERT_IN = ("experts", None, "ff")
_sharded_region = local_region(
    _moe_sharded, ((None, None, None), (None, None), _EXPERT_IN, _EXPERT_IN,
                   ("experts", "ff", None)),
    ((None, None, None), ()), plain=_moe_plain)


def _shared_ffn(shared, xt, activation: str):
    w_gate, w_up, w_down = shared
    if activation == "swiglu":
        h = F.silu(dense(xt, w_gate)) * dense(xt, w_up)
    else:
        h = activation_fn(activation)(dense(xt, w_up))
    return dense(h, w_down)


def dense_ffn(params: dict, x, activation: str):
    """Plain MLP; ``params`` has w_up/w_down and (for swiglu) w_gate."""
    if activation == "swiglu":
        h = F.silu(dense(x, params["w_gate"])) * dense(x, params["w_up"])
    else:
        h = activation_fn(activation)(dense(x, params["w_up"]))
    return dense(h, params["w_down"])
