"""Closed-loop sessions over ``SessionManager`` for an MLA + MoE decoder
(DeepSeek-V2 on one device's share of its experts).

The traffic, the closed loop, the window's samples and the sample the check
takes are ``serve_sessions``' own (``Load``, ``Loop``, ``window_record``,
``sample``); this module brings what differs for this family: the port's
``ArchConfig`` (MLA, the published router, dropless held experts, YaRN),
the weights (only the held experts are drawn), model FLOPs, and the check
against ``bench/reference/deepseek_v2.py``.

The ``ArchConfig`` is built before any weight is drawn, so a program whose
``MoEConfig`` lacks the router's fields fails within seconds.

In the traced window the program's spans are on (``bench/spans.py``):
the record keeps their totals (``spans``) and the profiler's events are
summarised with ``spans.summarize``, so device seconds are kept by the
innermost program span that launched them (``device_by_program_span``).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from bench import core, spans
from bench import trace as tr
from bench.reference import deepseek_v2 as ref

base = core.driver("serve_sessions")
Load, Loop, window_record, sample = base.Load, base.Loop, base.window_record, base.sample

#: the reference's short names of the configuration's sizes
arch = ref.arch


def arch_config(config: dict):
    """The port's ``ArchConfig`` for the configuration file: MLA with YaRN,
    a leading dense layer, then MoE layers under the published router,
    dropless, holding the file's ``n_routed_experts`` experts from
    ``experts_held_from``."""
    from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, RopeScaling

    if config["hidden_act"] != "silu" or config.get("tie_word_embeddings", False):
        raise ValueError("the mla_moe driver runs untied SwiGLU (silu) decoders")
    if config["scoring_func"] != "softmax" or config["moe_layer_freq"] != 1:
        raise ValueError("the mla_moe driver runs softmax routers on every layer past the "
                         "leading dense ones")
    a = arch(config)
    rs = a["rope_scaling"]
    if rs and rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling {rs.get('type')!r}: the port implements yarn")
    moe = MoEConfig(
        n_experts=a["experts"], top_k=a["top_k"], d_ff_expert=a["ff_e"],
        n_shared=a["shared"], d_ff_shared=a["ff_e"],
        first_dense_layers=config["first_k_dense_replace"], capacity_factor=None,
        topk_method=a["topk_method"], n_group=a["n_group"], topk_group=a["topk_group"],
        norm_topk_prob=a["norm_topk"], routed_scaling_factor=float(a["scale"]),
        experts_held=a["held"])
    scaling = None if not rs else RopeScaling(
        factor=float(rs["factor"]),
        original_max_position_embeddings=int(rs["original_max_position_embeddings"]),
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
        mscale=float(rs["mscale"]), mscale_all_dim=float(rs["mscale_all_dim"]))
    return ArchConfig(
        name=config["name"], family="moe", n_layers=config["num_hidden_layers"],
        d_model=a["d"], n_heads=a["h"], n_kv_heads=a["h"], head_dim=a["v"], d_ff=a["ff"],
        vocab_size=a["vocab"], activation="swiglu", rope_theta=float(a["theta"]),
        norm_eps=a["eps"], rope_scaling=scaling,
        mla=MLAConfig(q_lora_rank=a["q_lora"], kv_lora_rank=a["kv_lora"],
                      qk_nope_head_dim=a["nope"], qk_rope_head_dim=a["rope"],
                      v_head_dim=a["v"]),
        moe=moe, param_dtype="bfloat16", compute_dtype="bfloat16")


def draw_weights(config: dict, seed: int, device, cfg=None) -> dict:
    """Random weights from the seed, drawn on ``device`` in bf16, one call
    per stacked leaf, in the port's parameter layout (its ``param_specs``,
    so the expert leaves hold only the held experts): matrices N(0,
    init_std²), the output projections scaled by layers^-½, norms one."""
    from repro_torch.models.common import tree_map_with_path
    from repro_torch.models.lm import param_specs

    cfg = arch_config(config) if cfg is None else cfg
    g = torch.Generator(device=device).manual_seed(seed % 2**63)
    std = float(config["assumed"]["init_std"])

    def draw(_, s):
        if s.init == "ones":
            return torch.ones(s.shape, dtype=torch.bfloat16, device=device)
        if s.init != "normal":
            raise ValueError(f"no draw for init {s.init!r}")
        return torch.empty(s.shape, dtype=torch.bfloat16, device=device).normal_(
            0.0, std * s.scale, generator=g)

    return tree_map_with_path(draw, param_specs(cfg))


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------

def layer_weights(a: dict) -> dict:
    """Matrix parameters a token runs through, by part: MLA's projections
    (the latent's expansion counted once a token), the dense layer's MLP,
    and a MoE layer's router, shared experts and one routed expert."""
    d, h = a["d"], a["h"]
    qk = a["nope"] + a["rope"]
    return {"mla": d * a["q_lora"] + a["q_lora"] * h * qk + d * (a["kv_lora"] + a["rope"])
            + a["kv_lora"] * h * (a["nope"] + a["v"]) + h * a["v"] * d,
            "dense": 3 * d * a["ff"], "router": d * a["experts"],
            "shared": 3 * d * a["ff_e"] * a["shared"], "expert": 3 * d * a["ff_e"]}


def span_flops(a: dict, layers: int, dense_layers: int, *, start: int, n: int,
               heads_out: int = 1) -> float:
    """Model FLOPs of ``n`` tokens at positions [start, start + n) of one
    row: every layer's MLA (its projections, and q·k over nope + rope and
    p·v over each key up to the token's own), the dense layers' MLP, and on
    each MoE layer the router, the shared experts and this device's expected
    share of the routed ones, top_k × held / experts a token; plus the
    output head at ``heads_out`` positions."""
    w = layer_weights(a)
    keys = n * start + n * (n + 1) // 2
    attn = 2.0 * a["h"] * (a["nope"] + a["rope"] + a["v"]) * keys
    per_mla = 2.0 * w["mla"] * n + attn
    routed = a["top_k"] * a["held"][1] / a["experts"]
    per_moe = 2.0 * n * (w["router"] + w["shared"] + routed * w["expert"])
    return (layers * per_mla + dense_layers * 2.0 * w["dense"] * n
            + (layers - dense_layers) * per_moe + 2.0 * a["d"] * a["vocab"] * heads_out)


class ModelCalls(base.ModelCalls):
    """``serve_sessions.ModelCalls`` with this family's FLOPs."""

    def __init__(self, model, config: dict) -> None:
        super().__init__(model)
        self.a = arch(config)
        self.layers = config["num_hidden_layers"]
        self.dense = config["first_k_dense_replace"]

    def flops(self) -> float:
        total = 0.0
        for kind, b, n, where in self.calls:
            if kind == "decode":
                for p in where.reshape(-1).tolist():
                    total += span_flops(self.a, self.layers, self.dense, start=int(p), n=1)
                continue
            start = 0 if kind == "prefill" else int(where.reshape(-1)[0])
            total += b * span_flops(self.a, self.layers, self.dense, start=start, n=n)
        return total


class SpanTrace(tr.DeviceTrace):
    """``trace.DeviceTrace`` whose summary keeps device seconds by program
    span (``spans.summarize``)."""

    def __exit__(self, *exc):
        core.sync(self.device)
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        self.launches = {k: v - self._launches0.get(k, 0)
                         for k, v in tr.kernel_counts().items()}
        if exc[0] is None:
            self.summary = spans.summarize(self._prof.profiler.kineto_results.events())
        return False


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def build(config: dict, seed: int, device):
    """The model (its ``ArchConfig`` first: a program without the router's
    fields fails here, before a weight is drawn) and the drawn weights."""
    from repro_torch.models.lm import LM

    cfg = arch_config(config)
    model = LM(cfg, device=device)
    return model, draw_weights(config, seed, device, cfg)


def run(*, config: dict, traffic: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, judge=None) -> dict:
    """``serve_sessions.run`` for this family: set up, measure for
    ``seconds``, check the served tokens (``judge``, by default
    :func:`check`)."""
    device = torch.device(device)
    a = arch(config)
    model, params = build(config, seed, device)
    mgr = base.manager(model, params, config)
    load = Load(traffic, a["vocab"], seed)
    for doc in load.docs:
        sid = mgr.add_session(doc)
        mgr.submit(sid, len(doc), 1)
        mgr.run()
        mgr.close_session(sid)
    loop = Loop(mgr, load, traffic["clients"])
    t_warm = time.perf_counter() + traffic["warmup_s"]
    while time.perf_counter() < t_warm or any(r is None or not r.out for r in loop.req):
        loop.tick()
    core.sync(device)
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    n_fin0 = len(loop.finished)
    steps0 = len(loop.steps)
    sched0 = dataclasses.replace(mgr.sched)
    agg0 = mgr.aggregate_stats()
    ev0 = mgr.store.evictions
    summary, launches, kernel_launches, model_flops, span_totals = {}, {}, {}, None, {}
    t_end = w0 + seconds
    if trace:
        loop.run_until(t_end - traffic["trace_s"])
        with tr.launch_log() as llog, ModelCalls(model, config) as calls, \
                spans.program_spans() as span_totals, SpanTrace(device) as dt:
            loop.span = True
            loop.run_until(time.perf_counter() + traffic["trace_s"])
            loop.span = False
        summary, kernel_launches = dt.summary, dt.launches
        launches = llog.resolved()
        model_flops = calls.flops()
        del calls, dt
    else:
        loop.run_until(t_end)
    core.sync(device)
    w1 = loop.steps[-1][1]
    sched, agg = mgr.sched, mgr.aggregate_stats()
    rec = window_record(loop, w0, w1, n_fin0, steps0)
    rec.update(setup_s=setup_s, summary=summary, launches=launches, spans=span_totals,
               kernel_launches=kernel_launches, model_flops=model_flops, arch=a)
    rec["counts"].update(
        decode_rows=sched.decode_rows - sched0.decode_rows,
        decode_calls=sched.decode_calls - sched0.decode_calls,
        tokens_reused=agg.tokens_reused - agg0.tokens_reused,
        tokens_computed=agg.tokens_computed - agg0.tokens_computed,
        requests=agg.requests - agg0.requests,
        planner_s=agg.planner_s - agg0.planner_s,
        evictions=mgr.store.evictions - ev0, store_bytes=mgr.store.nbytes())
    # a request that fails raises out of the run, so none is counted failed
    rec["counts"].update(attempted=rec["counts"]["requests"], failed=0)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    finished = loop.finished[n_fin0:]
    del loop, mgr, model
    core.free(device)
    t_check = time.perf_counter()
    rec["check"] = (judge or check)(config, params, finished, traffic, limits, seed, device)
    rec["check_s"] = time.perf_counter() - t_check
    return rec


def _mean(gaps) -> float:
    flat = [g for req in gaps for g in req]
    return sum(flat) / len(flat)


def check(config, params, finished, traffic, limits, seed, device) -> dict:
    """The mean gap by which a served token's logit lies below the fp32
    reference's best, over every served token of a sample of the window's
    finished requests (the widest gap beside it, for the record).

    The mean and not the widest: at 30 layers rounding flips some routing
    decisions, and each flip moves the stream after it, so a bf16 program's
    widest gap (1.95–5.77 on the card) reaches the fp8 control's
    (4.65–7.89), while their means stay apart (0.12–0.18 against
    1.20–1.36; PERF.md §6)."""
    picked = sample(finished, traffic["check_requests"], seed)
    if not picked:
        return {"correct": False, "numbers": {}, "why": "no request finished in the window"}
    seqs = [(r.prompt, r.out) for r in picked]
    gaps = ref.served_gaps(params, arch(config), seqs, device=device)
    mean = _mean(gaps)
    lim = limits["mean_logit_gap"]
    return {"correct": bool(mean <= lim),
            "numbers": {"mean_logit_gap": {"value": mean, "limit": lim}},
            "widest_gap": max(max(g) for g in gaps),
            "sampled_requests": len(picked), "served_tokens": sum(len(r.out) for r in picked)}


def control_judge(config, params, finished, traffic, limits, seed, device) -> dict:
    """The check beside its control: over the same sample, the fp8
    forward's gaps (``bench/controls.py``'s serving judge for this family)."""
    picked = sample(finished, traffic["check_requests"], seed)
    seqs = [(r.prompt, r.out) for r in picked]
    a = arch(config)
    prog = ref.served_gaps(params, a, seqs, device=device)
    ctrl = ref.control_gaps(params, a, seqs, device=device)
    lim = limits["mean_logit_gap"]
    return {"correct": _mean(prog) <= lim,
            "numbers": {"mean_logit_gap": {"value": _mean(prog), "limit": lim}},
            "control": {"mean_logit_gap": _mean(ctrl), "widest_gap": max(max(g) for g in ctrl)},
            "control_fails": _mean(ctrl) > lim, "widest_gap": max(max(g) for g in prog),
            "served_tokens": sum(len(r.out) for r in picked)}
