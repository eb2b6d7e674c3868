"""Plain fp32 reference of DeepSeek-V2 (arXiv:2405.04434, the published
``modeling_deepseek.py``) on one device's share of its experts: RMSNorm,
Multi-head Latent Attention with K/V expanded from the latent, YaRN rotary
embeddings on the decoupled rope part, a causal softmax scaled by
(nope + rope)^-½ · mscale², a leading dense SwiGLU layer, then MoE layers:
the group-limited greedy router over all routed experts (softmax scores,
the top ``topk_group`` of ``n_group`` groups by their best expert, the top
k inside them, gates the scores times ``routed_scaling_factor``), the part
of the output that the held experts give, dropless, plus the shared
experts; an untied output head.

It reads only the weights the benchmark drew (bf16, taken to fp32 layer by
layer, in the port's parameter layout) and the tokens, and imports nothing
of the program.  Matrix products run in fp32 with TF32 off.  One departure
from the checkpoint, by construction: HF stores the rope columns of
``q_b_proj`` and ``kv_a_proj_with_mqa`` interleaved and de-interleaves them
before rotating halves; here they rotate as halves directly, which with
drawn weights is only a permutation of those columns of ``w_uq`` and
``w_dkv``.

``quant="fp8"`` is the control: the same forward with every matrix and
every matrix product's input rounded to float8 e4m3 (weights per output
channel, activations per token), as an fp8 serving path would, the router
included; the attention scores and the softmaxes stay fp32.

Sequences run together layer by layer, each layer's weights taken to fp32
once; attention runs in blocks of queries and MLPs in blocks of rows, so
8k positions at the published widths fit beside the bf16 weights.
"""
from __future__ import annotations

import contextlib
import math

import torch

#: queries per attention block (128 heads × 256 × 8k keys × 4 B ≈ 1 GB of
#: scores) and rows per MLP block
Q_BLOCK = 256
ROWS = 2048
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the duration (restored after)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per slice along ``dim`` (the
    slice's largest magnitude maps to the format's largest), back in fp32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def arch(config: dict) -> dict:
    """The published sizes under short names, the experts held here, and
    YaRN's constants."""
    rs = config.get("rope_scaling")
    held = config["n_routed_experts"]
    e0 = config["experts_held_from"]
    return {"d": config["hidden_size"], "h": config["num_attention_heads"],
            "q_lora": config["q_lora_rank"], "kv_lora": config["kv_lora_rank"],
            "nope": config["qk_nope_head_dim"], "rope": config["qk_rope_head_dim"],
            "v": config["v_head_dim"], "ff": config["intermediate_size"],
            "ff_e": config["moe_intermediate_size"], "shared": config["n_shared_experts"],
            "experts": config["published"]["n_routed_experts"], "held": (e0, held),
            "top_k": config["num_experts_per_tok"], "n_group": config["n_group"],
            "topk_group": config["topk_group"], "scale": config["routed_scaling_factor"],
            "norm_topk": config["norm_topk_prob"], "topk_method": config["topk_method"],
            "vocab": config["vocab_size"], "eps": config["rms_norm_eps"],
            "theta": config["rope_theta"], "rope_scaling": rs}


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(dim: int, theta: float, rs) -> tuple[torch.Tensor, float]:
    """(inverse frequencies (dim/2,) fp64, the cos/sin gain) of YaRN as the
    published modelling code builds them; plain RoPE without ``rs``."""
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    if not rs:
        return 1.0 / base, 1.0

    def corr(rot):
        return dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) \
            / (2 * math.log(theta))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    inv = (1.0 / (rs["factor"] * base)) * ramp + (1.0 / base) * (1.0 - ramp)
    gain = yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"],
                                                                 rs["mscale_all_dim"])
    return inv, gain


def softmax_scale(a: dict) -> float:
    s = (a["nope"] + a["rope"]) ** -0.5
    rs = a["rope_scaling"]
    if rs and rs.get("mscale_all_dim"):
        s *= yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return s


def rope(x, pos, a: dict):
    """x (T, ..., rope) at positions pos (T,): its halves rotated."""
    inv, gain = yarn_freqs(a["rope"], a["theta"], a["rope_scaling"])
    ang = pos.double()[:, None] * inv.to(pos.device)[None, :]
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (ang.shape[1],)
    c = (torch.cos(ang) * gain).float().view(shape)
    s = (torch.sin(ang) * gain).float().view(shape)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def layers(params):
    """Every layer's stacked parameter tree and index, in order."""
    for seg in params["segments"]:
        p = seg["p0"]
        for i in range(p["ln1"].shape[0]):
            yield p, i


def _weights(p, i: int, quant: str) -> dict:
    def m(w):   # an (in, out) matrix in fp32, quantized per output channel
        w = w.float()
        return fp8(w, 0) if quant == "fp8" else w

    mx, mlp = p["mixer"], p["mlp"]
    w = {"ln1": p["ln1"][i].float(), "ln2": p["ln2"][i].float(),
         "w_dq": m(mx["w_dq"][i]), "q_norm": mx["q_norm"][i].float(),
         "w_uq": m(mx["w_uq"][i].flatten(1)), "w_dkv": m(mx["w_dkv"][i]),
         "kv_norm": mx["kv_norm"][i].float(), "w_uk": m(mx["w_uk"][i].flatten(1)),
         "w_uv": m(mx["w_uv"][i].flatten(1)), "w_o": m(mx["w_o"][i].flatten(0, 1))}
    if "router" in mlp:
        ex, sh = mlp["experts"], mlp["shared"]
        w["router"] = m(mlp["router"][i])
        w["experts"] = [(m(ex["w_gate"][i, e]), m(ex["w_up"][i, e]), m(ex["w_down"][i, e]))
                        for e in range(ex["w_gate"].shape[1])]
        w["shared"] = (m(sh["w_gate"][i]), m(sh["w_up"][i]), m(sh["w_down"][i]))
    else:
        w["dense"] = (m(mlp["w_gate"][i]), m(mlp["w_up"][i]), m(mlp["w_down"][i]))
    return w


def _mm(x, w, quant: str):
    return (fp8(x, -1) if quant == "fp8" else x) @ w


def _swiglu(x, gate_up_down, quant: str):
    g, u, dn = gate_up_down
    return _mm(torch.nn.functional.silu(_mm(x, g, quant)) * _mm(x, u, quant), dn, quant)


def _attention(x, w, a: dict, quant: str):
    """MLA over one sequence x (T, d) normed: its output (T, d)."""
    t = x.shape[0]
    h, nope, rp, vd = a["h"], a["nope"], a["rope"], a["v"]
    pos = torch.arange(t, device=x.device)
    cq = rms_norm(_mm(x, w["w_dq"], quant), w["q_norm"], a["eps"])
    q = _mm(cq, w["w_uq"], quant).view(t, h, nope + rp)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], pos, a)
    ckv = _mm(x, w["w_dkv"], quant)
    c = rms_norm(ckv[:, :a["kv_lora"]], w["kv_norm"], a["eps"])
    k_pe = rope(ckv[:, a["kv_lora"]:], pos, a)                        # (T, rope)
    k_nope = _mm(c, w["w_uk"], quant).view(t, h, nope)
    v = _mm(c, w["w_uv"], quant).view(t, h, vd)
    scale = softmax_scale(a)
    qn, qp = q_nope.permute(1, 0, 2), q_pe.permute(1, 0, 2)            # (H, T, ·)
    kn, vt = k_nope.permute(1, 2, 0), v.permute(1, 0, 2)                # (H, nope, T), (H, T, v)
    out = torch.empty((t, h * vd), device=x.device)
    for q0 in range(0, t, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, t)
        s = torch.matmul(qn[:, q0:q1], kn[:, :, :q1]) + torch.matmul(qp[:, q0:q1], k_pe[:q1].T)
        s = s * scale
        mask = torch.arange(q1, device=x.device)[None, :] > \
            torch.arange(q0, q1, device=x.device)[:, None]
        s.masked_fill_(mask, float("-inf"))
        o = torch.matmul(torch.softmax(s, dim=-1), vt[:, :q1])         # (H, tq, v)
        out[q0:q1] = o.permute(1, 0, 2).reshape(q1 - q0, h * vd)
        del s, o
    return _mm(out, w["w_o"], quant)


def route(x, router, a: dict, quant: str = "none"):
    """The published router over all experts for rows x (n, d), fp32:
    (expert ids (n, k), gates (n, k))."""
    scores = torch.softmax(_mm(x, router, quant), dim=-1)               # (n, E)
    n, e = scores.shape
    if a["topk_method"] == "group_limited_greedy":
        g = scores.view(n, a["n_group"], e // a["n_group"])
        top = torch.topk(g.amax(-1), a["topk_group"], dim=-1).indices
        keep = torch.zeros(n, a["n_group"], dtype=torch.bool, device=x.device)
        keep[torch.arange(n, device=x.device)[:, None], top] = True
        scores = torch.where(keep[..., None], g, 0.0).view(n, e)
    gates, ids = torch.topk(scores, a["top_k"], dim=-1)
    if a["norm_topk"]:
        gates = gates / gates.sum(-1, keepdim=True)
    else:
        gates = gates * a["scale"]
    return ids, gates


def _moe(x, w, a: dict, quant: str):
    """The held experts' part of the routed output plus the shared experts,
    every assignment kept."""
    ids, gates = route(x, w["router"], a, quant)
    e0, count = a["held"]
    out = _swiglu(x, w["shared"], quant)
    for j in range(count):
        hit = ids == e0 + j                                             # (n, k)
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel():
            g = (gates * hit).sum(-1)[rows]
            out[rows] += g[:, None] * _swiglu(x[rows], w["experts"][j], quant)
    return out


def _layer(x, w, a: dict, quant: str):
    x = x + _attention(rms_norm(x, w["ln1"], a["eps"]), w, a, quant)
    for r0 in range(0, x.shape[0], ROWS):
        hn = rms_norm(x[r0:r0 + ROWS], w["ln2"], a["eps"])
        y = _moe(hn, w, a, quant) if "router" in w else _swiglu(hn, w["dense"], quant)
        x[r0:r0 + ROWS] += y
    return x


def logits_at(params, a: dict, seqs: list, at: list, *, device, quant: str = "none") -> list:
    """fp32 logits of each token sequence ``seqs[i]`` at its positions
    ``at[i]``, one (n_i, V) tensor each."""
    with exact_fp32(), torch.no_grad():
        xs = [params["embed"][torch.as_tensor(s, device=device).long()].float() for s in seqs]
        for p, i in layers(params):
            w = _weights(p, i, quant)
            xs = [_layer(x, w, a, quant) for x in xs]
            del w
        norm = params["final_norm"].float()
        head = params["lm_head"].float()
        if quant == "fp8":
            head = fp8(head, 0)
        out = []
        for x, idx in zip(xs, at):
            hn = rms_norm(x[torch.as_tensor(idx, device=device)], norm, a["eps"])
            out.append(_mm(hn, head, quant))
        return out


def _positions(served):
    seqs, at = [], []
    for prompt, toks in served:
        seqs.append(list(prompt) + list(toks[:-1]))
        at.append(list(range(len(prompt) - 1, len(prompt) - 1 + len(toks))))
    return seqs, at


def served_gaps(params, a: dict, served: list, *, device) -> list:
    """For each (prompt, served tokens): at each served token, how far its
    fp32 reference logit lies below the reference's best there."""
    seqs, at = _positions(served)
    logits = logits_at(params, a, seqs, at, device=device)
    gaps = []
    for lg, (_, toks) in zip(logits, served):
        t = torch.as_tensor(toks, device=lg.device).long()
        gaps.append((lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]).tolist())
    return gaps


def control_gaps(params, a: dict, served: list, *, device) -> list:
    """The control: at the same positions of the same sequences, how far
    below the fp32 reference's best lies the token the fp8 forward ranks
    first."""
    seqs, at = _positions(served)
    ref = logits_at(params, a, seqs, at, device=device)
    low = logits_at(params, a, seqs, at, device=device, quant="fp8")
    return [(r.max(-1).values - r.gather(1, lo.argmax(-1)[:, None])[:, 0]).tolist()
            for r, lo in zip(ref, low)]
