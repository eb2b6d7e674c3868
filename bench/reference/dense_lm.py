"""Plain fp32 reference of a dense GQA + SwiGLU decoder (Llama layout, as
DeepSeek LLM publishes it): RMSNorm, rotary embeddings on the two halves of
each head, causal softmax attention over grouped KV heads, a SwiGLU MLP and
an untied output head.  It follows the published description; it reads only
the weights the benchmark drew (bf16, taken to fp32 layer by layer) and the
tokens, and imports nothing of the program.

Matrix products run in fp32 with TF32 off.  ``quant="fp8"`` is the control:
the same forward with every matrix and every matrix product's input rounded
to float8 e4m3 (weights per output channel, activations per token), as an
fp8 serving path would.

Sequences run together layer by layer, each layer's weights taken to fp32
once, attention in blocks of queries, so a few thousand positions of a
published-width model fit beside the bf16 weights.
"""
from __future__ import annotations

import contextlib

import torch

#: queries per attention block and rows per MLP block
BLOCK = 1024
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


def rope(x, pos, theta):
    """x (T, H, hd) at positions pos (T,): the halves of each head rotated."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _layer_weights(params, i: int, quant: str) -> dict:
    seg = params["segments"][0]["p0"]
    mx, mlp = seg["mixer"], seg["mlp"]
    d = mx["wq"].shape[1]

    def m(w):   # an (in, out) matrix in fp32, quantized per output channel
        w = w.float()
        return fp8(w, 0) if quant == "fp8" else w

    return {
        "ln1": seg["ln1"][i].float(), "ln2": seg["ln2"][i].float(),
        "wq": m(mx["wq"][i].reshape(d, -1)), "wk": m(mx["wk"][i].reshape(d, -1)),
        "wv": m(mx["wv"][i].reshape(d, -1)), "wo": m(mx["wo"][i].reshape(-1, d)),
        "w_gate": m(mlp["w_gate"][i]), "w_up": m(mlp["w_up"][i]), "w_down": m(mlp["w_down"][i]),
    }


def _mm(x, w, quant: str):
    return (fp8(x, -1) if quant == "fp8" else x) @ w


def _layer(x, w, a: dict, quant: str):
    """One decoder layer over one sequence x (T, d), fp32."""
    t = x.shape[0]
    h, kv, hd = a["h"], a["kv"], a["hd"]
    pos = torch.arange(t, device=x.device)
    hn = rms_norm(x, w["ln1"], a["eps"])
    q = rope(_mm(hn, w["wq"], quant).view(t, h, hd), pos, a["theta"])
    k = rope(_mm(hn, w["wk"], quant).view(t, kv, hd), pos, a["theta"])
    v = _mm(hn, w["wv"], quant).view(t, kv, hd)
    g = h // kv
    # (kv, g, T, hd) queries against (kv, T, hd) keys
    qg = q.view(t, kv, g, hd).permute(1, 2, 0, 3)
    kt = k.permute(1, 2, 0)
    vt = v.permute(1, 0, 2)
    out = torch.empty((t, h * hd), device=x.device)
    for q0 in range(0, t, BLOCK):
        q1 = min(q0 + BLOCK, t)
        s = torch.matmul(qg[:, :, q0:q1], kt[:, None, :, :q1]) * hd ** -0.5
        mask = torch.arange(q1, device=x.device)[None, :] > torch.arange(q0, q1, device=x.device)[:, None]
        s.masked_fill_(mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p, vt[:, None, :q1])            # (kv, g, tq, hd)
        out[q0:q1] = o.permute(2, 0, 1, 3).reshape(q1 - q0, h * hd)
    x = x + _mm(out, w["wo"], quant)
    for r0 in range(0, t, BLOCK):
        hn = rms_norm(x[r0:r0 + BLOCK], w["ln2"], a["eps"])
        gate = torch.nn.functional.silu(_mm(hn, w["w_gate"], quant))
        x[r0:r0 + BLOCK] += _mm(gate * _mm(hn, w["w_up"], quant), w["w_down"], quant)
    return x


def logits_at(params, a: dict, seqs: list, at: list, *, device, quant: str = "none") -> list:
    """fp32 logits of each token sequence ``seqs[i]`` at its positions
    ``at[i]`` (the positions whose next token was served), one (n_i, V)
    tensor each."""
    with exact_fp32(), torch.no_grad():
        xs = [params["embed"][torch.as_tensor(s, device=device).long()].float() for s in seqs]
        for i in range(a["layers"]):
            w = _layer_weights(params, i, quant)
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


def served_gaps(params, a: dict, served: list, *, device) -> list:
    """For each (prompt, served tokens): at each served token, how far its
    fp32 reference logit lies below the reference's best there."""
    seqs, at = [], []
    for prompt, toks in served:
        seqs.append(list(prompt) + list(toks[:-1]))
        at.append(list(range(len(prompt) - 1, len(prompt) - 1 + len(toks))))
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
    seqs, at = [], []
    for prompt, toks in served:
        seqs.append(list(prompt) + list(toks[:-1]))
        at.append(list(range(len(prompt) - 1, len(prompt) - 1 + len(toks))))
    ref = logits_at(params, a, seqs, at, device=device)
    low = logits_at(params, a, seqs, at, device=device, quant="fp8")
    return [(r.max(-1).values - r.gather(1, l.argmax(-1)[:, None])[:, 0]).tolist()
            for r, l in zip(ref, low)]
