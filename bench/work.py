"""Operations and bytes of each kernel launch and of each model token, and
the card's peaks: the yardstick that rooflines and MFU are measured with.

Each input byte is counted read once and each output byte written once, over
the positions the launch needs (a cache's valid prefix, not its padded
capacity); where the work depends on the data, what these inputs need.  A
launch's least time is the larger of its operations over the peak rate of
its precision and its bytes over the memory bandwidth.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), which
assume the card's full 700 W.
"""
from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """Least seconds a launch can take on the card."""
    return max(flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

def extend_attention(*, b: int, nb: int, h: int, kv: int, hd: int, hd_v: int,
                     t_real: int, elt: int = 2) -> tuple[float, float]:
    """Causal suffix attention: nb queries at positions [t_real − nb, t_real)
    of each of b rows, each attending the positions up to its own over KV
    heads shared by h / kv query heads.  (FLOPs, bytes): q·k and p·v over
    the keys each query sees; q, the valid K/V and the output once."""
    start = t_real - nb
    keys = nb * start + nb * (nb + 1) // 2
    flops = 2.0 * b * h * (hd + hd_v) * keys
    nbytes = elt * (b * nb * h * hd + b * t_real * kv * (hd + hd_v) + b * nb * h * hd_v)
    return flops, float(nbytes)


def decode_attention(*, pos: list[int], h: int, kv: int, hd: int, hd_v: int,
                     elt: int = 2) -> tuple[float, float]:
    """One query per row over the row's positions [0, pos]: (FLOPs, bytes)
    of q·k and p·v over pos + 1 keys a row; q, the rows' valid K/V, pos and
    the output once."""
    keys = sum(p + 1 for p in pos)
    b = len(pos)
    flops = 2.0 * h * (hd + hd_v) * keys
    nbytes = elt * (b * h * hd + keys * kv * (hd + hd_v) + b * h * hd_v) + 4 * b
    return flops, float(nbytes)


# ---------------------------------------------------------------------------
# analytics kernels (fp32)
# ---------------------------------------------------------------------------

def linreg_stats(*, n: int, d: int, elt: int = 4) -> tuple[float, float]:
    """G = [X | y]ᵀ[X | y] over n rows: 2·n·(d+1)² FLOPs; X and y read
    once, G (d+1)² fp32 written once."""
    return 2.0 * n * (d + 1) ** 2, float(elt * n * (d + 1) + 4 * (d + 1) ** 2)


def nb_stats(*, n: int, d: int, classes: int, elt: int = 4) -> tuple[float, float]:
    """Per-class counts, S and SS over n rows: 3 FLOPs an element (x, x·x
    and its sum); X and the int32 labels read once, (C, 1 + 2d) fp32
    written once."""
    return 3.0 * n * d, float(elt * n * d + 4 * n + 4 * classes * (1 + 2 * d))


def logreg_sgd(*, n: int, d: int, chunk: int, elt: int = 4) -> tuple[float, float]:
    """One SGD epoch over n rows in chunks of ``chunk``: the logit and the
    gradient, 4·d FLOPs a row; X and y read once, one (d+1) fp32 weight
    vector a chunk written once.  Its time is a chain of dependent
    minibatch steps, so its share of this bound is small by design."""
    chunks = -(-n // chunk)
    return 4.0 * n * d, float(elt * n * d + 4 * n + 4 * chunks * (d + 1))


# ---------------------------------------------------------------------------
# dense decoder model FLOPs (GQA + SwiGLU)
# ---------------------------------------------------------------------------

def layer_weights(*, d: int, h: int, kv: int, hd: int, ff: int) -> int:
    """Matrix parameters of one attention + SwiGLU layer."""
    return d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff


def lm_span_flops(*, layers: int, d: int, h: int, kv: int, hd: int, ff: int,
                  vocab: int, start: int, n: int, heads_out: int = 1) -> float:
    """Model FLOPs of ``n`` tokens at positions [start, start + n) of one
    row, each attending causally to every position up to its own, plus the
    output head at ``heads_out`` positions (1: a prefill or extend keeps its
    last position's logits; a decode row its one)."""
    keys = n * start + n * (n + 1) // 2
    per_layer = 2.0 * layer_weights(d=d, h=h, kv=kv, hd=hd, ff=ff) * n \
        + 2.0 * h * 2 * hd * keys
    return layers * per_layer + 2.0 * d * vocab * heads_out
