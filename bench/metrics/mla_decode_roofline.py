"""The absorbed MLA decode kernel's share of its roofline over the traced
window: each launch's bf16 latents and rope keys over each row's valid
positions read once, q and W_uv read once and the fp32 output written
once; 2·H·(2·kv_lora + rope) operations a position (the scores over
[latent ‖ rope] and the probabilities times the latent) and 2·B·H·kv_lora·v
for W_uv, against the profiler's time of its ``mla_decode_split`` and
``mla_decode_combine``.  A program without the kernel records no
``mla_decode`` launch and reads nothing."""
from bench import roofline, work


def mla_decode(*, pos: list[int], h: int, kv_lora: int, rope: int, v: int,
               elt: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one call over rows at positions ``pos``: pos + 1
    positions a row."""
    keys = sum(p + 1 for p in pos)
    b = len(pos)
    flops = 2.0 * h * (2 * kv_lora + rope) * keys + 2.0 * b * h * kv_lora * v
    nbytes = (elt * ((keys + b * h) * (kv_lora + rope) + kv_lora * h * v)
              + 4 * b * h * v + 4 * b)
    return flops, float(nbytes)


def _work(args, kw):
    q_lat, q_rope, _, _, w_uv = args[:5]
    _, h, kv_lora = q_lat["shape"]
    f, n = mla_decode(pos=kw["pos"], h=h, kv_lora=kv_lora, rope=q_rope["shape"][2],
                      v=w_uv["shape"][2], elt=q_lat["elt"])
    return f, n, roofline.precision(q_lat["elt"])


def read(rec):
    return roofline.share(rec, hook="mla_decode",
                          module="repro_torch.kernels.mla_decode.kernel",
                          kernels=("mla_decode_split", "mla_decode_combine"), work_of=_work)
