#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card of compute
capability 9.0 and ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``).  It builds the
port's CUDA kernels from ``src/repro_torch/kernels/*/csrc`` and runs:

  1. device: the card's name, count, and ``nvidia-smi`` name/power limit;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of the full-width serving path, in fp32 (rtol 1e-4 / atol 1e-5)
     and bf16 (against the fp32 plain version on the same bf16 values,
     rtol/atol 2e-2, for the bf16 output rounding); decode's bit-invariance
     to padded capacity; each kernel's time (CUDA events, L2 flushed
     between launches) beside its bound, the plain version's time and one
     PyTorch library call's time (a yardstick the port never calls);
  3. reduced ``deepseek-67b`` (fp32) in ``ServeEngine`` on the card vs the
     same on the CPU: identical plans and greedy tokens;
  4. the main path at full width: ``deepseek-67b`` widths, bf16, depth cut
     from 95 to 24 layers so the weights fit one 80 GB card, a 4096-token
     document, chunk 128, requests with prefixes 2048, 4096, 3072 (16 new
     tokens each) and a replay of the first, with the kernels' launch
     counters read around it;
  5. where the time goes: ``torch.profiler`` over full-width decode steps
     and one 128-token extend — device busy and idle time, top kernels.

Any failure exits non-zero.  The last two lines are the ``nvidia-smi``
line and ``{"ok": true, "device": {...}}``; the line before them lists
every kernel with its launches and times.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,          # CUDA-core fp32
              torch.bfloat16: 989e12}        # dense bf16 tensor cores
FULL_LAYERS = 24


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

class Timer:
    """Median per-launch device time with the L2 flushed before each launch
    (the serving path finds a layer's KV cache cold: a layer's weights
    stream through L2 between two attention calls)."""

    def __init__(self, device) -> None:
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 15, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def within(got, want, rtol, atol) -> tuple[bool, float]:
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, float(diff.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def extend_phase(dev, timer) -> dict:
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.extend_attention.ops import extend_attention
    from repro_torch.kernels.extend_attention.ref import extend_attention_ref

    b, kv, g, hd, nb, cap = 1, 8, 8, 128, 128, 4096
    h = kv * g
    err = {}
    for dtype, (rtol, atol) in ((torch.float32, (1e-4, 1e-5)),
                                (torch.bfloat16, (2e-2, 2e-2))):
        q = randn((b, nb, h, hd), dtype, dev, 1)
        k = randn((b, cap, kv, hd), dtype, dev, 2)
        v = randn((b, cap, kv, hd), dtype, dev, 3)
        for t_real in (128, 2049, 4096):
            got = extend_attention(q, k, v, t_real=t_real)
            want = extend_attention_ref(q.float(), k.float(), v.float(),
                                        t_real=t_real)
            torch.cuda.synchronize()
            ok, e = within(got, want, rtol, atol)
            print(f"  extend {str(dtype)[6:]:8s} t_real {t_real:4d}: "
                  f"max |err| {e:.3g} (rtol {rtol}, atol {atol})")
            check(ok, f"extend kernel disagrees with its plain version "
                      f"({dtype}, t_real {t_real}, max err {e})")
            err[(dtype, t_real)] = e

    # timing at the largest chunk of the main path: t_real 4096, bf16
    dtype, t_real = torch.bfloat16, 4096
    q = randn((b, nb, h, hd), dtype, dev, 1)
    k = randn((b, cap, kv, hd), dtype, dev, 2)
    v = randn((b, cap, kv, hd), dtype, dev, 3)
    t_dev = torch.tensor(t_real, dtype=torch.int32, device=dev)
    ms = timer.ms(lambda: extend_attention(q, k, v, t_real=t_dev))
    plain_ms = timer.ms(lambda: extend_attention_ref(q, k, v, t_real=t_real))
    q_pos = torch.arange(t_real - nb, t_real, device=dev)
    mask = torch.arange(cap, device=dev)[None, :] <= q_pos[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    try:
        library_ms = timer.ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                           enable_gqa=True))
    except (TypeError, RuntimeError) as exc:   # yardstick only
        print(f"  extend library yardstick unavailable: {exc}")
        library_ms = None
    keys = float((q_pos + 1).sum())            # causal keys this run needs
    flops = 4.0 * hd * h * b * keys
    nbytes = 2 * (2 * q.numel() + 2 * b * t_real * kv * hd) + 4
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    return {"name": "extend_attention", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": max(e for (dt, _), e in err.items() if dt == dtype),
            "shape": f"B{b} KV{kv} G{g} hd{hd} nb{nb} cap{cap} t_real{t_real} bf16"}


def decode_phase(dev, timer) -> dict:
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_blocked

    b, kv, g, hd, cap = 4, 8, 8, 128, 4096
    h = kv * g
    pos = torch.tensor([0, 1000, 2049, cap - 1], dtype=torch.int32, device=dev)
    err = {}
    for dtype, (rtol, atol) in ((torch.float32, (1e-4, 1e-5)),
                                (torch.bfloat16, (2e-2, 2e-2))):
        q = randn((b, 1, h, hd), dtype, dev, 4)
        k = randn((b, cap, kv, hd), dtype, dev, 5)
        v = randn((b, cap, kv, hd), dtype, dev, 6)
        got = decode_attention(q, k, v, pos=pos)
        want = decode_attention_blocked(q.float()[:, 0].reshape(b, kv, g, hd),
                                        k.float(), v.float(), pos)
        torch.cuda.synchronize()
        ok, e = within(got.reshape(b, kv, g, hd), want, rtol, atol)
        print(f"  decode {str(dtype)[6:]:8s} pos {pos.tolist()}: "
              f"max |err| {e:.3g} (rtol {rtol}, atol {atol})")
        check(ok, f"decode kernel disagrees with its plain version "
                  f"({dtype}, max err {e})")
        err[dtype] = e

        # bit-invariance to padded capacity: caps 256 and 2048, garbage tail
        small_pos = torch.tensor([0, 17, 128, 255], dtype=torch.int32, device=dev)
        ks, vs = k[:, :256].contiguous(), v[:, :256].contiguous()
        kb = randn((b, 2048, kv, hd), dtype, dev, 7) * 100
        vb = randn((b, 2048, kv, hd), dtype, dev, 8) * 100
        kb[:, :256], vb[:, :256] = ks, vs
        same = torch.equal(decode_attention(q, ks, vs, pos=small_pos),
                           decode_attention(q, kb, vb, pos=small_pos))
        print(f"  decode {str(dtype)[6:]:8s} bit-invariant caps 256 vs 2048: {same}")
        check(same, f"decode output depends on padded capacity ({dtype})")

    dtype = torch.bfloat16
    q = randn((b, 1, h, hd), dtype, dev, 4)
    k = randn((b, cap, kv, hd), dtype, dev, 5)
    v = randn((b, cap, kv, hd), dtype, dev, 6)
    ms = timer.ms(lambda: decode_attention(q, k, v, pos=pos))
    qg = q[:, 0].reshape(b, kv, g, hd)
    plain_ms = timer.ms(lambda: decode_attention_blocked(qg, k, v, pos))
    mask = (torch.arange(cap, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    try:
        library_ms = timer.ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                           enable_gqa=True))
    except (TypeError, RuntimeError) as exc:   # yardstick only
        print(f"  decode library yardstick unavailable: {exc}")
        library_ms = None
    keys = float((pos + 1).sum())
    flops = 4.0 * hd * h * keys
    nbytes = 2 * (2 * q.numel() + 2 * keys * kv * hd) + 4 * b
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    return {"name": "decode_attention", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err[dtype],
            "shape": f"B{b} KV{kv} G{g} hd{hd} cap{cap} pos{pos.tolist()} bf16"}


# ---------------------------------------------------------------------------
# phase 3: reduced model, card vs CPU
# ---------------------------------------------------------------------------

def reduced_parity(dev) -> None:
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.common import tree_map_with_path
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeEngine

    cfg = reduced(get_config("deepseek-67b"))
    cpu_model = LM(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    gpu_model = LM(cfg, device=dev)
    gpu_params = tree_map_with_path(lambda _, x: x.to(dev), cpu_params)
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 256).astype(np.int32)
    engines = {name: ServeEngine(m, p, doc, chunk_tokens=64, device=m.device)
               for name, m, p in (("cpu", cpu_model, cpu_params),
                                  ("cuda", gpu_model, gpu_params))}
    for prefix, n_new in ((200, 4), (256, 4), (130, 4)):
        out = {}
        for name, eng in engines.items():
            toks, plan = eng.generate(prefix, n_new)
            out[name] = (toks, [(s.rng.lo, s.rng.hi, s.model_id)
                                for s in plan.steps])
        print(f"  prefix {prefix}: cuda tokens {out['cuda'][0]} cpu tokens "
              f"{out['cpu'][0]}, plan steps {len(out['cuda'][1])}")
        check(out["cuda"] == out["cpu"],
              f"reduced model: card and CPU disagree at prefix {prefix}: {out}")
    print("  reduced cuda-vs-cpu: identical plans and tokens: True")


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def main_path(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.extend_attention import kernel as ek
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeEngine

    base = get_config("deepseek-67b")
    cfg = dataclasses.replace(base, n_layers=FULL_LAYERS)
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} KV, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.param_dtype}; n_layers cut "
          f"{base.n_layers} -> {cfg.n_layers} to fit one 80 GB card")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"  init: {n_params / 1e9:.2f} B params on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 4096).astype(np.int32)
    eng = ServeEngine(model, params, doc, chunk_tokens=128, device=dev)

    ek.KERNEL.launches = 0
    dk.KERNEL.launches = 0
    results = []
    for prefix in (2048, 4096, 3072, 2048):
        s0 = dataclasses.replace(eng.stats)
        toks, plan = eng.generate(prefix, 16)
        st = eng.stats
        pre = st.prefill_s - s0.prefill_s
        dec = st.decode_s - s0.decode_s
        reused = st.tokens_reused - s0.tokens_reused
        print(f"  request prefix {prefix}: prefill {pre:.3f} s "
              f"({reused} tokens reused, {len(plan.models_used)} segments), "
              f"decode {16 / dec:.1f} tok/s, tokens {toks[:8]}")
        check(all(0 <= t < cfg.vocab_size for t in toks), "token out of range")
        results.append((prefix, toks, plan))
    logits, _, _ = eng.builder.prefix_with_logits(doc, 3072, doc_id=eng.doc_id,
                                                  capacity=3088)
    counts = {"extend_attention": ek.KERNEL.launches,
              "decode_attention": dk.KERNEL.launches}
    torch.cuda.synchronize(dev)
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          f"full-width logits not finite or mis-shaped: {tuple(logits.shape)}")
    check(all(len(r[2].models_used) > 0 for r in results[1:]),
          "requests 2 and 3 did not reuse stored segments")
    check(results[3][1] == results[0][1],
          "replayed request from stored segments changed its tokens")
    check(all(n > 0 for n in counts.values()),
          f"a kernel was not launched on the main path: {counts}")
    mem = torch.cuda.max_memory_allocated(dev)
    print("  replay of prefix 2048 from the store: identical tokens: True")
    print(f"  store: {len(eng.store)} segments, {eng.store.nbytes() / 2**20:.0f} MiB; "
          f"max memory allocated {mem / 2**30:.2f} GiB")
    print(f"  main-path launches: {counts}")
    return counts, eng


def where_time_goes(eng, dev) -> None:
    """torch.profiler over four full-width decode steps at position 3072 and
    one 128-token extend at 2048 (after the main path's counters are read):
    device busy time per step and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, params, doc = eng.model, eng.params, eng.doc
    logits, caches, _ = eng.builder.prefix_with_logits(
        doc, 3072, doc_id=eng.doc_id, capacity=3088)
    tok = torch.argmax(logits, dim=-1)[:, None]
    pos = torch.tensor([3072], dtype=torch.int32, device=dev)
    ext, _ = eng.builder.build_prefix(doc, 2048, doc_id=eng.doc_id,
                                      materialize=False, capacity=2176)
    chunk = torch.as_tensor(doc[None, 2048:2176].astype(np.int64), device=dev)
    start = torch.tensor(2048, dtype=torch.int32, device=dev)
    torch.cuda.synchronize(dev)
    for label, steps, fn in (
            ("decode step", 4, lambda: model.decode_step(params, caches, tok, pos)),
            ("extend 128 tokens", 1,
             lambda: model.prefill_extend(params, ext, chunk, start))):
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) / steps * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(ms for _, ms, _ in rows)
        if not rows:
            print(f"  {label}: wall {wall:.2f} ms; the profiler saw no device "
                  f"time (device split not measured)")
            continue
        print(f"  {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
              f"({busy / wall:.0%}), idle {max(wall - busy, 0.0):.2f} ms")
        for key, ms, n in sorted(rows, key=lambda r: -r[1])[:6]:
            print(f"    {ms:8.3f} ms  {ms / busy:5.1%}  x{n:<4d} {key[:90]}")


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    try:
        from repro_torch.kernels import build
    except ImportError as exc:
        fail(f"cannot import the port from {ROOT / 'src'}: {exc}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[1] device: {name}, count {torch.cuda.device_count()}, "
          f"capability {torch.cuda.get_device_capability(0)}, nvidia-smi: {smi}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"[build] {len(build.sources())} CUDA sources ready in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for stem, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {stem}: {line.strip()}")

    timer = Timer(dev)
    print("[2] kernels vs plain versions on the card")
    rows = [extend_phase(dev, timer), decode_phase(dev, timer)]
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms")

    print("[3] reduced deepseek-67b (fp32): card vs CPU")
    reduced_parity(dev)

    print(f"[4] full-width main path ({FULL_LAYERS} layers, bf16)")
    counts, eng = main_path(dev)
    print("[5] where the time goes (torch.profiler, full width)")
    where_time_goes(eng, dev)

    sources = {
        "extend_attention": ("src/repro_torch/kernels/extend_attention/csrc/extend_attention.cu",
                             "src/repro/kernels/extend_attention/kernel.py:108"),
        "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:103"),
    }
    kernels = [{"name": r["name"], "route": "cuda",
                "source": sources[r["name"]][0],
                "replaces": sources[r["name"]][1],
                "launches": counts[r["name"]],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
               for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
