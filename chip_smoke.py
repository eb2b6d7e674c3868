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
     and one 128-token extend — device busy and idle time, top kernels;
  6. the analytics engine on the card vs the same engine on the CPU (the
     kernels' plain versions): 200K x 10 rows made from a seed, one query
     script per family, identical plans and reuse, statistics within an
     fp32 tolerance;
  7. the analytics main path: the paper's workload (5M x 10 base tables
     resident on the card, 50K-row models warmed to 0.6 coverage, 100
     queries of N(50K, 12.5K) rows per family — the paper runs 1000)
     through ``IncrementalAnalyticsEngine``, against ``baseline``, with the
     statistics kernels' launch counters read around it.

Phase 2 also checks the three analytics kernels (linreg statistics,
Naive Bayes grouped statistics, chunked logistic SGD) against their plain
versions at ``repro``'s sweep shapes with ``tests/test_kernels.py``'s
tolerances, shows that two launches on the same data agree bitwise, and
times them at the analytics path's shapes.

Any failure exits non-zero.  The last two lines are the ``nvidia-smi``
line and ``{"ok": true, "device": {...}}``; the line before them lists
every kernel with its launches (on its own main path: serving for the
attention kernels, analytics for the statistics kernels) and times.
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
# phase 2, analytics kernels
# ---------------------------------------------------------------------------

#: 5M-row fp32 sums against float64: a sequential fp32 sum of n terms
#: strays by about sqrt(n) * 6e-8 of its scale (1.3e-4 at n = 5M); the
#: kernels' split sums stray less
SUM_NORMWISE = 1e-4


def normwise(got, want) -> float:
    """max |got - want| over max |want|: the error relative to the field's
    scale, for sums whose entries cancel."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def library_time(timer, fn, label):
    try:
        return timer.ms(fn)
    except (TypeError, RuntimeError) as exc:   # yardstick only
        print(f"  {label} library yardstick unavailable: {exc}")
        return None


def linreg_stats_phase(dev, timer) -> dict:
    from repro_torch.kernels.linreg_stats.ops import linreg_stats
    from repro_torch.kernels.linreg_stats.ref import linreg_stats_ref

    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol = 5e-3 if dtype == torch.bfloat16 else 5e-4
        for n in (64, 513, 2048):
            for d in (3, 10, 127, 130):
                X = randn((n, d), dtype, dev, 40)
                y = randn((n,), dtype, dev, 41)
                got = linreg_stats(X, y, with_yty=True)
                want = linreg_stats_ref(X, y)
                torch.cuda.synchronize()
                for name, g, w in zip(("A", "B", "yty"), got, want):
                    ok, e = within(g, w, rtol, n * 2e-2 * rtol)
                    check(ok, f"linreg_stats disagrees with its plain version "
                              f"({dtype}, n {n}, d {d}, {name}, max err {e})")
                    err[dtype] = max(err.get(dtype, 0.0), e)
        print(f"  linreg_stats {str(dtype)[6:]:8s} n 64/513/2048 x d 3/10/127/130: "
              f"max |err| {err[dtype]:.3g} (rtol {rtol}, atol n*2e-2*rtol)")

    n, d = 5_000_000, 10
    X = randn((n, d), torch.float32, dev, 42)
    y = randn((n,), torch.float32, dev, 43)
    first = linreg_stats(X, y, with_yty=True)
    again = linreg_stats(X, y, with_yty=True)
    plain = linreg_stats_ref(X, y)
    Xd, yd = X.double(), y.double()
    exact = (Xd.T @ Xd, Xd.T @ yd, yd @ yd)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    nerr = max(normwise(g, w) for g, w in zip(first, exact))
    print(f"  linreg_stats 5M x 10: two launches bitwise equal: {same}; normwise err "
          f"vs float64 {nerr:.3g} (limit {SUM_NORMWISE}), plain fp32 version vs float64 "
          f"{max(normwise(g, w) for g, w in zip(plain, exact)):.3g}")
    check(same, "linreg_stats is not bitwise repeatable")
    check(nerr <= SUM_NORMWISE, "linreg_stats strays from the float64 statistics at 5M x 10")
    del Xd, yd

    rows = {}
    for m in (n, 50_000):
        Xm, ym = X[:m], y[:m]
        Z = torch.cat([Xm, ym[:, None]], 1)
        rows[m] = (timer.ms(lambda: linreg_stats(Xm, ym)),
                   timer.ms(lambda: linreg_stats_ref(Xm, ym)),
                   library_time(timer, lambda: torch.matmul(Z.T, Z), "linreg_stats"),
                   *bound(2.0 * m * (d + 1) ** 2, 4.0 * (m * (d + 1) + (d + 1) ** 2),
                          torch.float32))
        print(f"  linreg_stats {m} x {d} fp32: kernel {rows[m][0]:.4f} ms, bound "
              f"{rows[m][3]:.4f} ms ({rows[m][4]}), plain {rows[m][1]:.4f} ms, "
              f"library matmul(Z.T, Z) {rows[m][2]} ms")
    ms, plain_ms, library_ms, bound_ms, bound_by = rows[n]
    return {"name": "linreg_stats", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err[torch.float32], "shape": f"n {n} d {d} fp32"}


def nb_stats_phase(dev, timer) -> dict:
    from repro_torch.kernels.nb_stats.ops import nb_stats
    from repro_torch.kernels.nb_stats.ref import nb_stats_ref

    def labels(n, c, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        y = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
        y[::17] = -1                       # unlabelled rows count nowhere
        return y

    err = 0.0
    for c in (2, 13):
        for d in (10, 129):
            for n in (1024, 70_000):
                X = randn((n, d), torch.float32, dev, 44)
                y = labels(n, c, 45)
                got = nb_stats(X, y, c)
                want = nb_stats_ref(X, y, c)
                torch.cuda.synchronize()
                check(torch.equal(got[0], want[0]),
                      f"nb_stats counts differ (C {c}, d {d}, n {n})")
                scale = max(1.0, n / 1024)
                for name, g, w, atol in (("S", got[1], want[1], 1e-3), ("SS", got[2], want[2], 1e-2)):
                    ok, e = within(g, w, 1e-4, atol * scale)
                    check(ok, f"nb_stats disagrees with its plain version (C {c}, "
                              f"d {d}, n {n}, {name}, max err {e})")
                    err = max(err, e)
    print(f"  nb_stats C 2/13 x d 10/129 x n 1024/70000: counts exact, max |err| "
          f"{err:.3g} (rtol 1e-4, atol 1e-3/1e-2 per 1024 rows)")

    n, d, c = 5_000_000, 10, 2
    X = randn((n, d), torch.float32, dev, 46)
    y = labels(n, c, 47)
    first, again, plain = nb_stats(X, y, c), nb_stats(X, y, c), nb_stats_ref(X, y, c)
    onehot = torch.nn.functional.one_hot(y.clamp(min=0).long(), c).double()
    onehot *= (y >= 0)[:, None]
    Xd = X.double()
    exact = (onehot.sum(0), onehot.T @ Xd, onehot.T @ (Xd * Xd))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    nerr = max(normwise(g, w) for g, w in zip(first, exact))
    print(f"  nb_stats 5M x 10, C 2: two launches bitwise equal: {same}; counts equal "
          f"the plain version's: {torch.equal(first[0], plain[0])}; normwise err vs "
          f"float64 {nerr:.3g} (limit {SUM_NORMWISE}), plain fp32 version vs float64 "
          f"{max(normwise(g, w) for g, w in zip(plain, exact)):.3g}")
    check(same, "nb_stats is not bitwise repeatable")
    check(torch.equal(first[0], plain[0]) and nerr <= SUM_NORMWISE,
          "nb_stats strays from the float64 statistics at 5M x 10")
    del onehot, Xd

    rows = {}
    for m in (n, 50_000):
        Xm, ym = X[:m], y[:m]
        G = torch.cat([torch.ones((m, 1), device=dev), Xm, Xm * Xm], 1)[ym >= 0]
        y64 = ym[ym >= 0].long()
        rows[m] = (timer.ms(lambda: nb_stats(Xm, ym, c)),
                   timer.ms(lambda: nb_stats_ref(Xm, ym, c)),
                   library_time(timer, lambda: torch.zeros((c, 1 + 2 * d), device=dev)
                                .index_add_(0, y64, G), "nb_stats"),
                   *bound(m * (3.0 * d + 1), 4.0 * (m * (d + 1) + c * (1 + 2 * d)),
                          torch.float32))
        print(f"  nb_stats {m} x {d} fp32, C {c}: kernel {rows[m][0]:.4f} ms, bound "
              f"{rows[m][3]:.4f} ms ({rows[m][4]}), plain {rows[m][1]:.4f} ms, "
              f"library index_add_ {rows[m][2]} ms")
    ms, plain_ms, library_ms, bound_ms, bound_by = rows[n]
    return {"name": "nb_stats", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "shape": f"n {n} d {d} C {c} fp32"}


def logreg_sgd_phase(dev, timer) -> dict:
    from repro_torch.kernels.common import pad_axis, round_up
    from repro_torch.kernels.logreg_sgd.ops import logreg_sgd_batched
    from repro_torch.kernels.logreg_sgd.ref import sgd_chunks_ref

    def plain(X, y, batch, lr):
        p, l, _ = X.shape
        lp = round_up(l, batch)
        mask = pad_axis(torch.ones((p, l), device=dev), 1, lp)
        return sgd_chunks_ref(pad_axis(X, 1, lp), pad_axis(y, 1, lp), mask,
                              lam=1e-3, lr=lr, batch=batch)

    def data(p, l, d, seed):
        X = randn((p, l, d), torch.float32, dev, seed)
        return X, (randn((p, l), torch.float32, dev, seed + 1) > 0).float()

    err = 0.0
    for (l, batch) in ((512, 64), (1000, 50), (4096, 128)):
        for d in (8, 100):
            X, y = data(1, l, d, 48)
            got = logreg_sgd_batched(X, y, lam=1e-3, lr=0.3, batch=batch)
            want = plain(X, y, batch, 0.3)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                ok, e = within(g, w, 2e-4, 2e-5)
                check(ok, f"logreg_sgd disagrees with its plain version (l {l}, "
                          f"batch {batch}, d {d}, max err {e})")
                err = max(err, e)
    l, d, batch, p = 10_000, 10, 64, 500
    X, y = data(p, l, d, 50)
    got = logreg_sgd_batched(X, y, lam=1e-3, lr=0.5, batch=batch)
    again = logreg_sgd_batched(X, y, lam=1e-3, lr=0.5, batch=batch)
    want = plain(X, y, batch, 0.5)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        ok, e = within(g, w, 2e-4, 2e-5)
        check(ok, f"logreg_sgd disagrees with its plain version (p {p} chunks of "
                  f"{l} x {d}, max err {e})")
        err = max(err, e)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"  logreg_sgd (512,64)/(1000,50)/(4096,128) x d 8/100 and p {p} chunks "
          f"of {l} x {d}: max |err| {err:.3g} (rtol 2e-4, atol 2e-5); two launches "
          f"bitwise equal: {same}")
    check(same, "logreg_sgd is not bitwise repeatable")

    rows = {}
    steps = -(-l // batch)
    for q in (1, p):
        Xq, yq = X[:q], y[:q]
        rows[q] = (timer.ms(lambda: logreg_sgd_batched(Xq, yq, lam=1e-3, lr=0.5, batch=batch)),
                   timer.ms(lambda: plain(Xq, yq, batch, 0.5), iters=5),
                   None,
                   *bound(q * (l * (4.0 * d + 6) + steps * 6.0 * d),
                          4.0 * q * (l * (d + 1) + d + 1), torch.float32))
        print(f"  logreg_sgd {q} chunk(s) of {l} x {d}, batch {batch}: kernel "
              f"{rows[q][0]:.4f} ms, bound {rows[q][3]:.6f} ms ({rows[q][4]}), "
              f"{steps} dependent steps per chunk, plain {rows[q][1]:.4f} ms, "
              f"no library call")
    ms, plain_ms, library_ms, bound_ms, bound_by = rows[1]
    return {"name": "logreg_sgd", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "shape": f"1 chunk l {l} d {d} batch {batch} fp32"}


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
# phases 6 and 7: the analytics engine
# ---------------------------------------------------------------------------

ANALYTICS_FAMILIES = ("linreg", "gaussian_nb", "logreg")
STATS_NORMWISE = 2e-4        # card vs CPU statistics, fp32 sums in two orders


def analytics_tables(n, d, device):
    from repro_torch.data.synthetic import make_classification, make_regression
    from repro_torch.data.tabular import ArrayBackend

    reg = ArrayBackend(*make_regression(n, d=d, seed=0), device=device)
    cls = ArrayBackend(*make_classification(n, d=d, n_classes=2, seed=1), device=device)
    return {"linreg": reg, "gaussian_nb": cls, "logreg": cls}


def family_params(family, P):
    if family == "logreg":
        return {"chunk_size": P.logreg_chunk, "lam": P.logreg_lam}
    return {"lam": P.logreg_lam} if family == "linreg" else {}


def plan_key(plan):
    return [(s.rng.lo, s.rng.hi, s.sign, s.model_id) for s in plan.steps]


def analytics_parity(dev) -> None:
    """The engine over tables on the card against the same engine over the
    same numpy data on the CPU (the kernels' plain versions)."""
    from repro_torch.configs.paper import PAPER_WORKLOAD as P
    from repro_torch.core.descriptors import Range
    from repro_torch.core.engine import IncrementalAnalyticsEngine

    n, d, size = 200_000, 10, 20_000
    rng = np.random.default_rng(0)
    warm = [Range(int(lo), int(lo) + size) for lo in rng.integers(0, n - size, 6)]
    queries = []
    for _ in range(8):
        m = max(int(rng.normal(size, size / 4)), 1000)
        lo = int(rng.integers(0, n - m))
        queries.append(Range(lo, lo + m))
    tables = {name: analytics_tables(n, d, device) for name, device in (("cuda", dev), ("cpu", "cpu"))}
    for family in ANALYTICS_FAMILIES:
        params = family_params(family, P)
        runs = {}
        for name, backends in tables.items():
            eng = IncrementalAnalyticsEngine(
                backends[family], materialize="chunks" if family == "logreg" else "always")
            eng.warm(family, warm, **params)
            runs[name] = [(plan_key(r.plan), r.used_reuse, r.stats)
                          for r in (eng.query(family, q, **params) for q in queries)]
        same = all(a[:2] == b[:2] for a, b in zip(runs["cuda"], runs["cpu"]))
        err = max(normwise(getattr(a[2], f.name), getattr(b[2], f.name))
                  for a, b in zip(runs["cuda"], runs["cpu"])
                  for f in dataclasses.fields(a[2]))
        reused = sum(r[1] for r in runs["cuda"])
        print(f"  {family:12s} {len(queries)} queries ({reused} reused): identical plans "
              f"and reuse: {same}; stats normwise err {err:.3g} (limit {STATS_NORMWISE})")
        check(same, f"{family}: the card's plans differ from the CPU's")
        check(err <= STATS_NORMWISE, f"{family}: card and CPU statistics differ by {err}")


def analytics_profile(eng, family, params, rng, n, P, dev, queries: int = 10) -> None:
    """torch.profiler over a few more queries and their baselines: device
    busy share of the wall time, and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.descriptors import Range

    sizes = [min(max(int(rng.normal(P.query_mean, P.query_std)), 1000), n - 1)
             for _ in range(queries)]
    qs = [Range(lo, lo + m) for m in sizes for lo in [int(rng.integers(0, n - m))]]
    for label, fn in (("engine", eng.query), ("baseline", eng.baseline)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for q in qs:
                fn(family, q, **params)
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3 / queries
        rows = [(e.key, e.self_device_time_total / 1e3 / queries)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(ms for _, ms in rows)
        top = ", ".join(f"{key[:40]} {ms:.4f}" for key, ms in sorted(rows, key=lambda r: -r[1])[:3])
        print(f"    profiled {label}: {wall:.3f} ms per query, device busy {busy:.4f} ms "
              f"({busy / wall:.1%}); top device ms per query: {top or 'none seen'}")


def analytics_main_path(dev) -> dict:
    """The paper's workload through ``IncrementalAnalyticsEngine`` on the
    card, against ``baseline`` on the same queries."""
    from repro_torch.configs.paper import PAPER_WORKLOAD as P
    from repro_torch.core.descriptors import Range, coalesce
    from repro_torch.core.engine import IncrementalAnalyticsEngine
    from repro_torch.kernels.linreg_stats import kernel as lk
    from repro_torch.kernels.logreg_sgd import kernel as sk
    from repro_torch.kernels.nb_stats import kernel as nk

    n, d, n_queries = P.n_points, P.dim, 100
    print(f"  workload: {n} x {d} rows per table, models of {P.model_size_mean} rows "
          f"to coverage 0.6, {n_queries} queries of N({P.query_mean}, {P.query_std}) "
          f"rows per family (the paper runs {P.n_queries}), logreg chunk "
          f"{P.logreg_chunk}, lambda {P.logreg_lam}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tables = analytics_tables(n, d, dev)
    resident = sum(t.numel() * t.element_size()
                   for be in (tables["linreg"], tables["logreg"]) for t in (be.X, be.y))
    torch.cuda.synchronize(dev)
    print(f"  base tables on the card: {resident / 2**20:.0f} MiB, made and copied in "
          f"{time.perf_counter() - t0:.1f} s")
    kernels = {"linreg_stats": lk.KERNEL, "nb_stats": nk.KERNEL, "logreg_sgd": sk.KERNEL}
    for k in kernels.values():
        k.launches = 0
    rng = np.random.default_rng(0)
    for family in ANALYTICS_FAMILIES:
        params = family_params(family, P)
        before = {name: k.launches for name, k in kernels.items()}
        eng = IncrementalAnalyticsEngine(
            tables[family], materialize="chunks" if family == "logreg" else "always")
        ranges = []
        while sum(r.size for r in coalesce(ranges)) / n < 0.6:
            lo = int(rng.integers(0, n - P.model_size_mean))
            ranges.append(Range(lo, lo + P.model_size_mean))
        t0 = time.perf_counter()
        eng.warm(family, ranges, **params)
        warm_s = time.perf_counter() - t0
        t_ours = t_base = 0.0
        rows_ours = rows_base = reused = 0
        split = dict.fromkeys(("optimizer_s", "io_s", "compute_s", "merge_s"), 0.0)
        samples = []
        for _ in range(n_queries):
            size = min(max(int(rng.normal(P.query_mean, P.query_std)), 1000), n - 1)
            lo = int(rng.integers(0, n - size))
            q = Range(lo, lo + size)
            t0 = time.perf_counter()
            r = eng.query(family, q, **params)
            torch.cuda.synchronize(dev)
            t_ours += time.perf_counter() - t0
            t0 = time.perf_counter()
            base = eng.baseline(family, q, **params)
            torch.cuda.synchronize(dev)
            t_base += time.perf_counter() - t0
            reused += int(r.used_reuse)
            rows_ours += r.plan.base_points
            rows_base += base.plan.base_points
            for key in split:
                split[key] += getattr(r.timings, key)
            if r.used_reuse and len(samples) < 5:
                samples.append((r.model, base.model))
        print(f"  {family:12s} warm-up {len(ranges)} models in {warm_s:.2f} s, coverage "
              f"{eng.coverage(family):.0%}; reused {reused}/{n_queries} queries; engine "
              f"{t_ours:.3f} s vs baseline {t_base:.3f} s ({t_base / t_ours:.2f}x); base "
              f"rows scanned {rows_ours} vs {rows_base}; store {len(eng.store)} models, "
              f"{eng.store.nbytes()} B")
        print("    engine time split (ExecTimings, s): "
              + ", ".join(f"{k[:-2]} {v:.4f}" for k, v in split.items()))
        analytics_profile(eng, family, params, rng, n, P, dev)
        print(f"    launches (warm-up, {n_queries} queries and baselines, 10 profiled "
              f"queries and baselines): "
              f"{ {name: k.launches - before[name] for name, k in kernels.items()} }")
        check(reused > 0, f"{family}: no query reused a materialized model")
        for model, base_model in samples:
            if family == "linreg":
                err = normwise(model.weights, base_model.weights)
            elif family == "gaussian_nb":
                err = max(normwise(model.mu, base_model.mu), normwise(model.var, base_model.var))
            else:
                continue     # a mixture over other chunk boundaries is another model
            check(err <= 1e-3, f"{family}: a reused model strays from baseline's by {err}")
        if family != "logreg":
            print(f"    {len(samples)} reused queries against baseline: normwise err "
                  f"within 1e-3 (weights / NB moments)")
    counts = {name: k.launches for name, k in kernels.items()}
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"  analytics main-path launches: {counts}; max memory allocated "
          f"{mem / 2**20:.0f} MiB (resident tables {resident / 2**20:.0f} MiB)")
    check(all(v > 0 for v in counts.values()),
          f"a statistics kernel was not launched on the analytics path: {counts}")
    check(mem >= resident, "max memory allocated does not cover the resident tables")
    return counts


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
    rows = [extend_phase(dev, timer), decode_phase(dev, timer),
            linreg_stats_phase(dev, timer), nb_stats_phase(dev, timer),
            logreg_sgd_phase(dev, timer)]
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms")
    del timer

    print("[3] reduced deepseek-67b (fp32): card vs CPU")
    reduced_parity(dev)

    print(f"[4] full-width main path ({FULL_LAYERS} layers, bf16)")
    counts, eng = main_path(dev)
    print("[5] where the time goes (torch.profiler, full width)")
    where_time_goes(eng, dev)
    del eng
    torch.cuda.empty_cache()

    print("[6] analytics engine (200K x 10): card vs CPU")
    analytics_parity(dev)
    print("[7] analytics main path: the paper's workload on the card")
    counts.update(analytics_main_path(dev))

    sources = {
        "extend_attention": ("src/repro_torch/kernels/extend_attention/csrc/extend_attention.cu",
                             "src/repro/kernels/extend_attention/kernel.py:108"),
        "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:103"),
        "linreg_stats": ("src/repro_torch/kernels/linreg_stats/csrc/linreg_stats.cu",
                         "src/repro/kernels/linreg_stats/kernel.py:43"),
        "nb_stats": ("src/repro_torch/kernels/nb_stats/csrc/nb_stats.cu",
                     "src/repro/kernels/nb_stats/kernel.py:52"),
        "logreg_sgd": ("src/repro_torch/kernels/logreg_sgd/csrc/logreg_sgd.cu",
                       "src/repro/kernels/logreg_sgd/kernel.py:59"),
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
