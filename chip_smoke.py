#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card of compute
capability 9.0 and ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``).  It builds the
port's seven CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one
``nvcc`` each, in parallel; each template instance's registers and spills
printed) and runs:

  1. device: the card's name, count, and ``nvidia-smi`` name/power limit;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of the full-width serving path, in fp32 (rtol 1e-4 / atol 1e-5)
     and bf16 (against the fp32 plain version on the same bf16 values,
     rtol/atol 2e-2, and element by element within one bf16 ulp + 1e-6);
     extend also at nb 1 and nb 100 (row blocks straddling two heads) and
     bitwise invariant to padded capacity (caps 2176 vs 4096); the decode
     extend's MLA form (``ops.extend_attention_mla``: packed q·k width 192
     and v width 128 at H 128, capacity 4160, nb 128 / 1 / 100 and t_real
     128 / 2049 / 4096; then q·k 24 / v 16) against the fp32 plain version
     with the same tolerances and bitwise invariant to capacity (2176 vs
     4160), timed beside SDPA on the same mask and beside the packing it
     needs; extend's nemotron form (q·k = v = 192 at G 12, B1 KV8,
     capacity 4160, nb 128 / 1 / 100 by t_real 128 / 2049 / 4096) with the
     same tolerances, bitwise invariant to capacity (2176 vs 4160) and
     timed at nb 128, t_real 4096; extend's jamba form (hd 128 at G 4, B1
     KV8, capacity 4096, the same nine (nb, t_real) pairs) likewise; the decode
     kernel also against the plain form of its split-KV algorithm, bitwise
     invariant to padded capacity within one split and across several
     (caps 2048 vs 8192), and bitwise the same for a row alone and in a
     batch, at hd 128 (G 8), at hd 192 (G 12, B1 at position 3072 and
     B4) and at hd 128 (G 4, jamba's form, the same shapes); both at
     whisper's form (hd 64, G 1, KV 20: extend at capacity 512 over nb 128 /
     1 / 100 by t_real 128 / 257 / 448, bitwise invariant to capacity 320
     vs 512, timed at nb 64, t_real 448; decode at B1 position 431 and
     B4); the int8 dequant kernel bitwise against its plain
     version; each kernel's time (CUDA events, L2 flushed between
     launches) beside its bound, the plain version's time and one PyTorch
     library call's time (a yardstick the port never calls), the attention
     kernels with their device time from ``torch.profiler``, and decode
     also at the serving path's decode step (batch 1, position 3072);
     MLA's absorbed decode kernel against its plain version (normwise
     1e-5) and timed at ``dsv2-docqa-8k``'s B 8 pack (capacity 8256) and
     at B 1, beside its bound and the plain version's time;
  3. reduced ``deepseek-67b`` (fp32) in ``ServeEngine`` on the card vs the
     same on the CPU: identical plans and greedy tokens, with a plain store
     and with an int8 store on host and disk tiers (identical segment ids
     and tier counters too); then in bf16 (params and compute): logits
     within ``REDUCED_BF16_LOGIT_ULPS`` bf16 ulps of the CPU's, and both
     greedy streams printed; then ``SessionManager`` in fp32 over four
     sessions and three rounds under a byte budget: the card's greedy
     streams, plans and segment ids equal the CPU's, merged packs stream
     as capacity-split ones, async prefill gives sync prefill's sampled
     streams and store (payloads bitwise), and a build's dispatch
     (``dispatch_prefix``) makes no synchronising call
     (``torch.cuda.set_sync_debug_mode``);
     then ``SessionManager`` over a 2-shard ``ShardedSegmentStore`` (int8
     wire, ``scripts/sharded_smoke.py``'s traffic: four 160-token documents
     two per shard, three rounds under a per-shard budget of half the
     unbounded store's bytes, then a 1e6x straggler and two more rounds):
     the card gives the CPU's streams, plans, segment ids and
     ``shard_report()``, and the single-shard unbounded streams;
     then reduced ``deepseek-v2-236b`` (MLA + MoE) the same two ways as
     ``deepseek-67b``: fp32 with a plain store and an int8 tiered store
     (identical tokens, plans and stores, logits within
     ``REDUCED_FP32_LOGIT_ATOL``), and bf16 (logits within
     ``REDUCED_BF16_LOGIT_ULPS`` bf16 ulps), and with ``moe_groups=2``
     (two-row prefill and greedy decode: logits within
     ``REDUCED_FP32_LOGIT_ATOL``, tokens equal); then ``nemotron-4-340b``
     (squared-ReLU) the same two ways, reduced (hd 16) and reduced-wide
     (24 / 2 heads at hd 192, so G 12 and hd 192 reach both kernels), and
     ``SessionManager`` over reduced-wide as for ``deepseek-67b``; then
     reduced ``phi3-medium-14b``, ``qwen3-32b``, ``mixtral-8x7b`` and
     ``kimi-k2-1t-a32b`` in fp32 with both stores; then reduced
     ``mamba2-130m`` (SSD only: no attention kernel may launch, and an int8
     store quantizes nothing, the SSD state staying lossless) and
     ``jamba-v0.1-52b`` (SSD + GQA + MoE) the same two ways and in bf16,
     and ``SessionManager`` over reduced ``jamba-v0.1-52b`` as for
     ``deepseek-67b``; then reduced ``whisper-large-v3`` and
     ``llama-3.2-vision-11b`` (cross-attention over a 16-feature stub
     context, 0.1 N(0, 1) from the seed) the same two ways, in bf16, and
     through ``SessionManager``, and two sessions on the same tokens with
     other features must share no segment; the card must launch the
     extend kernel, and the decode kernel where the stack has attention
     layers; then reduced training card vs CPU (fp32): 3 steps of
     ``make_train_step`` on batches of 4 x 64 from ``lm_pipeline`` from the
     same parameters for ``deepseek-67b``, ``deepseek-v2-236b`` (AdamW and
     Adafactor), ``mamba2-130m`` and ``whisper-large-v3``: the loss per step
     within ``TRAIN_LOSS_ATOL``, the parameters after it within
     ``TRAIN_PARAM_NORMWISE`` of the update, and no extend or decode
     launch;
  4. the main path at full width: ``deepseek-67b`` widths, bf16, depth cut
     from 95 to 24 layers so the weights fit one 80 GB card, a 4096-token
     document, chunk 128, requests with prefixes 2048, 4096, 3072 (16 new
     tokens each) and a replay of the first, with the kernels' launch
     counters read around it;
  5. where the time goes: ``torch.profiler`` over full-width decode steps
     and one 128-token extend — device busy and idle time, top kernels,
     and the share of the port's attention kernels;
  6. residency at full width, on phase 4's model: the same requests over
     an int8 segment store (every reused segment dequantized by the
     ``quant_kv`` kernel), over the int8 store with host and disk tiers
     below a device budget, over a bf16 store with the same tiers, and
     from a snapshot of the tiered int8 store reloaded from disk, with the
     ``quant_kv`` launch counter read around the phase;
  7. the analytics engine on the card vs the same engine on the CPU (the
     kernels' plain versions): 200K x 10 rows made from a seed, one query
     script per family, identical plans and reuse, statistics within an
     fp32 tolerance;
  8. the analytics main path: the paper's workload (5M x 10 base tables
     resident on the card, 50K-row models warmed to 0.6 coverage, 100
     queries of N(50K, 12.5K) rows per family — the paper runs 1000)
     through ``IncrementalAnalyticsEngine``, against ``baseline``, with the
     statistics kernels' launch counters read around it; each family's
     model store is then saved, reloaded, and answers 10 more queries with
     the live store's plans and bitwise statistics.
  9. batched serving at full width, on phase 4's model and store (run
     after phase 6, before the model is freed): ``SessionManager`` with
     eight sessions, four on phase 4's document (prefixes 2048, 4096, 3072,
     1024) and four on their own 4096-token documents (512, 1024, 2048,
     4096), two rounds of 16 greedy tokens (the second reads a segment
     another session made and the continuations that decode write-back
     forked), async prefill, merged packs of mixed capacity; the decode
     kernel's launches must equal 24 x the decode calls (replays of the
     decode step's CUDA graphs included; the graph and pack-pool counters
     print), extend must launch, the mean batch must exceed 1 and a
     cross-session hit occur;
     every stream is compared with ``ServeEngine.generate`` on the same
     (document, prefix, 16), and where one parts the single run's top-2
     logit gap there must be within ``REDUCED_BF16_LOGIT_ULPS`` bf16 ulps
     of its largest logit.
 12. sharded serving at full width, on phase 4's model (run after phase 9,
     before the model is freed): four sessions over four 1024-token
     documents, two homed on each of two simulated shards, ``submit_many``
     at prefix 1024, 8 greedy tokens, chunk 128: (a) a plain store, 2
     rounds; (b) ``ShardedSegmentStore`` with the fp32 wire, 2 rounds
     (round 2 fetches the remote documents' segments): streams, plans and
     segment ids (document and range) bitwise (a)'s, coalescing held,
     put-forwards = the remote-homed chunks written; (c) shard 1 slowed
     1e6x, rounds 3 and 4: hedged, the rebuild wins, streams still (a)'s;
     (d) the int8 wire twice: ``quant_kv`` launches = dequantized
     segments, finite logits, the two runs bitwise equal, where a stream
     parts from (a) printed (not gated); with each round's wall time, the
     fetched bytes, the simulated transfer seconds, and one full-width
     segment's encode and decode host time beside the cost model's price.
 10. the MLA main path at full width, after phase 4's model is freed:
     ``deepseek-v2-236b`` widths (MLA, 160 routed experts top-6 plus 2
     shared), bf16, depth cut from 60 to 4 layers (1 dense + 3 MoE, 13.3 B
     parameters), the same document and requests as phase 4; requests 2
     and 3 must reuse stored segments, the replay must give identical
     tokens, the extend kernel's launches must equal 4 x the extend calls,
     and the logits must be finite; then ``torch.profiler`` over one
     extend step and one decode step, with one MoE layer's device time
     measured alone.
 11. GQA at head dim 192 at full width, after phase 10's model is freed:
     ``nemotron-4-340b`` widths (d 18432, 96 / 8 heads, hd 192, d_ff 73728
     squared-ReLU, vocab 256000 untied), bf16, depth cut from 96 to 4
     layers (23.26 B parameters), phase 4's document and requests;
     requests 2 and 3 must reuse stored segments, the replay must give
     identical tokens, the extend kernel's launches must equal 4 x the
     extend calls and the decode kernel's 4 x the decode calls, the logits
     must be finite; then phase 5's profile of decode steps and a
     128-token extend.
 13. SSD serving at full width, after phase 11's model is freed: (a)
     ``mamba2-130m`` at its published widths and full depth (24 SSD layers,
     d 768, 24 heads of 64, d_state 128, fp32 parameters, bf16 compute),
     phase 4's document and requests, a stored segment's load priced as a
     device copy at the HBM rate: no attention kernel may launch, the
     replay must give identical tokens, a cold engine's request for prefix
     3072 must give the warm request's greedy tokens, and every stored
     segment must hold the state's bytes (24 x (3 x 1792 + 24 x 64 x 128) x
     4 B) whatever its length; (b) ``jamba-v0.1-52b`` at its published
     widths, depth cut from 32 to one 8-layer period (13.27 B parameters),
     bf16, phase 4's document and requests: the extend and decode kernels'
     launches must equal 1 x their calls (one attention layer, G 4, hd
     128), the replay identical, the logits finite; then phase 5's profile
     of a decode step and a 128-token extend, split into the attention
     kernel, the SSD mixers, the MoE and dense feed-forward layers (each
     timed alone) and the rest.
 14. cross-attention serving at full width, after phase 13's model is
     freed, bf16, full depth, over a stub context of 0.1 N(0, 1) features
     from the seed, a stored segment's load priced as a device copy (the
     serving calibration's plan printed beside it): (a)
     ``whisper-large-v3`` (32 encoder layers over 1500 frames, 32 decoder
     layers of MHA at hd 64, 1.60 B parameters), one 448-token transcript,
     chunk 64, prefixes 192, 432, 320 and a replay of 192: the extend and
     decode kernels' launches must equal 32 x their calls, the replay be
     identical, a cold engine's 320 give the warm one's tokens (or part
     where the cold run's top-2 gap is within ``REDUCED_BF16_LOGIT_ULPS``
     bf16 ulps) and first logits within that many bf16 ulps of the warm
     one's largest, every stored segment carry 245,760,000 B of ck/cv
     beside its 64-token K/V; (b) ``llama-3.2-vision-11b`` (40 layers, 8 cross,
     10.13 B parameters), phase 4's document and requests: launches 40 x
     calls, the replay identical, every segment 52,461,568 B of ck/cv;
     each then profiled (a decode step, an extend, whisper's cold prefill)
     and split into the attention kernel, the cross-attention sublayers,
     the encoder, the dense FFN layers (each timed alone) and the rest.
 15. training at full width, after phase 14's model is freed, through
     ``train_loop`` on ``lm_pipeline``'s batches of 8 x 1024 (6 steps,
     ``TRAIN_LR``'s peak after 2 warmup steps): (a) ``deepseek-67b`` at its
     published widths, depth cut from 95 to 2 layers (3.06 B parameters,
     bf16, AdamW, remat full, 8 microbatches); (b) ``mamba2-130m`` at full
     depth (fp32 parameters, AdamW, 4 microbatches), checkpointed every 4
     steps and at the end through ``AsyncCheckpointer``: the last
     checkpoint restores bitwise and a step from it gives bitwise the
     in-memory state's loss.  Each prints its loss, grad norm and time per
     step (CUDA events, the first step apart), tokens/s, ``train_mfu``
     with its formula, peak memory and retries (must be 0), needs a finite
     loss that falls and no extend or decode launch, then profiles one
     more step (dense products, the optimizer, idle share; for (a) the
     blocked attention timed alone).
 16. distribution, after phase 15: a world-size-1 NCCL process group
     (``file://`` rendezvous in a temporary directory) and a (1, 1)
     ``pod`` x ``data`` ``DeviceMesh`` on ``cuda``.  (a) ``mamba2-130m``
     at full width and depth, phase 15 (b)'s model and batches: two
     uncompressed ``make_multipod_train_step`` steps give bitwise the
     parameters, optimizer state and losses of ``make_train_step`` from
     the same state; ``compressed_psum`` at n = 1 gives bitwise
     ``ef_compress``'s dequantized value and residual, leaf for leaf, from
     zero and from a carried residual.  (b) ``deepseek-67b`` at 2 layers,
     phase 15 (a)'s model, batches and lr: 6 compressed multipod steps;
     the loss finite and falling, its gap to phase 15 (a)'s last loss,
     the step time (CUDA events, the first step apart), the exchange's
     own time, retries (none) and the reckoned and measured peak memory.
     (c) tensor parallelism's form of the step on a (1, 1, 1) ``pod`` x
     ``data`` x ``model`` mesh: phase 16 (b)'s model, batches and lr with
     parameters, AdamW state and ``ef`` as ``DTensor`` s on the (1, 1)
     sub-mesh under ``use_rules``; two uncompressed steps against
     ``make_train_step`` from the same state (bitwise, or the parameters
     within 2e-3 of the update), then 6 compressed steps: the loss finite
     and falling and its gap to (b)'s, the step time beside (b)'s, the
     exchange's time and the peak memory, which must fit the card.  None
     of (a)-(c) launches an extend or decode kernel; the multi-rank checks
     are the CPU tests' (4 gloo ranks).  (d) ``python -m
     repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k
     --multi-pod --compress-pod`` in a subprocess: its seconds, argument
     and ``ef`` bytes a device, FLOPs and the pod exchange's bytes.
 17. introspection, after phase 16: (a) the registry's parameter and
     AdamW structs for phase 15 (a)'s config on a world-size-1 NCCL mesh
     equal the card's trees leaf for leaf (path, per-device shape, dtype,
     bytes), and the dry run's argument + eager temp bytes of one step
     (a fake CPU trace) print beside phase 15 (a)'s peak memory; (b)
     ``launch/op_analysis.py``'s counter on phase 15 (a)'s step on the
     card and on its fake CPU trace (FLOPs equal; ``train_mfu`` over the
     counted FLOPs beside 6·N·D's), and on phase 4's model's 128-token
     extend and decode step (FLOPs and each kernel's formula equal card
     and CPU, both kernels launched once a layer); (c) ``python -m
     repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k`` in
     a subprocess: its seconds, per-device bytes and FLOPs.

Phase 2 also checks the three analytics kernels (linreg statistics,
Naive Bayes grouped statistics, chunked logistic SGD) against their plain
versions at ``repro``'s sweep shapes with ``tests/test_kernels.py``'s
tolerances, shows that two launches on the same data agree bitwise, and
times them at the analytics path's shapes.  ``linreg_stats`` and
``nb_stats`` (50K and 5M x 10), ``logreg_sgd`` (segments of 1, 5 and 500
chunks of 10K x 10) and ``quant_kv`` (a stored segment of two 128-token,
then 4096-token leaves, through ``dequantize_tree``) are timed three ways:
the call (``Timer``), the device (every profiled device activity of one
call, and how many there are) and the host (the wrapper's enqueue time
over 200 calls).  ``linreg_stats``, ``nb_stats`` and ``quant_kv`` must
take one launch and one device kernel per call (per segment), and
``linreg_stats`` and ``nb_stats`` must give bitwise the same G 20 times
over, on views from row 0 and from odd rows, and with a second stream's
calls interleaved.  ``logreg_sgd`` fits a segment (1, 5 and 500 chunks and
a ragged tail) in one launch, within tolerance of its plain version, with
every chunk checked bitwise equal to the same chunk fitted alone, from
int32 and fp32 labels, and from a view at row 1, a copy at row 0 and a
copy 4 bytes past an 8-byte boundary.  Phase 6 needs one
``quant_kv`` launch per dequantized segment, phase 8 one launch of each
statistics kernel per statistics pass of its family (for logreg: per
segment fit, i.e. per uncovered step, baseline query and warm-up model).

Any failure exits non-zero.  The last two lines are the ``nvidia-smi``
line and ``{"ok": true, "device": {...}}``; the line before them lists
every kernel with its launches (on its own main path: batched serving,
phase 9, for the attention kernels, the MLA main path, phase 10, for
extend's MLA form and the absorbed decode kernel, phase 11 for the two
attention kernels' hd-192 forms, phase 13 (b) for their G-4 forms, phase 14 (a) for their hd-64 forms, the
residency phase and phase 12 for the dequant kernel, analytics for the
statistics kernels) and times.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
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
#: phase 10's depth: deepseek-v2-236b cut from 60 layers to its first dense
#: layer and three MoE layers (13.3 B parameters, 24.8 GiB in bf16)
MLA_LAYERS = 4
#: phase 11's depth: nemotron-4-340b cut from 96 layers to 4 (23.26 B
#: parameters, 43.3 GiB in bf16, embedding and untied head included)
NEMOTRON_LAYERS = 4
#: phase 13 (b)'s depth: jamba-v0.1-52b cut from 32 layers to one 8-layer
#: period, which holds every layer kind (SSD at 0-3 and 5-7, GQA at 4, MoE
#: on every second layer): 13.27 B parameters, 26.5 GB in bf16
JAMBA_LAYERS = 8
#: the configs whose layers the port already ran before nemotron (GQA at hd
#: 128, qk-norm, MoE on every layer, a first dense layer and a shared
#: expert): phase 3 holds each reduced one on the card against the CPU
ARCHS_8A = ("phi3-medium-14b", "qwen3-32b", "mixtral-8x7b", "kimi-k2-1t-a32b")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas=-v``: its name with
    its template arguments, registers and spills."""
    import re

    # template arguments: a type (float, bf16), an int, a bool
    arg = re.compile(r"(f|13__nv_bfloat16)|Li(\d+)E|Lb([01])E")
    out, name, spill = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            m = re.search(r"\d+([a-z_]+(?:kernel|_split|_combine))"
                          r"(I(?:f|13__nv_bfloat16|Li\d+E|Lb[01]E)+E)?", mangled)
            name = mangled[:60] if m is None else m.group(1) + (
                "" if m.group(2) is None else "<" + ", ".join(
                    {"f": "float", "13__nv_bfloat16": "bf16"}.get(t, n or
                                                                  ("true" if b == "1" else "false"))
                    for t, n, b in arg.findall(m.group(2))) + ">")
            spill = ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and name is not None:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


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


#: phase 2's extend shapes (nb, t_real) at G 8, hd 128: the main path's
#: chunk; a 1-token extend; nb 100, where G*nb = 800 is not a multiple of
#: the kernel's 64-row blocks (a block straddles two heads)
EXTEND_SHAPES = ((128, 128), (128, 2049), (128, 4096), (1, 1), (1, 3000),
                 (100, 100), (100, 4096))
#: every pair of nb 128, 1, 100 and t_real 128, 2049, 4096: at nemotron's
#: G 12, hd 192 (phase 11's form) and at jamba's G 4, hd 128 (phase 13's)
EXTEND_SHAPES_GRID = tuple((n, t) for n in (128, 1, 100) for t in (128, 2049, 4096))
#: the same nb by t_real 128, 257, 448 (whisper's transcript, phase 14 (a))
EXTEND_SHAPES_WHISPER = tuple((n, t) for n in (128, 1, 100) for t in (128, 257, 448))


def extend_phase(dev, timer, *, g: int = 8, hd: int = 128, kv: int = 8,
                 cap: int = 4096, small: int = 2176, timed=(128, 4096),
                 shapes=EXTEND_SHAPES, name: str = "extend_attention") -> dict:
    """The GQA extend kernel at B1 (``kv`` KV heads, G ``g``, head dim
    ``hd``, capacity ``cap``) against its fp32 plain version, bitwise
    invariant to capacity (``small`` vs ``cap``), then timed at ``timed`` =
    (nb, t_real)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.common import within_bf16_ulp
    from repro_torch.kernels.extend_attention.ops import extend_attention
    from repro_torch.kernels.extend_attention.ref import extend_attention_ref

    b, nb = 1, 128
    h = kv * g
    err = {}
    for dtype, (rtol, atol) in ((torch.float32, (1e-4, 1e-5)),
                                (torch.bfloat16, (2e-2, 2e-2))):
        k = randn((b, cap, kv, hd), dtype, dev, 2)
        v = randn((b, cap, kv, hd), dtype, dev, 3)
        for n, t_real in shapes:
            q = randn((b, n, h, hd), dtype, dev, 1)
            got = extend_attention(q, k, v, t_real=t_real)
            want = extend_attention_ref(q.float(), k.float(), v.float(),
                                        t_real=t_real)
            torch.cuda.synchronize()
            ok, e = within(got, want, rtol, atol)
            line = (f"  extend G{g} hd{hd} {str(dtype)[6:]:8s} nb {n:3d} t_real "
                    f"{t_real:4d}: max |err| {e:.3g} (rtol {rtol}, atol {atol})")
            ulp_ok, worst = True, 0.0
            if dtype == torch.bfloat16:
                ulp_ok, worst = within_bf16_ulp(got, want)
                line += f"; error up to {worst:.3f}x one bf16 ulp + 1e-6"
            print(line)
            check(ok, f"extend kernel disagrees with its plain version "
                      f"(G {g}, hd {hd}, {dtype}, nb {n}, t_real {t_real}, max err {e})")
            check(ulp_ok, f"bf16 extend kernel strays past one bf16 ulp of its fp32 plain "
                          f"version (G {g}, hd {hd}, nb {n}, t_real {t_real}, {worst:.3f}x)")
            err[(dtype, n, t_real)] = e

        # bit-invariance to padded capacity, garbage tail: caps small vs cap
        q = randn((b, nb, h, hd), dtype, dev, 1)
        ks, vs = k[:, :small].contiguous(), v[:, :small].contiguous()
        kb = randn((b, cap, kv, hd), dtype, dev, 7) * 100
        vb = randn((b, cap, kv, hd), dtype, dev, 8) * 100
        kb[:, :small], vb[:, :small] = ks, vs
        for t_real in (small - 76, small):
            same = torch.equal(extend_attention(q, ks, vs, t_real=t_real),
                               extend_attention(q, kb, vb, t_real=t_real))
            print(f"  extend G{g} hd{hd} {str(dtype)[6:]:8s} bit-invariant caps {small} vs "
                  f"{cap}, t_real {t_real}: {same}")
            check(same, f"extend output depends on padded capacity (G {g}, hd {hd}, "
                        f"{dtype}, t_real {t_real})")
        del kb, vb

    # timing at the main path's chunk at its last position, bf16
    dtype, (nb, t_real) = torch.bfloat16, timed
    q = randn((b, nb, h, hd), dtype, dev, 1)
    k = randn((b, cap, kv, hd), dtype, dev, 2)
    v = randn((b, cap, kv, hd), dtype, dev, 3)
    t_dev = torch.tensor(t_real, dtype=torch.int32, device=dev)
    call = lambda: extend_attention(q, k, v, t_real=t_dev)  # noqa: E731
    ms = timer.ms(call)
    dev_ms = device_ms(call, "")
    plain_ms = timer.ms(lambda: extend_attention_ref(q, k, v, t_real=t_real))
    q_pos = torch.arange(t_real - nb, t_real, device=dev)
    mask = torch.arange(cap, device=dev)[None, :] <= q_pos[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    library_ms = library_time(timer, lib, "extend")
    lib_dev = None if library_ms is None else device_ms(lib, "")
    keys = float((q_pos + 1).sum())            # causal keys this run needs
    flops = 4.0 * hd * h * b * keys
    nbytes = 2 * (2 * q.numel() + 2 * b * t_real * kv * hd) + 4
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    shape = f"B{b} KV{kv} G{g} hd{hd} nb{nb} cap{cap} t_real{t_real} bf16"
    lib_s = "n/a" if library_ms is None else f"{library_ms:.4f} ms ({lib_dev:.4f} ms device)"
    print(f"  extend timing [{shape}]: kernel {ms:.4f} ms per call ({dev_ms:.4f} ms "
          f"device), bound {bound_ms:.6f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
          f"sdpa {lib_s}")
    return {"name": name, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": max(e for (dt, *_), e in err.items() if dt == dtype),
            "shape": shape}


def mla_operands(b, nb, h, cap, widths, dtype, dev, seed):
    """q_nope, q_rope, k_nope, k_rope (shared across heads), v."""
    nope, rope, hv = widths
    return (randn((b, nb, h, nope), dtype, dev, seed),
            randn((b, nb, h, rope), dtype, dev, seed + 1),
            randn((b, cap, h, nope), dtype, dev, seed + 2),
            randn((b, cap, rope), dtype, dev, seed + 3),
            randn((b, cap, h, hv), dtype, dev, seed + 4))


def extend_mla_phase(dev, timer) -> dict:
    """Extend's MLA form (``ops.extend_attention_mla``: q·k width nope + rope,
    v width apart, G 1) against the fp32 plain version on the same packed
    operands, at full width (H 128, 192 / 128, capacity 4160) and at the
    reduced widths (24 / 16); bitwise invariant to capacity; then timed at
    the MLA main path's largest chunk beside SDPA on the same mask and the
    packing copy."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.common import within_bf16_ulp
    from repro_torch.kernels.extend_attention.ops import (extend_attention,
                                                          extend_attention_mla, pack_mla)
    from repro_torch.kernels.extend_attention.ref import extend_attention_ref

    full, small_w = (128, 64, 128), (16, 8, 16)
    err = {}
    for widths, b, h, cap in ((full, 1, 128, 4160), (small_w, 2, 4, 4160)):
        for dtype, (rtol, atol) in ((torch.float32, (1e-4, 1e-5)),
                                    (torch.bfloat16, (2e-2, 2e-2))):
            for nb in (128, 1, 100):
                qn, qr, kn, kr, v = mla_operands(b, nb, h, cap, widths, dtype, dev, 11)
                q, k = pack_mla(qn, qr, kn, kr)
                for t_real in (128, 2049, 4096):
                    got = extend_attention_mla(qn, qr, kn, kr, v, t_real=t_real)
                    want = extend_attention_ref(q.float(), k.float(), v.float(),
                                                t_real=t_real)
                    torch.cuda.synchronize()
                    ok, e = within(got, want, rtol, atol)
                    line = (f"  extend MLA {widths[0] + widths[1]}/{widths[2]} H{h} "
                            f"{str(dtype)[6:]:8s} nb {nb:3d} t_real {t_real:4d}: max |err| "
                            f"{e:.3g} (rtol {rtol}, atol {atol})")
                    ulp_ok, worst = True, 0.0
                    if dtype == torch.bfloat16:
                        ulp_ok, worst = within_bf16_ulp(got, want)
                        line += f"; error up to {worst:.3f}x one bf16 ulp + 1e-6"
                    print(line)
                    check(ok and tuple(got.shape) == (b, nb, h, widths[2]),
                          f"extend kernel's MLA form disagrees with its plain version "
                          f"({widths}, {dtype}, nb {nb}, t_real {t_real}, max err {e})")
                    check(ulp_ok, f"bf16 extend kernel's MLA form strays past one bf16 "
                                  f"ulp ({widths}, nb {nb}, t_real {t_real}, {worst:.3f}x)")
                    err[(widths, dtype, nb, t_real)] = e
                del q, k, qn, qr, kn, kr, v
            # bit-invariance to padded capacity, garbage tail: 2176 vs 4160
            small = 2176
            qn, qr, kn, kr, v = mla_operands(b, 128, h, cap, widths, dtype, dev, 21)
            kn, kr, v = kn * 100, kr * 100, v * 100
            ks, krs, vs = (x[:, :small].contiguous() for x in (kn, kr, v))
            for t_real in (2100, small):
                same = torch.equal(extend_attention_mla(qn, qr, ks, krs, vs, t_real=t_real),
                                   extend_attention_mla(qn, qr, kn, kr, v, t_real=t_real))
                print(f"  extend MLA {widths[0] + widths[1]}/{widths[2]} {str(dtype)[6:]:8s} "
                      f"bit-invariant caps {small} vs {cap}, t_real {t_real}: {same}")
                check(same, f"extend's MLA form depends on padded capacity ({widths}, "
                            f"{dtype}, t_real {t_real})")
            del qn, qr, kn, kr, v, ks, krs, vs

    # timing at the MLA main path's largest chunk: H 128, nb 128, t_real 4096,
    # capacity 4160, bf16; the kernel on the packed operands, the packing,
    # and the whole extend_attention_mla call
    dtype, b, h, nb, cap, t_real = torch.bfloat16, 1, 128, 128, 4160, 4096
    qn, qr, kn, kr, v = mla_operands(b, nb, h, cap, full, dtype, dev, 31)
    q, k = pack_mla(qn, qr, kn, kr)
    t_dev = torch.tensor(t_real, dtype=torch.int32, device=dev)
    call = lambda: extend_attention(q, k, v, t_real=t_dev)  # noqa: E731
    split = call_split(timer, call)
    pack_ms = timer.ms(lambda: pack_mla(qn, qr, kn, kr))
    mla_ms = timer.ms(lambda: extend_attention_mla(qn, qr, kn, kr, v, t_real=t_dev))
    plain_ms = timer.ms(lambda: extend_attention_ref(q, k, v, t_real=t_real))
    q_pos = torch.arange(t_real - nb, t_real, device=dev)
    mask = torch.arange(cap, device=dev)[None, :] <= q_pos[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda: sdpa(qt, kt, vt, attn_mask=mask)  # noqa: E731
    library_ms = library_time(timer, lib, "extend MLA")
    lib_dev = None if library_ms is None else device_ms(lib, "")
    keys = float((q_pos + 1).sum())            # causal keys this run needs
    hqk, hv = full[0] + full[1], full[2]
    flops = 2.0 * (hqk + hv) * h * b * keys
    nbytes = 2 * (q.numel() + b * t_real * h * (hqk + hv) + b * nb * h * hv) + 4
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    shape = f"B{b} H{h} G1 q·k{hqk} v{hv} nb{nb} cap{cap} t_real{t_real} bf16"
    lib_s = "n/a" if library_ms is None else f"{library_ms:.4f} ms ({lib_dev:.4f} ms device)"
    print(f"  extend MLA timing [{shape}]: kernel {split_line(split)}; bound "
          f"{bound_ms:.6f} ms ({bound_by}); plain {plain_ms:.4f} ms; sdpa {lib_s}; "
          f"packing q and k {pack_ms:.4f} ms ({2 * k.numel() / 1e6:.0f} MB of packed K "
          f"written); extend_attention_mla (packing + kernel) {mla_ms:.4f} ms")
    return {"name": "extend_attention_mla", "ms": split["call"], "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": max(e for (w, dt, *_), e in err.items()
                               if w == full and dt == dtype),
            "shape": shape}


#: bf16 decode kernel against decode_attention_split: a few times the
#: 5.6e-4 read on an H100 while P was rounded once to bf16, and well below
#: the output's scale (|out| ~ 0.02-0.05 at these positions); the one-ulp
#: check beside it is the tighter one
DECODE_BF16_SPLIT_TOL = (1e-2, 2e-3)


#: the decode kernel's shapes (B, capacity, positions): the serving step
#: at 3072 on phase 4's document, and B4 over the capacity; then its
#: capacity-invariance pairs (small cap, big cap, positions), within one
#: split and across several (through the combine)
DECODE_SHAPES = {"B1": (1, 3088, [3072]), "B4": (4, 4096, [0, 1000, 2049, 4095]),
                 "caps": ((256, 2048, [0, 17, 128, 255]),
                          (2048, 8192, [0, 300, 1000, 2047]))}
#: the same for whisper's 448-token transcript (phase 14 (a))
DECODE_SHAPES_WHISPER = {"B1": (1, 448, [431]), "B4": (4, 512, [0, 100, 257, 511]),
                         "caps": ((256, 2048, [0, 17, 128, 255]),
                                  (512, 8192, [0, 100, 300, 511]))}


#: the absorbed MLA decode kernel's shapes: ``dsv2-docqa-8k``'s pack (B 8 at
#: the top bucket's capacity, rows at 2048-8192 positions) and one row
MLA_DECODE_SHAPES = {"B8": (8256, [2063, 3000, 4100, 5000, 6000, 7000, 8000, 8191]),
                     "B1": (8256, [8191])}


def mla_decode_phase(dev, timer) -> dict:
    """MLA's absorbed decode kernel (``kernels/mla_decode``) at DeepSeek-V2's
    widths (H 128, kv_lora 512, rope 64, v 128, bf16) against its fp32
    plain version (normwise 1e-5: the same products summed in another
    order), then timed at each of ``MLA_DECODE_SHAPES`` beside its bound
    (the latents over the valid positions and W_uv once) and the plain
    version; no single PyTorch call computes it.  Returns the B 8 row."""
    from repro_torch.kernels.mla_decode.ops import mla_decode_attention
    from repro_torch.kernels.mla_decode.ref import mla_decode_plain

    h, l, r, v, dtype = 128, 512, 64, 128, torch.bfloat16
    scale = (128 + r) ** -0.5
    w_uv = (randn((l, h, v), torch.float32, dev, 15) * l ** -0.5).to(dtype)
    rows = {}
    for shape, (cap, pos) in MLA_DECODE_SHAPES.items():
        b = len(pos)
        q_lat, q_rope = randn((b, h, l), dtype, dev, 11), randn((b, h, r), dtype, dev, 12)
        ckv, krope = randn((b, cap, l), dtype, dev, 13), randn((b, cap, r), dtype, dev, 14)
        pt = torch.tensor(pos, dtype=torch.int32, device=dev)
        args = (q_lat, q_rope, ckv, krope, w_uv, pt)
        got = mla_decode_attention(*args, scale=scale)
        want = mla_decode_plain(*args, scale=scale)
        err = normwise(got, want)
        check(err <= 1e-5, f"mla_decode {shape}: normwise error {err} against the plain version")
        split = call_split(timer, lambda: mla_decode_attention(*args, scale=scale))
        check(split["kernels"] == 2, f"mla_decode {shape}: {split['kernels']} device "
                                     f"activities a call, want its two kernels")
        parts = {k: device_ms(lambda: mla_decode_attention(*args, scale=scale), k)
                 for k in ("mla_decode_split", "mla_decode_combine")}
        plain_ms = timer.ms(lambda: mla_decode_plain(*args, scale=scale))
        keys = sum(p + 1 for p in pos)
        flops = 2.0 * h * (2 * l + r) * keys + 2.0 * b * h * l * v
        nbytes = 2 * ((keys + b * h) * (l + r) + l * h * v) + 4 * b * h * v + 4 * b
        bound_ms, bound_by = bound(flops, nbytes, dtype)
        rows[shape] = {"name": "mla_decode", "ms": split["call"], "plain_ms": plain_ms,
                       "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                       "max_abs_err": float((got - want).abs().max()),
                       "shape": f"B{b} H{h} kv_lora{l} rope{r} v{v} cap{cap} pos{pos} bf16"}
        print(f"  mla_decode [{rows[shape]['shape']}]: {split_line(split)} (split "
              f"{parts['mla_decode_split']:.4f}, combine {parts['mla_decode_combine']:.4f}); "
              f"bound {bound_ms:.6f} ms ({bound_by}); plain {plain_ms:.4f} ms; normwise err "
              f"{err:.2e}; library none")
    return rows["B8"]


def decode_phase(dev, timer, *, g: int = 8, hd: int = 128, kv: int = 8,
                 shapes=DECODE_SHAPES, name: str = "decode_attention",
                 pack: bool = True) -> dict:
    """The decode kernel at ``kv`` KV heads (G ``g``, head dim ``hd``)
    against its plain versions at ``shapes`` (the serving step B1, and
    B4), bitwise invariant to capacity and to the batch; with ``pack``,
    also at phase 9's merged pack.  Timed at B1, B4 and the pack; returns
    the pack's row, or without one the serving step's."""
    from repro_torch.kernels.common import within_bf16_ulp
    from repro_torch.kernels.decode_attention.kernel import SPLIT
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (decode_attention_blocked,
                                                          decode_attention_split)

    h = kv * g
    split = SPLIT
    err = {}
    for dtype, (rtol, atol) in ((torch.float32, (1e-4, 1e-5)),
                                (torch.bfloat16, (2e-2, 2e-2))):
        # the serving step (B1), then B4 (kept for the invariance checks
        # below)
        for b, cap, pos in (shapes["B1"], shapes["B4"]):
            pos = torch.tensor(pos, dtype=torch.int32, device=dev)
            q = randn((b, 1, h, hd), dtype, dev, 4)
            k = randn((b, cap, kv, hd), dtype, dev, 5)
            v = randn((b, cap, kv, hd), dtype, dev, 6)
            got = decode_attention(q, k, v, pos=pos).reshape(b, kv, g, hd)
            qg = q.float()[:, 0].reshape(b, kv, g, hd)
            want_split = decode_attention_split(qg, k.float(), v.float(), pos, split=split)
            checks = [("blocked", decode_attention_blocked(qg, k.float(), v.float(), pos),
                       (rtol, atol)),
                      (f"split {split}", want_split, (rtol, atol))]
            if dtype == torch.bfloat16:     # the tensor-core path, held tighter
                checks.append((f"split {split}", want_split, DECODE_BF16_SPLIT_TOL))
            for label, want, (rt, at) in checks:
                torch.cuda.synchronize()
                ok, e = within(got, want, rt, at)
                print(f"  decode G{g} hd{hd} {str(dtype)[6:]:8s} B{b} pos {pos.tolist()} vs "
                      f"{label}: max |err| {e:.3g} (rtol {rt}, atol {at})")
                check(ok, f"decode kernel disagrees with its plain version (G {g}, hd {hd}, "
                          f"B{b}, {label}, {dtype}, rtol {rt}, atol {at}, max err {e})")
                err[dtype] = max(err.get(dtype, 0.0), e)
            if dtype == torch.bfloat16:     # and within one bf16 ulp of both
                for label, want, _ in checks[:2]:
                    ok, worst = within_bf16_ulp(got, want)
                    print(f"  decode G{g} hd{hd} bfloat16 B{b} pos {pos.tolist()} vs {label}: "
                          f"error up to {worst:.3f}x one bf16 ulp + 1e-6")
                    check(ok, f"bf16 decode kernel strays past one bf16 ulp of its fp32 "
                              f"plain version (G {g}, hd {hd}, B{b}, {label}, {worst:.3f}x)")

        # bit-invariance to padded capacity, garbage tail: one split and
        # several splits through the combine
        for small, big, pos_list in shapes["caps"]:
            p_small = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            ks, vs = k[:, :small].contiguous(), v[:, :small].contiguous()
            kb = randn((b, big, kv, hd), dtype, dev, 7) * 100
            vb = randn((b, big, kv, hd), dtype, dev, 8) * 100
            kb[:, :small], vb[:, :small] = ks, vs
            same = torch.equal(decode_attention(q, ks, vs, pos=p_small),
                               decode_attention(q, kb, vb, pos=p_small))
            print(f"  decode G{g} hd{hd} {str(dtype)[6:]:8s} bit-invariant caps {small} vs "
                  f"{big}, pos {pos_list}: {same}")
            check(same, f"decode output depends on padded capacity (G {g}, hd {hd}, "
                        f"{dtype}, caps {small} vs {big})")
            del kb, vb
        # a row's output does not depend on the rest of the batch
        full = decode_attention(q, k, v, pos=pos)
        alone = all(torch.equal(full[r:r + 1], decode_attention(
            q[r:r + 1], k[r:r + 1], v[r:r + 1], pos=pos[r:r + 1])) for r in range(b))
        print(f"  decode G{g} hd{hd} {str(dtype)[6:]:8s} each row alone == in the batch "
              f"of {b}: {alone}")
        check(alone, f"decode output of a row depends on its batch (G {g}, hd {hd}, "
                     f"{dtype})")
    if not pack:
        return decode_timing(dev, timer, g=g, hd=hd, kv=kv, shapes=shapes, name=name,
                             err=err[torch.bfloat16])

    # phase 9's merged pack, the shape whose launches the kernels line
    # reports: B 8 at capacity 4160, whose last 128-position split is
    # partial (4160 = 32.5 x 128), each row at its first and its last decode
    # position of round 2 (up to 4127, inside that partial split)
    dtype = torch.bfloat16
    pack_pos = [p for _, p in SESSION_ROUNDS[1]]
    pb, pcap = len(pack_pos), session_pack_cap()
    q = randn((pb, 1, h, hd), dtype, dev, 14)
    k = randn((pb, pcap, kv, hd), dtype, dev, 15)
    v = randn((pb, pcap, kv, hd), dtype, dev, 16)
    qg = q.float()[:, 0].reshape(pb, kv, g, hd)
    pack_err = 0.0
    for step in (0, SESSION_NEW_TOKENS - 1):
        pt = torch.tensor([p + step for p in pack_pos], dtype=torch.int32, device=dev)
        got = decode_attention(q, k, v, pos=pt).reshape(pb, kv, g, hd)
        for label, want in (
                ("blocked", decode_attention_blocked(qg, k.float(), v.float(), pt)),
                (f"split {split}", decode_attention_split(qg, k.float(), v.float(), pt,
                                                          split=split))):
            torch.cuda.synchronize()
            ok, e = within(got, want, *DECODE_BF16_SPLIT_TOL)
            ulp_ok, worst = within_bf16_ulp(got, want)
            print(f"  decode bfloat16 B{pb} cap{pcap} pos {pt.tolist()} vs {label}: "
                  f"max |err| {e:.3g} (rtol {DECODE_BF16_SPLIT_TOL[0]}, atol "
                  f"{DECODE_BF16_SPLIT_TOL[1]}); error up to {worst:.3f}x one bf16 "
                  f"ulp + 1e-6")
            check(ok, f"decode kernel disagrees with its plain version at phase 9's "
                      f"pack ({label}, cap {pcap}, max err {e})")
            check(ulp_ok, f"bf16 decode kernel strays past one bf16 ulp of its fp32 "
                          f"plain version at phase 9's pack ({label}, {worst:.3f}x)")
            pack_err = max(pack_err, e)
    del q, k, v, qg
    return decode_timing(dev, timer, g=g, hd=hd, name=name, err=pack_err,
                         pack=(pb, pcap, pack_pos))


def decode_timing(dev, timer, *, g: int, hd: int, name: str, err: float,
                  kv: int = 8, shapes=DECODE_SHAPES, pack=None) -> dict:
    """The bf16 decode kernel timed at ``shapes`` (B1, the serving step,
    and B4) and, given ``pack`` = (B, capacity, positions), phase 9's
    merged pack, each beside its bound, plain version and SDPA; returns the
    pack's row, or the serving step's without one."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.decode_attention.kernel import SPLIT
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_blocked

    dtype, split = torch.bfloat16, SPLIT
    h = kv * g
    shapes = {key: shapes[key] for key in ("B1", "B4")}
    if pack is not None:
        shapes[f"B{pack[0]}"] = pack
    rows = {}
    for shape, (bb, cc, pp) in shapes.items():
        q = randn((bb, 1, h, hd), dtype, dev, 4)
        k = randn((bb, cc, kv, hd), dtype, dev, 5)
        v = randn((bb, cc, kv, hd), dtype, dev, 6)
        pt = torch.tensor(pp, dtype=torch.int32, device=dev)
        ms = timer.ms(lambda: decode_attention(q, k, v, pos=pt))
        dev_ms = device_ms(lambda: decode_attention(q, k, v, pos=pt), "")
        qg = q[:, 0].reshape(bb, kv, g, hd)
        plain_ms = timer.ms(lambda: decode_attention_blocked(qg, k, v, pt))
        mask = (torch.arange(cc, device=dev)[None, :] <= pt[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        library_ms = library_time(timer, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True), "decode")
        keys = float((pt + 1).sum())
        flops = 4.0 * hd * h * keys
        nbytes = 2 * (2 * q.numel() + 2 * keys * kv * hd) + 4 * bb
        bound_ms, bound_by = bound(flops, nbytes, dtype)
        rows[shape] = {"name": name, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": err,
                       "shape": f"B{bb} KV{kv} G{g} hd{hd} cap{cc} pos{pp} bf16"}
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"  decode timing [{rows[shape]['shape']}, split {split}]: kernel "
              f"{ms:.4f} ms per call ({dev_ms:.4f} ms device), bound {bound_ms:.6f} ms "
              f"({bound_by}), plain {plain_ms:.4f} ms, sdpa {lib} ms")
    return rows["B1" if pack is None else f"B{pack[0]}"]


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


#: torch.profiler sessions of this run, warm-up and measured, and those of
#: each kind that traced a count of device activities that is not a whole
#: number per call (a lost event): main prints the tally
PROFILE_SESSIONS = {"warm-up": [0, 0], "measured": [0, 0]}


def device_profile(fn, kernel: str = "", launches: int = 20) -> tuple[float, float]:
    """Mean device time of one call of ``fn`` summed over the device
    activities (kernels, copies) whose name holds ``kernel``, and how many
    of them one call runs, from ``torch.profiler`` (no host time in it).
    Two sessions of ``launches`` calls: the first warms the tracer up, the
    second is the reading, whole or not; both are tallied in
    ``PROFILE_SESSIONS``.  A trace can miss a kernel that ran
    (``kernels/profiler_count.py``), so the one-launch checks count what a
    call enqueues with ``kernels.common.enqueued`` instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for role in PROFILE_SESSIONS:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and kernel in e.key]
        count = sum(e.count for e in events)
        PROFILE_SESSIONS[role][0] += 1
        PROFILE_SESSIONS[role][1] += count % launches != 0
    return (sum(e.self_device_time_total for e in events) / 1e3 / launches,
            count / launches)


def device_ms(fn, kernel: str, launches: int = 20) -> float:
    """Mean device time of one launch of the kernels whose name holds
    ``kernel``, from ``torch.profiler`` (no host time in it)."""
    return device_profile(fn, kernel, launches)[0]


def host_ms(fn, calls: int = 200) -> float:
    """The wrapper's enqueue time: the host clock over ``calls`` calls with
    no synchronise between them, per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def call_split(timer, fn) -> dict:
    """One call of ``fn`` three ways: ``call`` (``Timer``: CUDA events, L2
    flushed), ``device`` (every device activity of one call, summed, and
    ``kernels``, how many there are) and ``host`` (enqueue time)."""
    dev, kernels = device_profile(fn)
    return {"call": timer.ms(fn), "device": dev, "kernels": kernels,
            "host": host_ms(fn)}


def split_line(t: dict) -> str:
    return (f"call {t['call']:.4f} ms, device {t['device']:.4f} ms ({t['kernels']:g} "
            f"per call), host {t['host']:.4f} ms")


def library_time(timer, fn, label):
    try:
        return timer.ms(fn)
    except (TypeError, RuntimeError) as exc:   # yardstick only
        print(f"  {label} library yardstick unavailable: {exc}")
        return None


def linreg_onepass_checks(dev, X, y) -> None:
    """The narrow form at the query's and the table's shape: one launch per
    call (launch counter) and nothing else enqueued (a CUDA graph of the
    call), bitwise repeatable on views from row 0 and from an odd row, and
    undisturbed by a second stream's calls interleaved with the first's
    (each stream has its own ticket)."""
    from repro_torch.kernels.common import enqueued
    from repro_torch.kernels.linreg_stats import kernel as lk
    from repro_torch.kernels.linreg_stats.ops import zt_z

    n = X.shape[0]
    views = {f"{m} rows from row {lo}": (X[lo:lo + m], y[lo:lo + m])
             for m, lo in ((50_000, 0), (50_000, 1), (n, 0), (n - 1, 1))}
    ref = {}
    for label, (Xv, yv) in views.items():
        before = lk.KERNEL.launches
        ref[label] = zt_z(Xv, yv)
        launches = lk.KERNEL.launches - before
        ops = enqueued(lambda: zt_z(Xv, yv))
        again = [zt_z(Xv, yv) for _ in range(20)]
        torch.cuda.synchronize()
        same = all(torch.equal(G, ref[label]) for G in again)
        print(f"  linreg_stats {label} x {X.shape[1]}: {launches} launch per call, "
              f"enqueues {ops} per call; 20 more calls bitwise equal: {same}")
        check(launches == 1 and ops == {"kernel": 1}, f"linreg_stats at {label}: "
                                                      f"{launches} launches, enqueues {ops}")
        check(same, f"linreg_stats is not bitwise repeatable at {label}")
    side = torch.cuda.Stream(dev)
    labels = list(views)
    mixed = []
    for i in range(12):
        a, b = labels[i % 4], labels[(i + 1) % 4]
        with torch.cuda.stream(side):
            mixed.append((a, zt_z(*views[a])))
        mixed.append((b, zt_z(*views[b])))
    torch.cuda.synchronize()
    same = all(torch.equal(G, ref[label]) for label, G in mixed)
    print(f"  linreg_stats on two streams, 24 calls interleaved: bitwise each view's "
          f"single-stream result: {same}")
    check(same, "a second stream's linreg_stats calls disturbed the first's")


def linreg_stats_phase(dev, timer) -> dict:
    from repro_torch.kernels.linreg_stats.ops import linreg_stats, zt_z
    from repro_torch.kernels.linreg_stats.ref import linreg_stats_ref

    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol = 5e-3 if dtype == torch.bfloat16 else 5e-4
        for n in (1, 3, 64, 513, 2048, 50_000):
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
        print(f"  linreg_stats {str(dtype)[6:]:8s} n 1/3/64/513/2048/50000 x d 3/10/127/130: "
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
    linreg_onepass_checks(dev, X, y)

    rows = {}
    for m in (50_000, n):
        Xm, ym = X[:m], y[:m]
        Z = torch.cat([Xm, ym[:, None]], 1)
        t = call_split(timer, lambda: zt_z(Xm, ym))
        sliced = call_split(timer, lambda: linreg_stats(Xm, ym))
        lib = call_split(timer, lambda: torch.matmul(Z.T, Z))
        plain_ms = timer.ms(lambda: linreg_stats_ref(Xm, ym))
        bound_ms, bound_by = bound(2.0 * m * (d + 1) ** 2,
                                   4.0 * (m * (d + 1) + (d + 1) ** 2), torch.float32)
        rows[m] = t, plain_ms, lib["call"], bound_ms, bound_by
        print(f"  linreg_stats {m} x {d} fp32: kernel (zt_z, the path's call) "
              f"{split_line(t)}; bound {bound_ms:.4f} ms ({bound_by}), plain "
              f"{plain_ms:.4f} ms, library matmul(Z.T, Z) {split_line(lib)}; "
              f"linreg_stats (G sliced into A, B) {split_line(sliced)}")
    t, plain_ms, library_ms, bound_ms, bound_by = rows[50_000]
    return {"name": "linreg_stats", "ms": t["call"], "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err[torch.float32], "shape": f"n 50000 d {d} fp32"}


def nb_onepass_checks(dev, X, y, c) -> float:
    """One launch per call (launch counter) and nothing else enqueued (a CUDA
    graph of the call) at the query's and the table's shape, on views from
    row 0 and from odd rows (whose X starts off
    a 16-byte boundary at d 10, so the staged spans have element heads and
    tails): counts exact and S, SS within tolerance of the plain version on
    the same view (rtol 1e-4, atol 1e-3 / 1e-2 per 1024 rows), bitwise
    repeatable, and undisturbed by a second stream's calls interleaved with
    the first's (each stream has its own ticket).  Returns the largest
    error against the plain version."""
    from repro_torch.kernels.common import enqueued
    from repro_torch.kernels.nb_stats import kernel as nk
    from repro_torch.kernels.nb_stats.ops import grouped_stats
    from repro_torch.kernels.nb_stats.ref import grouped_stats_ref

    n = X.shape[0]
    views = {f"{m} rows from row {lo}": (X[lo:lo + m], y[lo:lo + m])
             for m, lo in ((50_000, 0), (50_000, 1), (n, 0), (n - 3, 3))}
    d = X.shape[1]
    ref, err = {}, 0.0
    for label, (Xv, yv) in views.items():
        before = nk.KERNEL.launches
        ref[label] = G = grouped_stats(Xv, yv, c)
        launches = nk.KERNEL.launches - before
        want = grouped_stats_ref(Xv, yv, c)
        torch.cuda.synchronize()
        counts = torch.equal(G[:, 0], want[:, 0])
        scale = max(1.0, Xv.shape[0] / 1024)
        errs = []
        for name, cols, atol in (("S", slice(1, 1 + d), 1e-3), ("SS", slice(1 + d, None), 1e-2)):
            ok, e = within(G[:, cols], want[:, cols], 1e-4, atol * scale)
            check(ok, f"nb_stats disagrees with its plain version at {label} ({name}, "
                      f"max err {e})")
            errs.append(e)
        err = max(err, *errs)
        ops = enqueued(lambda: grouped_stats(Xv, yv, c))
        again = [grouped_stats(Xv, yv, c) for _ in range(20)]
        torch.cuda.synchronize()
        same = all(torch.equal(G, ref[label]) for G in again)
        print(f"  nb_stats {label} x {d}, C {c}: {launches} launch per call, "
              f"enqueues {ops} per call; vs plain: counts exact {counts}, "
              f"max |err| S {errs[0]:.3g}, SS {errs[1]:.3g}; 20 more calls bitwise "
              f"equal: {same}")
        check(counts, f"nb_stats counts differ from the plain version's at {label}")
        check(launches == 1 and ops == {"kernel": 1}, f"nb_stats at {label}: "
                                                      f"{launches} launches, enqueues {ops}")
        check(same, f"nb_stats is not bitwise repeatable at {label}")
    side = torch.cuda.Stream(dev)
    labels = list(views)
    mixed = []
    for i in range(12):
        a, b = labels[i % 4], labels[(i + 1) % 4]
        with torch.cuda.stream(side):
            mixed.append((a, grouped_stats(*views[a], c)))
        mixed.append((b, grouped_stats(*views[b], c)))
    torch.cuda.synchronize()
    same = all(torch.equal(G, ref[label]) for label, G in mixed)
    print(f"  nb_stats on two streams, 24 calls interleaved: bitwise each view's "
          f"single-stream result: {same}")
    check(same, "a second stream's nb_stats calls disturbed the first's")
    return err


def nb_stats_phase(dev, timer) -> dict:
    from repro_torch.kernels.nb_stats.ops import grouped_stats, nb_stats
    from repro_torch.kernels.nb_stats.ref import nb_stats_ref

    def labels(n, c, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        y = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
        y[::17] = -1                       # unlabelled rows count nowhere
        return y

    err = 0.0
    for c in (2, 13):
        for d in (10, 129):
            for n in (1024, 50_000, 70_000):
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
    print(f"  nb_stats C 2/13 x d 10/129 x n 1024/50000/70000: counts exact, max |err| "
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
    err = max(err, nb_onepass_checks(dev, X, y, c))

    rows = {}
    for m in (50_000, n):
        Xm, ym = X[:m], y[:m]
        G = torch.cat([torch.ones((m, 1), device=dev), Xm, Xm * Xm], 1)[ym >= 0]
        y64 = ym[ym >= 0].long()
        t = call_split(timer, lambda: grouped_stats(Xm, ym, c))
        lib = call_split(timer, lambda: torch.zeros((c, 1 + 2 * d), device=dev)
                         .index_add_(0, y64, G))
        plain_ms = timer.ms(lambda: nb_stats_ref(Xm, ym, c))
        bound_ms, bound_by = bound(m * (3.0 * d + 1), 4.0 * (m * (d + 1) + c * (1 + 2 * d)),
                                   torch.float32)
        rows[m] = t, plain_ms, lib["call"], bound_ms, bound_by
        print(f"  nb_stats {m} x {d} fp32, C {c}: kernel (grouped_stats, the path's call) "
              f"{split_line(t)}; bound {bound_ms:.4f} ms ({bound_by}), plain "
              f"{plain_ms:.4f} ms, library index_add_ {split_line(lib)}")
    t, plain_ms, library_ms, bound_ms, bound_by = rows[50_000]
    return {"name": "nb_stats", "ms": t["call"], "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "shape": f"n 50000 d {d} C {c} fp32"}


def logreg_segment_checks(dev, X, y, l, batch) -> float:
    """The segment form at 1, 5 and 500 chunks, each with a ragged last
    chunk: one launch per segment, within tolerance of the plain version
    (1 and 5 chunks), every chunk checked bitwise equal to the same chunk
    fitted alone (1 and 5; chunks 0, 250, 499 and the tail at 500), from
    int32 and fp32 labels and from the same rows as a view at row 1, a copy
    at row 0 and a copy 4 bytes past an 8-byte boundary.  Returns the
    largest error against the plain version."""
    from repro_torch.kernels.logreg_sgd import kernel as sk
    from repro_torch.kernels.logreg_sgd.ops import logreg_sgd, logreg_sgd_segment

    err = 0.0
    for p in (1, 5, 500):
        n = p * l + 4_321                                 # a ragged last chunk
        word1 = torch.empty(n * X.shape[1] + 1, device=dev)[1:].view(n, X.shape[1])
        word1.copy_(X[1:n + 1])
        views = {"view at row 1": (X[1:n + 1], y[1:n + 1]),
                 "copy at row 0": (X[1:n + 1].clone(), y[1:n + 1].clone()),
                 "copy 4 bytes past an 8-byte boundary": (word1, y[1:n + 1])}
        got = {}
        for label, (Xv, yv) in views.items():
            before = sk.KERNEL.launches
            W = logreg_sgd_segment(Xv, yv, chunk_size=l, batch=batch)
            launches = sk.KERNEL.launches - before
            Wf = logreg_sgd_segment(Xv, yv.float(), chunk_size=l, batch=batch)
            chunks = range(p + 1) if p < 500 else (0, 250, 499, 500)
            alone = [logreg_sgd(Xv[k * l:(k + 1) * l], yv[k * l:(k + 1) * l], batch=batch)
                     for k in chunks]
            torch.cuda.synchronize()
            same = torch.equal(W, Wf) and all(torch.equal(a, W[k]) for a, k in zip(alone, chunks))
            check(launches == 1, f"logreg_sgd: {launches} launches for a segment of {p + 1} chunks")
            check(same, f"logreg_sgd: a chunk alone differs from the same chunk in a "
                        f"segment of {p + 1} ({label}), or int32 and fp32 labels differ")
            got[label] = W
        if p < 500:
            Xv, yv = views["view at row 1"]
            want = logreg_sgd_segment(Xv.cpu(), yv.cpu(), chunk_size=l, batch=batch).to(dev)
            ok, e = within(got["view at row 1"], want, 2e-4, 2e-5)
            check(ok, f"logreg_sgd segment of {p + 1} chunks disagrees with its plain "
                      f"version (max err {e})")
            err = max(err, e)
        first = next(iter(got.values()))
        same = all(torch.equal(first, W) for W in got.values())
        print(f"  logreg_sgd segment of {p} x {l} + 4321 rows ({p + 1} chunks), x "
              f"{X.shape[1]}, batch {batch}: 1 launch; every chunk checked bitwise equal "
              f"alone and in the segment, int32 = fp32 labels, the same bits from a view "
              f"at row 1, a copy at row 0 and one 4 bytes off: {same}"
              + (f"; max |err| vs plain {e:.3g}" if p < 500 else ""))
        check(same, "logreg_sgd depends on the row offset of its view")
    return err


def logreg_sgd_phase(dev, timer) -> dict:
    from repro_torch.kernels.common import pad_axis, round_up
    from repro_torch.kernels.logreg_sgd.ops import logreg_sgd_batched, logreg_sgd_segment
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
    Xs, ys = X.reshape(p * l, d), y.reshape(p * l).to(torch.int32)
    Xs = torch.cat([Xs, Xs[:4_322]])                     # room for the ragged tails
    ys = torch.cat([ys, ys[:4_322]])
    err = max(err, logreg_segment_checks(dev, Xs, ys, l, batch))

    rows = {}
    steps = -(-l // batch)
    for q in (1, 5, p):                  # a chunk, the 50K-row query, the table
        m = q * l
        Xq, yq = Xs[:m], ys[:m]
        t = call_split(timer, lambda: logreg_sgd_segment(Xq, yq, chunk_size=l, batch=batch))
        plain_ms = timer.ms(lambda: plain(X[:q], y[:q], batch, 0.5), iters=5)
        bound_ms, bound_by = bound(m * (4.0 * d + 6) + q * steps * 6.0 * d,
                                   4.0 * (m * (d + 1) + q * (d + 1)), torch.float32)
        rows[q] = t, plain_ms, None, bound_ms, bound_by
        print(f"  logreg_sgd segment of {q} chunk(s) of {l} x {d}, batch {batch} "
              f"(int32 labels): kernel {split_line(t)}; bound {bound_ms:.6f} ms "
              f"({bound_by}), {steps} dependent steps per chunk, plain {plain_ms:.4f} ms, "
              f"no library call")
    t, plain_ms, library_ms, bound_ms, bound_by = rows[5]
    return {"name": "logreg_sgd", "ms": t["call"], "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err,
            "shape": f"segment of 5 chunks l {l} d {d} batch {batch} fp32"}


def quant_kv_phase(dev, timer) -> dict:
    """The int8 KV dequant kernel bitwise against its plain version (one
    fp32 multiply, one rounding to the output type), then timed on a
    stored segment of the full-width path."""
    from repro_torch.core.quant import dequantize_tree, quantize_leaf, quantize_tree
    from repro_torch.kernels.common import enqueued
    from repro_torch.kernels.quant_kv import kernel as qk
    from repro_torch.kernels.quant_kv.ops import dequantize_leaf
    from repro_torch.kernels.quant_kv.ref import dequantize_leaf_ref

    # tests/test_quant.py's per-head rank-5 and headless rank-4 leaves, S
    # not a multiple of the block, cols 4/8 (scalar path), 16, 24, 128, and
    # the path's own leaves; every leaf starts with an all-zero block
    cases = [((2, 1, 24, 2, 8), 8), ((2, 1, 16, 2, 4), 8), ((3, 1, 17, 4, 16), 4),
             ((2, 1, 20, 3, 24), 8), ((3, 1, 17, 24), 8), ((2, 1, 40, 128), 16),
             ((24, 1, 128, 8, 128), 64), ((24, 1, 4096, 8, 128), 64)]
    err = 0.0
    for shape, block in cases:
        x = randn(shape, torch.float32, dev, 60) * 3
        x[:, :, :block] = 0
        q, s = quantize_leaf(x, block)
        for dtype in (torch.float32, torch.bfloat16):
            got = dequantize_leaf(q, s, block=block, dtype=dtype)
            want = dequantize_leaf_ref(q, s, block=block, dtype=dtype)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            check(torch.equal(got, want), f"quant_kv differs from its plain version "
                                          f"({shape}, block {block}, {dtype}, max err {e})")
            err = max(err, e)
    print(f"  quant_kv {len(cases)} leaves x fp32/bf16 out: bitwise equal to the plain "
          f"version (max |err| {err})")

    # a stored segment of the full-width path: k and v leaves (24 layers,
    # batch 1, S tokens, 8 KV heads, hd 128) in bf16, through the path's
    # own entry point (core/quant.py::dequantize_tree)
    rows = {}
    d0, d1, H, cols, block = 24, 1, 8, 128, 64
    for S in (128, 4096):
        x = {"k": randn((d0, d1, S, H, cols), torch.bfloat16, dev, 61),
             "v": randn((d0, d1, S, H, cols), torch.bfloat16, dev, 62)}
        qtree, meta = quantize_tree(x, block=block)
        del x
        nb = S // block
        qs = torch.stack([qtree["k"], qtree["v"]]).view(2, d0, d1, nb, block, H, cols)
        ss = torch.stack([meta.scales[j] for j in sorted(meta.scales)]).view(
            2, d0, d1, nb, 1, H, 1)
        call = lambda: dequantize_tree(qtree, meta)  # noqa: E731
        got, want = call(), {k: dequantize_leaf_ref(q, meta.scales[str(j)], block=block,
                                                    dtype=torch.bfloat16)
                             for j, (k, q) in enumerate(sorted(qtree.items()))}
        torch.cuda.synchronize()
        check(all(torch.equal(got[k], want[k]) for k in want),
              f"quant_kv segment of S {S} differs from its plain version")
        before = qk.KERNEL.launches
        call()
        launches = qk.KERNEL.launches - before
        t = call_split(timer, call)
        ops = enqueued(call)
        print(f"  quant_kv segment of S {S}: bitwise equal to the plain version; "
              f"{launches} launch per segment, enqueues {ops} per segment")
        check(launches == 1 and ops == {"kernel": 1},
              f"quant_kv took {launches} launches and enqueued {ops} for one segment")
        lib = call_split(timer, lambda: torch.mul(qs, ss))
        plain_ms = timer.ms(lambda: {k: dequantize_leaf_ref(q, meta.scales[str(j)], block=block,
                                                            dtype=torch.bfloat16)
                                     for j, (k, q) in enumerate(sorted(qtree.items()))})
        numel = 2 * qtree["k"].numel()
        bound_ms, bound_by = bound(float(numel), 3.0 * numel + 4.0 * ss.numel(),
                                   torch.float32)
        rows[S] = t, plain_ms, lib["call"], bound_ms, bound_by
        print(f"  quant_kv segment of two ({d0}, {d1}, {S}, {H}, {cols}) int8 leaves -> "
              f"bf16, block {block}: kernel {split_line(t)}; bound {bound_ms:.6f} ms "
              f"({bound_by}), plain {plain_ms:.4f} ms, library torch.mul over the "
              f"stacked leaves (fp32 out) {split_line(lib)}")
        del qtree, meta, qs, ss, got, want
    t, plain_ms, library_ms, bound_ms, bound_by = rows[128]
    return {"name": "quant_kv", "ms": t["call"], "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err,
            "shape": "segment of two (24, 1, 128, 8, 128) leaves, block 64, int8 -> bf16"}


# ---------------------------------------------------------------------------
# phase 3: reduced model, card vs CPU
# ---------------------------------------------------------------------------

#: phase 3's fp32 runs: the card's last-position logits against the CPU's
#: (cuBLAS and the kernels sum in another order than the CPU; on the CPU
#: the port's fp32 logits stay within 2e-7 of repro's)
REDUCED_FP32_LOGIT_ATOL = 1e-4


def reduced_wide(cfg):
    """``reduced(cfg)`` at 24 query heads over 2 KV heads of width 192:
    nemotron-4-340b's G 12 and head dim 192 at the reduced model's size."""
    from repro_torch.configs import reduced

    return dataclasses.replace(reduced(cfg), n_heads=24, n_kv_heads=2, head_dim=192)


def context_features(cfg, seed: int = 0) -> dict:
    """A cross-attention stack's stub context, 0.1 N(0, 1) from ``seed`` as
    fp32 host arrays: ``enc_feats`` (1, frames, d) or ``image_embeds`` (1,
    patches, d); empty for a stack without cross layers."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, n in (("enc_feats", cfg.encoder_context), ("image_embeds", cfg.vision_context)):
        if n:
            out[key] = (0.1 * rng.standard_normal((1, n, cfg.d_model))).astype(np.float32)
    return out


def reduced_parity(dev, cfg) -> None:
    """A reduced fp32 config in ``ServeEngine`` on the card against the
    same on the CPU, with a plain store and an int8 store on host and disk
    tiers: identical tokens, plans and stores, logits within
    ``REDUCED_FP32_LOGIT_ATOL``; the card must launch the extend kernel,
    and the decode kernel where the stack has attention layers."""
    from repro_torch.core.descriptors import Range
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.extend_attention import kernel as ek
    from repro_torch.models.common import tree_map_with_path
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import SegmentStore

    cpu_model = LM(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    gpu_model = LM(cfg, device=dev)
    gpu_params = tree_map_with_path(lambda _, x: x.to(dev), cpu_params)
    kinds = [spec.mixer for period, _ in cpu_model.segments for spec in period]
    attention = any(k in ("attn", "mla") for k in kinds)
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 256).astype(np.int32)
    ctx = context_features(cfg)
    with torch.no_grad():
        _, caches = cpu_model.prefill(
            cpu_params, {"tokens": torch.from_numpy(doc[None, :64]), **ctx})
    one = SegmentStore(precision="int8", device="cpu")
    one.put(Range(0, 64), caches)
    seg = one.nbytes()
    spill = Path(tempfile.mkdtemp(prefix="repro_torch_smoke_"))
    try:
        for label, store_kw in (
                ("plain store", None),
                ("int8 store, host and disk tiers",
                 dict(precision="int8", byte_budget=2 * seg + 1, host_budget=seg + 1))):
            engines = {}
            for name, m, p in (("cpu", cpu_model, cpu_params), ("cuda", gpu_model, gpu_params)):
                store = None if store_kw is None else SegmentStore(
                    spill_dir=spill / f"{name}-{len(engines)}", device=m.device, **store_kw)
                engines[name] = ServeEngine(m, p, doc, extras=ctx, chunk_tokens=64,
                                            device=m.device,
                                            **({} if store is None else {"store": store}))
            launches, decodes = ek.KERNEL.launches, dk.KERNEL.launches
            for prefix, n_new in ((200, 4), (256, 4), (130, 4), (256, 4)):
                out = {}
                for name, eng in engines.items():
                    toks, plan = eng.generate(prefix, n_new)
                    out[name] = (toks, [(s.rng.lo, s.rng.hi, s.model_id)
                                        for s in plan.steps])
                print(f"  {label}, prefix {prefix}: cuda tokens {out['cuda'][0]} cpu "
                      f"tokens {out['cpu'][0]}, plan steps {len(out['cuda'][1])}")
                check(out["cuda"] == out["cpu"],
                      f"reduced model ({label}): card and CPU disagree at prefix "
                      f"{prefix}: {out}")
            launches = ek.KERNEL.launches - launches
            decodes = dk.KERNEL.launches - decodes
            widths = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                       cfg.mla.v_head_dim) if cfg.mla else (cfg.head_dim, cfg.head_dim))
            print(f"  {label}: extend kernel launches on the card at (q·k, v) widths "
                  f"{widths}: {launches}; decode kernel launches: {decodes}")
            if attention:
                check(launches > 0, f"reduced model ({label}): the card ran no extend kernel")
                check(cfg.mla is not None or decodes > 0,
                      f"reduced model ({label}): the card ran no decode kernel")
            else:
                check(launches == decodes == 0,
                      f"reduced model ({label}) has no attention layer, yet the card "
                      f"launched attention kernels: extend {launches}, decode {decodes}")
            st = {}
            for name, eng in engines.items():
                eng.store.flush_saves()
                s = eng.store
                st[name] = (sorted(s._segs), eng.builder.dequants, s.quantized,
                            dict(s.demotions), dict(s.promotions), s.evictions,
                            s.tier_bytes())
            print(f"  {label}: segments {len(st['cuda'][0])}, dequants {st['cuda'][1]}, "
                  f"quantized {st['cuda'][2]}, demotions {st['cuda'][3]}, promotions "
                  f"{st['cuda'][4]}, evictions {st['cuda'][5]}; card == CPU: "
                  f"{st['cuda'] == st['cpu']}")
            check(st["cuda"] == st["cpu"],
                  f"reduced model ({label}): store state differs: {st}")
            if store_kw is not None:
                # a stack without sequence leaves (SSD only) stores state,
                # which int8 never quantizes: nothing to dequantize
                check((st["cuda"][1] > 0) == attention and min(st["cuda"][3].values()) > 0
                      and min(st["cuda"][4].values()) > 0,
                      f"reduced int8 tiered run skipped a tier or the dequant: {st['cuda']}")
            logits = {name: torch.cat([
                eng.builder.prefix_with_logits(doc, n, doc_id=eng.doc_id, extras=eng.context,
                                               capacity=n + 8)[0].float().cpu()
                for n in (200, 256, 130)]) for name, eng in engines.items()}
            d = float((logits["cuda"] - logits["cpu"]).abs().max())
            print(f"  {label}: logits at prefixes 200, 256, 130: card vs CPU max |d| "
                  f"{d:.3g} (limit {REDUCED_FP32_LOGIT_ATOL})")
            check(d <= REDUCED_FP32_LOGIT_ATOL,
                  f"reduced model ({label}): card and CPU logits differ by {d}")
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    print(f"  reduced {cfg.name} (mixers {kinds}, hd {cfg.head_dim}) cuda-vs-cpu: "
          f"identical plans, tokens and stores: True")


#: phase 3's bf16 run: the card's logits within this many bf16 ulps of the
#: largest CPU logit.  Both devices round every bf16 matmul output and hidden
#: state once, summing in different orders (cuBLAS against the CPU's
#: kernels), so the two layers' hidden states may sit an ulp apart before
#: the logits are rounded to bf16 themselves; on the CPU, bf16 against fp32
#: on the same weights differs by 0.5-0.75 ulps of the largest logit at
#: these prefixes.
REDUCED_BF16_LOGIT_ULPS = 4


def reduced_bf16_parity(dev, cfg) -> None:
    """A reduced config with bf16 params and compute: the card (the bf16
    kernels) against the CPU's plain route (fp32 attention math, fp32 P),
    at the logits of three prefixes and in greedy streams; the CPU's fp32
    run on the same weights gives the scale of bf16 rounding."""
    from repro_torch.kernels.common import bf16_ulp
    from repro_torch.models.common import tree_map_with_path
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    cpu_params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    runs = {"cpu": (LM(cfg, device="cpu"), cpu_params),
            "cuda": (LM(cfg, device=dev),
                     tree_map_with_path(lambda _, x: x.to(dev), cpu_params)),
            "cpu fp32": (LM(cfg32, device="cpu"),
                         tree_map_with_path(lambda _, x: x.float(), cpu_params))}
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 256).astype(np.int32)
    ctx = context_features(cfg)
    prefixes, requests = (200, 256, 130), ((200, 8), (256, 8), (130, 8), (256, 8))
    logits, streams = {}, {}
    for name, (model, params) in runs.items():
        eng = ServeEngine(model, params, doc, extras=ctx, chunk_tokens=64,
                          device=model.device)
        logits[name] = torch.cat([
            eng.builder.prefix_with_logits(doc, n, doc_id=eng.doc_id, extras=eng.context,
                                           capacity=n + 8)[0].float().cpu()
            for n in prefixes])
        streams[name] = [eng.generate(n, n_new)[0] for n, n_new in requests]
    ulp = float(bf16_ulp(logits["cpu"].abs().max()))
    d_card = float((logits["cuda"] - logits["cpu"]).abs().max())
    d_fp32 = float((logits["cpu fp32"] - logits["cpu"]).abs().max())
    print(f"  bf16 logits at prefixes {prefixes}: card vs CPU max |d| {d_card:.4g} "
          f"({d_card / ulp:.2f} bf16 ulps of the largest logit "
          f"{float(logits['cpu'].abs().max()):.4g}; limit {REDUCED_BF16_LOGIT_ULPS}); "
          f"CPU bf16 vs CPU fp32 {d_fp32:.4g} ({d_fp32 / ulp:.2f} ulps)")
    for (n, _), a, c in zip(requests, streams["cuda"], streams["cpu"]):
        part = next((i for i, (x, y) in enumerate(zip(a, c)) if x != y), None)
        print(f"  bf16 prefix {n}: cuda tokens {a} cpu tokens {c}: "
              + ("identical" if part is None else f"part at token {part}"))
    check(d_card <= REDUCED_BF16_LOGIT_ULPS * ulp,
          f"reduced bf16 model: card and CPU logits differ by {d_card} "
          f"(> {REDUCED_BF16_LOGIT_ULPS} bf16 ulps of {ulp})")


def session_script(mgr, docs, *, greedy: bool = True, extras=None):
    """Phase 3's session script: four sessions over three 256-token
    documents (each with ``extras``, a cross stack's context), three rounds
    of mixed prefixes (one request covers its whole document, so its
    write-back forks it and the next round reads the continuation), an
    edit before the last round.  Returns (streams, plans with segment
    ids)."""
    a, b, c = docs
    s = [mgr.add_session(d, extras=extras) for d in (a, a, b, c)]
    rounds = (((s[0], 200, 4), (s[1], 256, 4), (s[2], 130, 4), (s[3], 64, 6)),
              ((s[0], 100, 3), (s[1], 260, 4), (s[2], 256, 4), (s[3], 200, 2)),
              ((s[0], 250, 4), (s[1], 200, 3), (s[2], 220, 4), (s[3], 256, 3)))
    streams, plans = [], []
    for r, reqs in enumerate(rounds):
        if r == 2:
            edited = mgr.sessions[s[2]].doc.copy()
            edited[150] = (edited[150] + 1) % 512
            mgr.update_document(s[2], edited)
        for sid, n, k in reqs:
            plan = mgr.submit(sid, n, k, greedy=greedy, seed=10 * r + sid)
            plans.append([(st.rng.lo, st.rng.hi, st.model_id) for st in plan.steps])
        streams.append(mgr.run())
    return streams, plans


def store_state(store) -> tuple:
    """Segment ids with ranges, owners, aliases and hits, the per-document
    traffic, and evictions: what async and sync prefill must agree on."""
    segs = [(sid, seg.rng.lo, seg.rng.hi, seg.doc_id, seg.hits,
             tuple(sorted(seg.aliases))) for sid, seg in store._segs.items()]
    return segs, sorted(store._doc_stats.items()), store.evictions


def reduced_sessions(dev, cfg) -> None:
    """``SessionManager`` on a reduced fp32 config: the card's greedy
    streams, plans and segment ids equal the CPU's under a byte budget; on
    the card, merged packs stream as capacity-split ones, and async prefill
    gives sync prefill's sampled streams and store, payloads bitwise."""
    from repro_torch.models.common import tree_leaves, tree_map_with_path
    from repro_torch.models.lm import LM
    from repro_torch.serve.session import SessionManager

    cpu_model = LM(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    gpu_model = LM(cfg, device=dev)
    gpu_params = tree_map_with_path(lambda _, x: x.to(dev), cpu_params)
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, cfg.vocab_size, 256).astype(np.int32) for _ in range(3)]
    runs = {"cpu": (cpu_model, cpu_params), "cuda": (gpu_model, gpu_params)}
    ctx = context_features(cfg)
    script = lambda mgr, **kw: session_script(mgr, docs, extras=ctx, **kw)  # noqa: E731

    def manager(name, **kw):
        m, p = runs[name]
        return SessionManager(m, p, chunk_tokens=64, max_batch=8, **kw)

    probe = manager("cuda")
    script(probe)
    budget = probe.store.nbytes() // 2
    out = {}
    for name in runs:
        mgr = manager(name, byte_budget=budget)
        streams, plans = script(mgr)
        out[name] = (streams, plans, sorted(mgr.store._segs), mgr.store.evictions,
                     mgr.store.cross_session_hits, mgr.sched.decode_segments)
    c = out["cuda"]
    print(f"  sessions, budget {budget} B: {sum(len(t) for r in c[0] for t in r.values())} "
          f"tokens in {len(c[1])} requests, {len(c[2])} segments, evictions {c[3]}, "
          f"cross-session hits {c[4]}, decode segments {c[5]}; card == CPU: "
          f"{out['cuda'] == out['cpu']}")
    check(out["cuda"] == out["cpu"],
          "reduced sessions: card and CPU disagree in tokens, plans or segments")
    check(c[3] > 0 and c[4] > 0 and c[5] > 0,
          f"reduced sessions skipped eviction, cross-session reuse or write-back: {c[3:]}")
    split = manager("cuda", async_prefill=False, merge_decode_packs=False)
    merged = manager("cuda", async_prefill=False)
    same = script(split)[0] == script(merged)[0]
    print(f"  merged packs (mean batch {merged.sched.mean_batch:.2f}) vs capacity-split "
          f"(mean batch {split.sched.mean_batch:.2f}): identical streams: {same}")
    check(same, "reduced sessions: merged packs stream differently from split ones")
    st = {}
    for mode in (False, True):
        mgr = manager("cuda", byte_budget=budget, async_prefill=mode)
        streams, _ = script(mgr, greedy=False)
        st[mode] = (streams, store_state(mgr.store), mgr)
    a, s = st[True], st[False]
    payload = all(torch.equal(x, y) for sid, seg in a[2].store._segs.items()
                  for x, y in zip(tree_leaves(seg.caches),
                                  tree_leaves(s[2].store._segs[sid].caches)))
    print(f"  async prefill ({a[2].sched.tickets_launched} tickets, "
          f"{a[2].sched.overlap_steps} decode rounds overlapped builds) vs sync, sampled: "
          f"identical streams {a[0] == s[0]}, store {a[1] == s[1]}, payloads {payload}")
    check(a[0] == s[0] and a[1] == s[1] and payload,
          "reduced sessions: async prefill differs from sync in tokens or store")


def context_leaves(caches) -> list:
    """The ck/cv leaves of a cache tree, in layer order."""
    return [x for seg in caches for layer in seg.values()
            for name, x in layer.items() if name in ("ck", "cv")]


def reduced_context_isolation(dev, cfg) -> None:
    """Two sessions on the card over the same tokens with other context
    features: other document ids, no shared segment, no reuse across them,
    and each document's stored ck/cv its own context's."""
    from repro_torch.models.lm import LM
    from repro_torch.serve.session import SessionManager

    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 256).astype(np.int32)
    mgr = SessionManager(model, params, chunk_tokens=64)
    sids = [mgr.add_session(doc, extras=context_features(cfg, seed)) for seed in (0, 1)]
    plans = []
    for sid in sids:
        plans.append(mgr.submit(sid, 200, 4))
        mgr.run()
    keys = [mgr.sessions[sid].doc_id for sid in sids]
    segs = [{i for i, _ in mgr.store.index(k).items()} for k in keys]
    ck = [context_leaves(mgr.store._segs[min(ids)].caches) for ids in segs]
    same_ck = all(torch.equal(a, b) for a, b in zip(*ck))
    print(f"  same tokens, other context: document ids {keys}, segments {len(segs[0])} and "
          f"{len(segs[1])}, shared {len(segs[0] & segs[1])}, second request reused "
          f"{len(plans[1].models_used)}, cross-session hits {mgr.store.cross_session_hits}, "
          f"stored ck/cv equal: {same_ck}")
    check(keys[0] != keys[1] and segs[0] and segs[1] and not segs[0] & segs[1]
          and not plans[1].models_used and mgr.store.cross_session_hits == 0
          and not same_ck,
          "sessions with other context features shared a document or a segment")


def deferred_build_waits_for_nothing(dev) -> None:
    """``PrefixCacheBuilder.dispatch_prefix``, cold and over stored
    segments, under ``torch.cuda.set_sync_debug_mode``: the dispatch of a
    build must not wait on the device (no synchronising call)."""
    import warnings

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import LM
    from repro_torch.serve.session import SessionManager

    cfg = reduced(get_config("deepseek-67b"))
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    doc = np.random.default_rng(3).integers(0, cfg.vocab_size, 512).astype(np.int32)
    mgr = SessionManager(model, params, chunk_tokens=64)
    sid = mgr.add_session(doc)
    mgr.submit(sid, 300, 2)
    mgr.run()                    # stored segments to reuse; kernels loaded
    b, doc_id = mgr.builder, mgr.sessions[sid].doc_id
    torch.cuda.synchronize(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            cold = b.dispatch_prefix(doc, 290, doc_id="cold", capacity=300)
            warm = b.dispatch_prefix(doc, 450, doc_id=doc_id, capacity=460)
            dispatch = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's warnings name each synchronising call; its one-time notice
    # that the mode is a prototype is not one of them
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    t0 = time.perf_counter()
    torch.cuda.synchronize(dev)
    wait = time.perf_counter() - t0
    for built in (cold, warm):
        b.finalize_build(built[3])
    print(f"  dispatched builds (cold 290, warm 450 over {len(warm[2].models_used)} stored "
          f"segments): dispatch {dispatch * 1e3:.1f} ms, then {wait * 1e3:.1f} ms until the "
          f"card finished; synchronising calls in the dispatch: {len(syncs)} {syncs}")
    check(not syncs, f"the build's dispatch synchronised: {syncs}")
    check(warm[2].models_used and b.store._pins == {}, "dispatched builds left pins")


def balanced_docs(rng, vocab: int, doc_len: int, n_docs: int, n_shards: int) -> list:
    """``n_docs`` random documents, ``n_docs / n_shards`` homed on each shard
    of an ``n_shards`` ring (rejection-sampled by content key)."""
    from repro_torch.serve.session import doc_key
    from repro_torch.serve.shard_store import HashRing

    ring = HashRing(n_shards)
    quota = {s: n_docs // n_shards for s in range(n_shards)}
    docs = []
    while len(docs) < n_docs:
        doc = rng.integers(0, vocab, doc_len).astype(np.int32)
        home = ring.place(doc_key(doc))
        if quota.get(home, 0) > 0:
            quota[home] -= 1
            docs.append(doc)
    return docs


def sharded_replay(mgr, docs, *, rounds: int, n_new: int, seed0: int = 0) -> tuple:
    """``rounds`` rounds of one full-prefix greedy request per document,
    admitted together through ``submit_many``; returns (streams, plans with
    segment ids)."""
    sids = [mgr.add_session(d) for d in docs]
    streams, plans = [], []
    for r in range(rounds):
        for plan in mgr.submit_many([(sid, len(docs[i]), n_new, seed0 + r * 100 + i)
                                     for i, sid in enumerate(sids)]):
            plans.append([(s.rng.lo, s.rng.hi, s.model_id) for s in plan.steps])
        toks = mgr.run()
        streams.append(tuple(tuple(toks[sid]) for sid in sids))
    return streams, plans


def reduced_sharded_sessions(dev, cfg) -> None:
    """``SessionManager`` over a 2-shard ``ShardedSegmentStore`` on a
    reduced fp32 config, int8 wire (every fetched segment dequantized by
    ``quant_kv`` on the card), ``scripts/sharded_smoke.py``'s traffic: four
    160-token documents two per shard, chunk 32, three rounds under a
    per-shard budget of half the unbounded store's bytes, then a 1e6x
    straggler on shard 1 and two more rounds.  The card must give the
    CPU's streams, plans, segment ids and ``shard_report()``, and the
    single-shard unbounded streams."""
    from repro_torch.core.cost import serve_cost_model
    from repro_torch.kernels.quant_kv import kernel as qk
    from repro_torch.models.common import tree_map_with_path
    from repro_torch.models.lm import LM
    from repro_torch.serve.session import SessionManager
    from repro_torch.serve.shard_store import ShardedSegmentStore

    cpu_model = LM(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    runs = {"cpu": (cpu_model, cpu_params),
            "cuda": (LM(cfg, device=dev),
                     tree_map_with_path(lambda _, x: x.to(dev), cpu_params))}
    docs = balanced_docs(np.random.default_rng(11), cfg.vocab_size, 160, 4, 2)
    kw = dict(chunk_tokens=32, decode_bucket=32, decode_materialize=False)
    out = {}
    for name, (m, p) in runs.items():
        probe = SessionManager(m, p, **kw)
        ref, _ = sharded_replay(probe, docs, rounds=3, n_new=2)
        budget = max(int(probe.store.nbytes() * 0.5), 1)
        store = ShardedSegmentStore(2, byte_budget=budget, cost_model=serve_cost_model(),
                                    seq_bucket=32, wire_precision="int8", device=m.device)
        mgr = SessionManager(m, p, store=store, **kw)
        launches = qk.KERNEL.launches
        got, plans = sharded_replay(mgr, docs, rounds=3, n_new=2)
        store.hedge_deadline_s = 0.05
        store.transport.slowdown[1] = 1e6
        got2, plans2 = sharded_replay(mgr, docs, rounds=2, n_new=2, seed0=300)
        ref2, _ = sharded_replay(probe, docs, rounds=2, n_new=2, seed0=300)
        out[name] = dict(streams=(got, got2), single=(ref, ref2), plans=plans + plans2,
                         segs=[sorted(s._segs) for s in store._shards()],
                         report=store.shard_report(), dequants=mgr.builder.dequants,
                         launches=qk.KERNEL.launches - launches,
                         fetched=mgr.builder.fetched_segments)
    c, h = out["cuda"], out["cpu"]
    rep = c["report"]
    print(f"  sharded sessions (2 shards, budget per shard, int8 wire): "
          f"{rep['remote_fetches']} segments fetched ({rep['remote_fetch_wire_bytes']} B "
          f"wire) over {rep['remote_transfers']} transfers, {rep['fetched_hits']} fetched "
          f"hits, {rep['coalesce_violations']} coalesce violations; hedged "
          f"{rep['hedged_fetches']} ({rep['hedge_rebuild_wins']} rebuild wins); "
          f"{c['fetched']} reuse steps from fetches, {c['dequants']} dequants, quant_kv "
          f"launches {c['launches']}")
    same = {k: c[k] == h[k] for k in ("streams", "plans", "segs", "report")}
    print(f"  card == CPU: {same}; streams == single-shard unbounded: "
          f"{c['streams'] == c['single']}")
    check(all(same.values()), f"reduced sharded sessions: card and CPU disagree: {same}")
    check(c["streams"] == c["single"],
          "reduced sharded sessions: the 2-shard streams differ from the single-shard ones")
    check(rep["remote_fetches"] > 0 and rep["fetched_hits"] > 0
          and rep["coalesce_violations"] == 0 and rep["max_transfers_per_shard_tick"] <= 1,
          f"reduced sharded sessions: no coalesced cross-shard hits: {rep}")
    check(rep["hedged_fetches"] > 0 and rep["hedge_rebuild_wins"] > 0,
          f"reduced sharded sessions: the straggler was never hedged: {rep}")
    check(c["launches"] == c["dequants"] > 0,
          f"reduced sharded sessions: quant_kv launches {c['launches']} != dequants "
          f"{c['dequants']}")


def reduced_grouped_moe(dev, cfg) -> None:
    """A reduced MoE config with ``moe_groups=2`` (each row's tokens routed
    in two groups): a two-row prefill and four two-row greedy decode steps,
    the card against the CPU; logits within ``REDUCED_FP32_LOGIT_ATOL``,
    greedy tokens equal."""
    from repro_torch.models.common import tree_map_with_path
    from repro_torch.models.lm import LM
    from repro_torch.serve.kv_cache import pad_cache_to

    cfg = dataclasses.replace(cfg, moe_groups=2)
    cpu_model = LM(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    runs = {"cpu": (cpu_model, cpu_params),
            "cuda": (LM(cfg, device=dev),
                     tree_map_with_path(lambda _, x: x.to(dev), cpu_params))}
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    logits, streams = {}, {}
    with torch.no_grad():
        for name, (m, p) in runs.items():
            lg, caches = m.prefill(p, {"tokens": torch.from_numpy(toks).to(m.device)})
            caches = pad_cache_to(caches, 64)
            seen, stream = [lg.float().cpu()], []
            nxt = torch.argmax(lg, -1)
            for i in range(4):
                stream.append(nxt.tolist())
                pos = torch.full((2,), 40 + i, dtype=torch.int32, device=m.device)
                lg, caches = m.decode_step(p, caches, nxt[:, None], pos)
                lg = lg.reshape(2, -1)
                seen.append(lg.float().cpu())
                nxt = torch.argmax(lg, -1)
            stream.append(nxt.tolist())
            logits[name], streams[name] = torch.cat(seen), stream
    d = float((logits["cuda"] - logits["cpu"]).abs().max())
    print(f"  moe_groups=2, two rows: greedy tokens card {streams['cuda']} cpu "
          f"{streams['cpu']}; logits max |d| {d:.3g} (limit {REDUCED_FP32_LOGIT_ATOL})")
    check(streams["cuda"] == streams["cpu"], "grouped MoE: card and CPU tokens differ")
    check(d <= REDUCED_FP32_LOGIT_ATOL, f"grouped MoE: card and CPU logits differ by {d}")


# ---------------------------------------------------------------------------
# phase 3: reduced training, card vs CPU
# ---------------------------------------------------------------------------

#: phase 3's training runs: 3 steps on batches of 4 x 64 from ``lm_pipeline``
TRAIN_REDUCED = dict(steps=3, batch=4, seq=64, lr=1e-3)
#: the card's loss per step against the CPU's (fp32, TF32 off: cuBLAS and
#: the CPU sum in other orders; on the CPU the port's loss stays within
#: 1e-6 of repro's)
TRAIN_LOSS_ATOL = 1e-4
#: the card's parameters after the last step against the CPU's, per leaf:
#: ‖card − CPU‖ over ‖CPU − initial‖, the size of the update.  An AdamW or
#: Adafactor step normalises each gradient, so an element whose gradient
#: is within rounding of 0 moves by another fraction of lr on the card
#: (the CPU against repro after one step: 4.7e-4)
TRAIN_PARAM_NORMWISE = 1e-2


def kernel_launches() -> tuple[int, int]:
    """The extend and decode kernels' launch counters."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.extend_attention import kernel as ek

    return ek.KERNEL.launches, dk.KERNEL.launches


def train_batches(cfg, batch: int, seq: int, steps: int, dev) -> list:
    """``steps`` batches of ``lm_pipeline`` (2 shards, seed 0) on ``dev``,
    with a cross stack's stub context (0.1 N(0, 1) from the seed, one
    feature set per row)."""
    from repro_torch.data.pipeline import lm_pipeline

    pipe = lm_pipeline(cfg.vocab_size, batch=batch, seq=seq, n_shards=2, seed=0)
    try:
        host = [next(pipe) for _ in range(steps)]
    finally:
        pipe.close()
    ctx = {k: np.repeat(v, batch, axis=0) for k, v in context_features(cfg).items()}
    return [{k: torch.from_numpy(v).to(dev) for k, v in {**b, **ctx}.items()}
            for b in host]


def reduced_training(dev, arch: str, opt_name: str = "") -> None:
    """``TRAIN_REDUCED``'s steps of ``make_train_step`` on reduced ``arch``
    (fp32) on the card and on the CPU from the same parameters: loss per
    step within ``TRAIN_LOSS_ATOL``, parameters after the last step within
    ``TRAIN_PARAM_NORMWISE``, and no extend or decode kernel launched."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.common import tree_items_sorted, tree_map_with_path
    from repro_torch.models.lm import LM
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import make_optimizer, warmup_cosine

    cfg = reduced(get_config(arch))
    opt_name = opt_name or cfg.optimizer
    t = TRAIN_REDUCED
    init = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    runs = {}
    for device in ("cpu", dev):
        model = LM(cfg, device=device)
        params = tree_map_with_path(lambda _, x: x.clone().to(device), init)
        opt = make_optimizer(opt_name)
        state = opt.init(params)
        step, _ = make_train_step(model, opt, microbatches=1,
                                  schedule=warmup_cosine(t["lr"], 1, t["steps"]))
        before = kernel_launches()
        losses = []
        for i, batch in enumerate(train_batches(cfg, t["batch"], t["seq"], t["steps"], device)):
            params, state, m = step(params, state, batch, i)
            losses.append(float(m["loss"]))
        check(kernel_launches() == before,
              f"{arch} training launched an attention kernel: {before} -> {kernel_launches()}")
        runs[str(device)] = (losses, params)
    (cpu_losses, cpu_params), (gpu_losses, gpu_params) = runs["cpu"], runs[str(dev)]
    loss_err = max(abs(a - b) for a, b in zip(cpu_losses, gpu_losses))
    worst, where = 0.0, ""
    for (path, c), g, i in zip(tree_items_sorted(cpu_params),
                               [x for _, x in tree_items_sorted(gpu_params)],
                               [x for _, x in tree_items_sorted(init)]):
        moved = float(torch.linalg.vector_norm((c - i).double()))
        err = float(torch.linalg.vector_norm((g.cpu() - c).double())) / max(moved, 1e-30)
        if err > worst:
            worst, where = err, "/".join(map(str, path))
    print(f"    training {arch} ({opt_name}, {t['steps']} steps of {t['batch']} x {t['seq']}): "
          f"loss card {[round(x, 6) for x in gpu_losses]} vs CPU "
          f"{[round(x, 6) for x in cpu_losses]}, max |diff| {loss_err:.2e} (atol "
          f"{TRAIN_LOSS_ATOL:g}); parameters after step {t['steps']}: worst leaf "
          f"{worst:.2e} of its update ({where}; limit {TRAIN_PARAM_NORMWISE:g}); "
          f"no extend or decode launch")
    check(all(np.isfinite(cpu_losses + gpu_losses)), f"{arch}: non-finite training loss")
    check(loss_err <= TRAIN_LOSS_ATOL, f"{arch}: training loss card vs CPU {loss_err:.3e}")
    check(worst <= TRAIN_PARAM_NORMWISE,
          f"{arch}: parameters after training, card vs CPU: {worst:.3e} at {where}")


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
    ref = {"tokens": [r[1] for r in results], "logits": logits,
           "store_bytes": eng.store.nbytes()}
    return counts, eng, ref


#: profiler names of the port's bf16 attention kernels
PORT_KERNELS = tuple(f"void (anonymous namespace)::{name}" for name in
                     ("extend_mma_kernel", "split_kernel", "combine_kernel"))


def profile_steps(label: str, steps: int, fn, dev) -> dict:
    """torch.profiler over ``steps`` calls of ``fn``: wall and device busy
    time per call, the top kernels and the share of the port's attention
    kernels.  Returns those three per call, in ms (empty where the profiler
    saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
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
        return {}
    print(f"  {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({busy / wall:.0%}), idle {max(wall - busy, 0.0):.2f} ms")
    ranked = sorted(rows, key=lambda r: -r[1])
    # the top kernels, then the port's own kernels further down
    for i, (key, ms, n) in enumerate(ranked):
        if i < 6 or "(anonymous namespace)::" in key:
            print(f"    {ms:8.3f} ms  {ms / busy:5.1%}  x{n:<4d} {key[:90]}")
    ours = sum(ms for key, ms, _ in rows if key.startswith(PORT_KERNELS))
    print(f"    the port's attention kernels: {ours:.3f} ms of {busy:.2f} ms busy "
          f"({ours / busy:.1%}); the rest {busy - ours:.2f} ms")
    return {"wall": wall, "busy": busy, "ours": ours}


def where_time_goes(eng, dev) -> None:
    """torch.profiler over four full-width decode steps at position 3072 and
    one 128-token extend at 2048 (after the main path's counters are read):
    device busy time per step and the kernels that take it."""
    model, params, doc = eng.model, eng.params, eng.doc
    logits, caches, _ = eng.builder.prefix_with_logits(
        doc, 3072, doc_id=eng.doc_id, capacity=3088)
    tok = torch.argmax(logits, dim=-1)[:, None]
    pos = torch.tensor([3072], dtype=torch.int32, device=dev)
    ext, _ = eng.builder.build_prefix(doc, 2048, doc_id=eng.doc_id,
                                      materialize=False, capacity=2176)
    chunk = torch.as_tensor(doc[None, 2048:2176].astype(np.int64), device=dev)
    start = torch.tensor(2048, dtype=torch.int32, device=dev)
    profile_steps("decode step", 4,
                  lambda: model.decode_step(params, caches, tok, pos), dev)
    profile_steps("extend 128 tokens", 1,
                  lambda: model.prefill_extend(params, ext, chunk, start), dev)


# ---------------------------------------------------------------------------
# phase 10: the MLA main path at full width
# ---------------------------------------------------------------------------

def serve_full_width(cfg, dev, cost_model=None, *, doc_len: int = 4096,
                     prefixes=(2048, 4096, 3072, 2048), chunk: int = 128,
                     extras=None) -> tuple:
    """``cfg`` at its published widths (depth already cut), bf16, through
    ``ServeEngine`` (its planner priced by ``cost_model``, by default the
    serving calibration; a cross stack's context ``extras``): by default
    phase 4's document and requests (prefixes 2048, 4096, 3072 and a replay
    of 2048, 16 new tokens each, chunk 128), with the extend and decode
    kernels' launches and the model's extend and decode calls counted.
    Requests 2 and 3 must reuse stored segments, the replay must give
    identical tokens and the logits must be finite.  Returns (engine,
    counts, attention layers, {prefix: tokens} of the first three
    requests)."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.extend_attention import kernel as ek
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeEngine

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    kinds = [f"{spec.mixer}/{spec.mlp} x{n}" for period, n in model.segments
             for spec in period]
    print(f"  init: {n_params / 1e9:.2f} B params on the card in "
          f"{time.perf_counter() - t0:.1f} s; layers {kinds}")
    layers = sum(n for period, n in model.segments for spec in period
                 if spec.mixer in ("attn", "mla"))
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, doc_len).astype(np.int32)
    eng = ServeEngine(model, params, doc, extras=extras, chunk_tokens=chunk, device=dev,
                      cost_model=cost_model)
    calls = {"extend": 0, "decode": 0}

    def counted(name, fn):                  # prefill_extend_many extends per chunk
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    model.prefill_extend = counted("extend", model.prefill_extend)
    model.decode_step = counted("decode", model.decode_step)
    ek.KERNEL.launches = 0
    dk.KERNEL.launches = 0
    results = []
    for prefix in prefixes:
        s0 = dataclasses.replace(eng.stats)
        toks, plan = eng.generate(prefix, 16)
        st = eng.stats
        pre = st.prefill_s - s0.prefill_s
        dec = st.decode_s - s0.decode_s
        reused = st.tokens_reused - s0.tokens_reused
        computed = st.tokens_computed - s0.tokens_computed
        print(f"  request prefix {prefix}: prefill {pre:.3f} s "
              f"({reused} tokens reused, {len(plan.models_used)} segments; {computed} "
              f"computed, {computed / pre:.0f} tok/s), decode {16 / dec:.1f} tok/s, "
              f"tokens {toks[:8]}")
        check(all(0 <= t < cfg.vocab_size for t in toks), "token out of range")
        results.append((prefix, toks, plan))
    logits, _, _ = eng.builder.prefix_with_logits(doc, prefixes[2], doc_id=eng.doc_id,
                                                  extras=eng.context,
                                                  capacity=prefixes[2] + 16)
    torch.cuda.synchronize(dev)
    counts = {"extend_calls": calls["extend"], "decode_calls": calls["decode"],
              "extend": ek.KERNEL.launches, "decode": dk.KERNEL.launches}
    del model.prefill_extend, model.decode_step       # the class's methods again
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          f"full-width {cfg.name} logits not finite or mis-shaped: {tuple(logits.shape)}")
    check(all(len(r[2].models_used) > 0 for r in results[1:3]),
          f"{cfg.name}: requests 2 and 3 did not reuse stored segments")
    check(results[3][1] == results[0][1],
          f"{cfg.name}: the replayed request from stored segments changed its tokens")
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"  replay of prefix {prefixes[3]} from the store: identical tokens: True")
    print(f"  store: {len(eng.store)} segments, {eng.store.nbytes() / 2**20:.1f} MiB; "
          f"max memory allocated {mem / 2**30:.2f} GiB")
    return eng, counts, layers, {r[0]: r[1] for r in results[:3]}


def mla_main_path(dev) -> dict:
    """``deepseek-v2-236b`` at full width, depth cut to ``MLA_LAYERS``, bf16,
    through ``ServeEngine`` (:func:`serve_full_width`); returns the extend
    kernel's launches (the MLA form's main path)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mla_decode import kernel as mk

    base = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(base, n_layers=MLA_LAYERS)
    m, moe = cfg.mla, cfg.moe
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}, MLA q_lora "
          f"{m.q_lora_rank} kv_lora {m.kv_lora_rank} q·k {m.qk_nope_head_dim}+"
          f"{m.qk_rope_head_dim} v {m.v_head_dim}, MoE {moe.n_experts} experts top-"
          f"{moe.top_k} d_ff {moe.d_ff_expert} + {moe.n_shared} shared, dense d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}; n_layers cut "
          f"{base.n_layers} -> {cfg.n_layers} to fit one 80 GB card")
    mk.KERNEL.launches = 0
    eng, counts, layers, _ = serve_full_width(cfg, dev)
    counts["mla_decode"] = mk.KERNEL.launches
    for name, kind in (("extend", "extend"), ("mla_decode", "decode")):
        launches, calls = counts[name], counts[f"{kind}_calls"]
        print(f"  {name} launches {launches} = {layers} MLA layers x {calls} "
              f"{kind} calls: {launches == layers * calls}")
        check(calls > 0 and launches == layers * calls,
              f"MLA {name} launches {launches} != {layers} x {calls} {kind} calls")
    mla_where_time_goes(eng, dev)
    return {"extend_attention_mla": counts["extend"], "mla_decode": counts["mla_decode"]}


def nemotron_main_path(dev) -> dict:
    """``nemotron-4-340b`` at full width, depth cut to ``NEMOTRON_LAYERS``,
    bf16, through ``ServeEngine`` (:func:`serve_full_width`): the GQA stack
    at head dim 192, G 12, with squared-ReLU MLPs.  Each extend call must
    launch the extend kernel once a layer and each decode call the decode
    kernel once a layer; then phase 5's profile of a decode step and a
    128-token extend.  Returns the two kernels' launches (the hd-192 forms'
    main path)."""
    from repro_torch.configs import get_config

    base = get_config("nemotron-4-340b")
    cfg = dataclasses.replace(base, n_layers=NEMOTRON_LAYERS)
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} KV (G {cfg.n_heads // cfg.n_kv_heads}), head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff} {cfg.activation}, vocab {cfg.vocab_size} "
          f"(untied head), {cfg.param_dtype}; n_layers cut {base.n_layers} -> "
          f"{cfg.n_layers} to fit one 80 GB card")
    eng, counts, layers, _ = serve_full_width(cfg, dev)
    for name in ("extend", "decode"):
        launches, calls = counts[name], counts[f"{name}_calls"]
        print(f"  {name} launches {launches} = {layers} layers x {calls} {name} calls: "
              f"{launches == layers * calls}")
        check(calls > 0 and launches == layers * calls,
              f"nemotron {name} launches {launches} != {layers} x {calls} {name} calls")
    where_time_goes(eng, dev)
    return {"extend_attention_hd192": counts["extend"],
            "decode_attention_hd192": counts["decode"]}


def mla_where_time_goes(eng, dev) -> None:
    """torch.profiler over one decode step at position 3072 and one
    128-token extend at 2048, as phase 5; then one MoE layer alone on the
    same number of tokens, so the step splits into the attention kernel,
    the MoE layers and the rest, beside the host's idle time."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import _layer_params, _moe_params

    model, params, doc, cfg = eng.model, eng.params, eng.doc, eng.model.cfg
    logits, caches, _ = eng.builder.prefix_with_logits(
        doc, 3072, doc_id=eng.doc_id, capacity=3088)
    tok = torch.argmax(logits, dim=-1)[:, None]
    pos = torch.tensor([3072], dtype=torch.int32, device=dev)
    ext, _ = eng.builder.build_prefix(doc, 2048, doc_id=eng.doc_id,
                                      materialize=False, capacity=2176)
    chunk = torch.as_tensor(doc[None, 2048:2176].astype(np.int64), device=dev)
    start = torch.tensor(2048, dtype=torch.int32, device=dev)
    steps = {
        "decode": profile_steps("MLA decode step", 4,
                                lambda: model.decode_step(params, caches, tok, pos), dev),
        "extend": profile_steps("MLA extend 128 tokens", 1,
                                lambda: model.prefill_extend(params, ext, chunk, start), dev)}
    seg = next(s for s, (period, _) in enumerate(model.segments) if period[0].mlp == "moe")
    n_moe = model.segments[seg][1]
    p = _moe_params(_layer_params(params["segments"][seg]["p0"], 0)["mlp"])
    for name, n in (("decode", 1), ("extend", 128)):
        hn = randn((1, n, cfg.d_model), torch.bfloat16, dev, 5)
        layer = lambda: moe_mod.moe_ffn(p, cfg.moe, hn, activation=cfg.activation)  # noqa: E731
        moe_ms, kernels = device_profile(layer, "", launches=5)
        # cuBLAS's GEMM kernels on Hopper are named nvjet_* (or *gemm*)
        gemm_ms = sum(device_profile(layer, name, launches=5)[0]
                      for name in ("nvjet", "gemm"))
        st = steps[name]
        if not st:
            print(f"  MLA {name}: one MoE layer on {n} tokens {moe_ms:.3f} ms of device time "
                  f"({gemm_ms:.3f} ms in GEMM kernels); step split not measured")
            continue
        moe_all = moe_ms * n_moe
        print(f"  MLA {name} step split: wall {st['wall']:.2f} ms = device busy "
              f"{st['busy']:.2f} ms + host idle {max(st['wall'] - st['busy'], 0.0):.2f} ms; "
              f"busy = extend kernel {st['ours']:.3f} ms + {n_moe} MoE layers "
              f"{moe_all:.2f} ms (one layer alone on {n} tokens: {moe_ms:.3f} ms, "
              f"{gemm_ms:.3f} ms of it in GEMM kernels, {kernels:g} device activities) "
              f"+ the rest {st['busy'] - st['ours'] - moe_all:.2f} ms")


# ---------------------------------------------------------------------------
# phase 13: SSD serving at full width
# ---------------------------------------------------------------------------

def ssd_state_bytes(cfg) -> int:
    """One stored segment of an SSD stack, whatever its length: each SSD
    layer's conv state (W-1, conv channels) and ssm state (h, p, n), in the
    dtype the mixer runs in (fp32 parameters promote bf16 compute)."""
    from repro_torch.models.lm import DTYPES

    s, d = cfg.ssm, cfg.d_model
    per_layer = ((s.conv_width - 1) * (s.d_inner(d) + 2 * s.n_groups * s.d_state)
                 + s.n_heads(d) * s.head_dim * s.d_state)
    dtype = torch.promote_types(DTYPES[cfg.param_dtype], DTYPES[cfg.compute_dtype])
    return cfg.n_layers * per_layer * torch.finfo(dtype).bits // 8


def mamba_main_path(dev) -> None:
    """``mamba2-130m`` at its published widths and full depth (24 SSD layers,
    fp32 parameters, bf16 compute) through ``ServeEngine``
    (:func:`serve_full_width`, phase 4's traffic).  No attention kernel may
    launch; a cold engine's request for prefix 3072 must give the warm
    engine's greedy tokens; every stored segment holds the state at its end,
    the same bytes whatever its length.

    The planner prices a stored segment's load as a device copy (each byte
    read and written once at the HBM rate): the segments are device
    residents.  The serving calibration's 1e-9 s a byte (a host scan)
    prices a 19.4 MB state segment above the prefill of its 128 tokens, so
    nothing would be reused."""
    from repro_torch.configs import get_config
    from repro_torch.core.cost import serve_cost_model
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("mamba2-130m")
    s, d = cfg.ssm, cfg.d_model
    print(f"  config {cfg.name}: d_model {d}, d_inner {s.d_inner(d)}, {s.n_heads(d)} heads "
          f"of {s.head_dim}, d_state {s.d_state}, conv {s.conv_width}, scan chunk "
          f"{s.chunk}, no MLP, vocab {cfg.vocab_size} (tied), params {cfg.param_dtype}, "
          f"compute {cfg.compute_dtype}; {cfg.n_layers} layers (full depth)")
    want = ssd_state_bytes(cfg)
    cost = serve_cost_model(load_s_per_byte=2 / HBM_BYTES_PER_S)
    default = serve_cost_model()
    print(f"  a 128-token segment ({want} B): prefill priced {default.F(128) * 1e3:.2f} ms; "
          f"its load priced {default.C(want) * 1e3:.2f} ms by the serving calibration, "
          f"{cost.C(want) * 1e3:.4f} ms as a device copy (this phase's planner)")
    eng, counts, layers, warm = serve_full_width(cfg, dev, cost_model=cost)
    print(f"  attention layers {layers}; attention kernel launches: extend "
          f"{counts['extend']}, decode {counts['decode']} ({counts['extend_calls']} extend "
          f"calls, {counts['decode_calls']} decode calls)")
    check(layers == 0 and counts["extend"] == counts["decode"] == 0
          and counts["extend_calls"] > 0 and counts["decode_calls"] > 0,
          f"mamba2-130m launched an attention kernel or never ran: {counts}")
    sizes = sorted({seg.nbytes for seg in eng.store._segs.values()})
    print(f"  stored segment bytes {sizes} over {len(eng.store)} segments of 1 to 128 "
          f"tokens (expected {want}: {cfg.n_layers} layers x (conv + ssm state))")
    check(sizes == [want], f"mamba2-130m segment sizes {sizes} != {want}")
    # warm (the store of phase 4's requests) against a cold engine
    doc = eng.doc
    bounds = lambda plan: [st.rng.hi for st in plan.steps]  # noqa: E731
    cold = ServeEngine(eng.model, eng.params, doc, chunk_tokens=128, device=dev,
                       cost_model=cost)
    cold_plan = cold.plan_prefix(3071)
    toks, _ = cold.generate(3072, 16)
    warm_plan = eng.plan_prefix(3071)
    fresh = ServeEngine(eng.model, eng.params, doc, chunk_tokens=128, device=dev,
                        cost_model=cost)
    lg = {name: e.builder.prefix_with_logits(doc, 3072, doc_id=e.doc_id, capacity=3088)[0]
          for name, e in (("cold", fresh), ("warm", eng))}
    dl = float((lg["warm"].float() - lg["cold"].float()).abs().max())
    print(f"  prefix 3072: warm plan {len(warm_plan.models_used)} stored segments ending "
          f"at {bounds(warm_plan)[-10:]}, cold plan ends {bounds(cold_plan)}; first logits "
          f"warm vs cold max |d| {dl:.4g}")
    print(f"  prefix 3072 tokens: warm {warm[3072]} cold {toks}: identical "
          f"{toks == warm[3072]}")
    check(toks == warm[3072], "mamba2-130m: a warm request for prefix 3072 gave other "
                              "greedy tokens than a cold engine's")


def jamba_main_path(dev) -> dict:
    """``jamba-v0.1-52b`` at full width, depth cut to ``JAMBA_LAYERS`` (one
    period), bf16, through ``ServeEngine`` (:func:`serve_full_width`): the
    extend and decode kernels at G 4, hd 128, once per call (one attention
    layer); then a decode step and a 128-token extend split into the SSD
    mixers, the MoE and dense feed-forward layers and attention.  Returns
    the two kernels' launches (the G 4 forms' main path)."""
    from repro_torch.configs import get_config

    base = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(base, n_layers=JAMBA_LAYERS)
    s, d, moe = cfg.ssm, cfg.d_model, cfg.moe
    print(f"  config {cfg.name}: d_model {d}, heads {cfg.n_heads}/{cfg.n_kv_heads} KV "
          f"(G {cfg.n_heads // cfg.n_kv_heads}), head_dim {cfg.head_dim}; SSD d_inner "
          f"{s.d_inner(d)}, {s.n_heads(d)} heads of {s.head_dim}, d_state {s.d_state}; "
          f"d_ff {cfg.d_ff}, MoE {moe.n_experts} experts top-{moe.top_k} every "
          f"{moe.every}; vocab {cfg.vocab_size}, {cfg.param_dtype}; n_layers cut "
          f"{base.n_layers} -> {cfg.n_layers} (one period) to fit one 80 GB card")
    eng, counts, layers, _ = serve_full_width(cfg, dev)
    for name in ("extend", "decode"):
        launches, calls = counts[name], counts[f"{name}_calls"]
        print(f"  {name} launches {launches} = {layers} attention layer x {calls} {name} "
              f"calls: {launches == layers * calls}")
        check(layers == 1 and calls > 0 and launches == layers * calls,
              f"jamba {name} launches {launches} != {layers} x {calls} {name} calls")
    hybrid_where_time_goes(eng, dev)
    return {"extend_attention_g4": counts["extend"],
            "decode_attention_g4": counts["decode"]}


def hybrid_where_time_goes(eng, dev) -> None:
    """torch.profiler over one decode step at position 3072 and one 128-token
    extend at 2048, as phase 5; then one layer of each kind alone on the same
    number of tokens (an SSD mixer from its state, an MoE and a dense
    feed-forward layer), so the step's device time splits into the
    attention kernel, the SSD mixers, MoE, dense and the rest."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssd as ssd_mod
    from repro_torch.models.lm import _layer_params, _moe_params, _ssd_params

    model, params, doc, cfg = eng.model, eng.params, eng.doc, eng.model.cfg
    logits, caches, _ = eng.builder.prefix_with_logits(
        doc, 3072, doc_id=eng.doc_id, capacity=3088)
    tok = torch.argmax(logits, dim=-1)[:, None]
    pos = torch.tensor([3072], dtype=torch.int32, device=dev)
    ext, _ = eng.builder.build_prefix(doc, 2048, doc_id=eng.doc_id,
                                      materialize=False, capacity=2176)
    chunk = torch.as_tensor(doc[None, 2048:2176].astype(np.int64), device=dev)
    start = torch.tensor(2048, dtype=torch.int32, device=dev)
    steps = {
        "decode": profile_steps("jamba decode step", 4,
                                lambda: model.decode_step(params, caches, tok, pos), dev),
        "extend": profile_steps("jamba extend 128 tokens", 1,
                                lambda: model.prefill_extend(params, ext, chunk, start), dev)}
    (period, _), = model.segments
    kinds = {"ssd": sum(sp.mixer == "ssd" for sp in period),
             "moe": sum(sp.mlp == "moe" for sp in period),
             "dense": sum(sp.mlp == "dense" for sp in period)}
    slot = {k: next(j for j, sp in enumerate(period) if k in (sp.mixer, sp.mlp))
            for k in kinds}
    lp = {k: _layer_params(params["segments"][0][f"p{j}"], 0) for k, j in slot.items()}
    state = tuple(caches[0][f"p{slot['ssd']}"][name][0].clone() for name in ("conv", "ssm"))
    for name, n in (("decode", 1), ("extend", 128)):
        h = randn((1, n, cfg.d_model), model.compute_dtype, dev, 5)
        if n == 1:
            mixer = lambda: ssd_mod.ssd_decode(  # noqa: E731
                _ssd_params(lp["ssd"]["mixer"]), cfg.ssm, cfg.d_model, h, state,
                norm_eps=cfg.norm_eps)
        else:
            mixer = lambda: ssd_mod.ssd_block(  # noqa: E731
                _ssd_params(lp["ssd"]["mixer"]), cfg.ssm, cfg.d_model, h,
                norm_eps=cfg.norm_eps, return_state=True, initial=state)
        alone = {
            "ssd": mixer,
            "moe": lambda: moe_mod.moe_ffn(_moe_params(lp["moe"]["mlp"]), cfg.moe, h,  # noqa: E731
                                           activation=cfg.activation),
            "dense": lambda: moe_mod.dense_ffn(lp["dense"]["mlp"], h, cfg.activation)}  # noqa: E731
        ms = {k: device_profile(fn, "", launches=5) for k, fn in alone.items()}
        st = steps[name]
        each = ", ".join(f"{k} {ms[k][0]:.3f} ms ({ms[k][1]:g} device activities)"
                         for k in kinds)
        if not st:
            print(f"  jamba {name}: one layer alone on {n} tokens: {each}; step split "
                  f"not measured")
            continue
        total = {k: ms[k][0] * kinds[k] for k in kinds}
        rest = st["busy"] - st["ours"] - sum(total.values())
        print(f"  jamba {name} step split: wall {st['wall']:.2f} ms = device busy "
              f"{st['busy']:.2f} ms + host idle {max(st['wall'] - st['busy'], 0.0):.2f} ms; "
              f"busy = attention kernel {st['ours']:.3f} ms + {kinds['ssd']} SSD mixers "
              f"{total['ssd']:.2f} ms + {kinds['moe']} MoE layers {total['moe']:.2f} ms + "
              f"{kinds['dense']} dense FFN layers {total['dense']:.2f} ms + the rest "
              f"(attention projections, norms, embedding, head) {rest:.2f} ms; one layer "
              f"alone on {n} tokens: {each}")


# ---------------------------------------------------------------------------
# phase 14: cross-attention serving at full width
# ---------------------------------------------------------------------------

#: phase 14 (a)'s traffic: one transcript of whisper's 448 target positions
#: (max_target_positions), chunk 64, requests for prefixes 192, 432 and 320
#: and a replay of 192
WHISPER_TRAFFIC = dict(doc_len=448, prefixes=(192, 432, 320, 192), chunk=64)
#: phase 4's traffic (phase 14 (b))
PHASE4_TRAFFIC = dict(doc_len=4096, prefixes=(2048, 4096, 3072, 2048), chunk=128)


def cross_main_path(dev, arch: str) -> dict:
    """``arch`` (``whisper-large-v3`` or ``llama-3.2-vision-11b``) at its
    published widths and full depth, bf16, through ``ServeEngine``
    (:func:`serve_full_width`) over a stub context of 0.1 N(0, 1) features
    from the seed: whisper on one 448-token transcript
    (``WHISPER_TRAFFIC``), llama-vision on phase 4's document and requests.
    The extend and decode kernels must launch once a layer per call, every
    stored segment must carry the context's K/V (ck/cv of every cross
    layer) beside its own, and for whisper a cold engine's request for 320
    must give the warm one's tokens (or part at a near-tie) and first
    logits within ``REDUCED_BF16_LOGIT_ULPS`` bf16 ulps.  The planner
    prices a segment's load as a device copy; the serving calibration's
    plan over the same store is printed.  Then the step profile.  Returns
    the two kernels' launches (whisper's are the hd 64 / G 1 forms' main
    path)."""
    from repro_torch.configs import get_config
    from repro_torch.core.cost import serve_cost_model
    from repro_torch.kernels.common import bf16_ulp
    from repro_torch.serve.engine import ServeEngine

    whisper = arch == "whisper-large-v3"
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    g = cfg.n_heads // cfg.n_kv_heads
    n_ctx = cfg.encoder_context or cfg.vision_context
    context = (f"encoder {cfg.encoder_layers} layers over {n_ctx} frames" if whisper
               else f"vision_proj over {n_ctx} patches, cross layer every "
                    f"{cfg.cross_attn_every}")
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} KV (G {g}), head_dim {cfg.head_dim}, d_ff {cfg.d_ff} "
          f"{cfg.activation}, vocab {cfg.vocab_size}, {context}; {cfg.n_layers} decoder "
          f"layers (full depth), params {cfg.param_dtype} (published config: "
          f"{get_config(arch).param_dtype}), compute {cfg.compute_dtype}")
    traffic = WHISPER_TRAFFIC if whisper else PHASE4_TRAFFIC
    chunk, prefixes = traffic["chunk"], traffic["prefixes"]
    ctx = context_features(cfg, seed=0)
    from repro_torch.models.lm import build_segments

    n_cross = sum(n for period, n in build_segments(cfg) for spec in period if spec.cross)
    ck_bytes = n_cross * 2 * n_ctx * cfg.n_kv_heads * cfg.head_dim * 2
    kv_bytes = cfg.n_layers * 2 * chunk * cfg.n_kv_heads * cfg.head_dim * 2
    cost = serve_cost_model(load_s_per_byte=2 / HBM_BYTES_PER_S)
    default = serve_cost_model()
    seg = ck_bytes + kv_bytes
    print(f"  a {chunk}-token segment: {kv_bytes} B of K/V + {ck_bytes} B of ck/cv "
          f"({n_cross} cross layers x 2 x {n_ctx} x {cfg.n_kv_heads} x {cfg.head_dim} x "
          f"2 B); prefill priced {default.F(chunk) * 1e3:.2f} ms; its load priced "
          f"{default.C(seg) * 1e3:.2f} ms by the serving calibration, "
          f"{cost.C(seg) * 1e3:.4f} ms as a device copy (this phase's planner)")
    eng, counts, layers, warm = serve_full_width(cfg, dev, cost, extras=ctx, **traffic)
    for name in ("extend", "decode"):
        launches, calls = counts[name], counts[f"{name}_calls"]
        print(f"  {name} launches {launches} = {layers} layers x {calls} {name} calls: "
              f"{launches == layers * calls}")
        check(layers == cfg.n_layers and calls > 0 and launches == layers * calls,
              f"{arch} {name} launches {launches} != {layers} x {calls} {name} calls")
    sizes = sorted({sum(x.numel() * x.element_size() for x in context_leaves(s.caches))
                    for s in eng.store._segs.values()})
    caps = sorted({s.capacity for s in eng.store._segs.values()})
    print(f"  stored segments: {len(eng.store)}, ck/cv bytes each {sizes} (expected "
          f"{ck_bytes}), K/V capacities {caps}")
    # whisper stores every segment at the chunk's capacity (chunk 64 = the
    # store's bucket); llama-vision's ragged ones may take a 64 bucket
    check(sizes == [ck_bytes] and (caps == [chunk] if whisper else max(caps) <= chunk),
          f"{arch}: a stored segment's ck/cv bytes {sizes} or capacity {caps} is off")
    priced = ServeEngine(eng.model, eng.params, eng.doc, extras=ctx, store=eng.store,
                         doc_id=eng.doc_id, cost_model=default, chunk_tokens=chunk,
                         device=dev)
    plan, plan_copy = priced.plan_prefix(prefixes[2] - 1), eng.plan_prefix(prefixes[2] - 1)
    print(f"  prefix {prefixes[2]} over the warm store: the serving calibration's plan "
          f"reuses {len(plan.models_used)} segments (cost {plan.cost * 1e3:.2f} ms), the "
          f"device-copy price's {len(plan_copy.models_used)} (cost "
          f"{plan_copy.cost * 1e3:.2f} ms)")
    del priced
    if whisper:
        # warm (the store of the requests above) against cold engines, the
        # first logits too: a random-weight whisper's greedy stream can
        # settle on one token (32 cross sublayers add a near-constant vector
        # to the residual), so equal tokens alone say little
        def cold_engine():
            return ServeEngine(eng.model, eng.params, eng.doc, extras=ctx,
                               chunk_tokens=chunk, device=dev, cost_model=cost)

        lg = {name: e.builder.prefix_with_logits(e.doc, prefixes[2], doc_id=e.doc_id,
                                                 extras=e.context,
                                                 capacity=prefixes[2] + 16)[0].float()
              for name, e in (("cold", cold_engine()), ("warm", eng))}
        dl = float((lg["warm"] - lg["cold"]).abs().max())
        gap, top = top2_gap(lg["cold"])
        ulp = float(bf16_ulp(torch.tensor(top)))
        print(f"  prefix {prefixes[2]}: first logits warm vs cold max |d| {dl:.4g} "
              f"({dl / ulp:.2f} bf16 ulps of the largest logit {top:.4g}; limit "
              f"{REDUCED_BF16_LOGIT_ULPS}); the cold run's top-2 gap {gap:.4g} "
              f"({gap / ulp:.2f} ulps)")
        check(dl <= REDUCED_BF16_LOGIT_ULPS * ulp,
              f"{arch}: warm and cold first logits at {prefixes[2]} differ by {dl}")
        cold = cold_engine()
        toks, _ = cold.generate(prefixes[2], 16)
        at = next((i for i, (x, y) in enumerate(zip(toks, warm[prefixes[2]])) if x != y),
                  None)
        ulps = 0.0
        if at is not None:
            gap, top = top2_gap(single_logits(cold, prefixes[2], toks, at))
            ulps = gap / float(bf16_ulp(torch.tensor(top)))
        print(f"  prefix {prefixes[2]} tokens: warm {warm[prefixes[2]]} cold {toks}: "
              + ("identical" if at is None else
                 f"part at token {at}, the cold run's top-2 gap there {ulps:.2f} bf16 "
                 f"ulps of its largest logit (limit {REDUCED_BF16_LOGIT_ULPS})"))
        check(ulps <= REDUCED_BF16_LOGIT_ULPS,
              f"{arch}: the warm request for {prefixes[2]} parted from a cold engine's "
              f"away from a near-tie ({ulps:.2f} ulps)")
        del cold
        torch.cuda.empty_cache()
    cross_where_time_goes(eng, dev, decode_at=prefixes[2], extend_at=prefixes[0],
                          n_ext=chunk)
    return {"extend_attention_hd64": counts["extend"],
            "decode_attention_hd64": counts["decode"]}


def cross_where_time_goes(eng, dev, *, decode_at: int, extend_at: int, n_ext: int) -> None:
    """torch.profiler over one decode step at ``decode_at`` and one
    ``n_ext``-token extend at ``extend_at``, as phase 5 (and, with an
    encoder, over the cold prefill of the first chunk); then one cross
    sublayer, one dense FFN and the encoder alone on the same number of
    tokens, so the step's device time splits into the attention kernel, the
    cross-attention sublayers, the encoder, the dense FFN and the rest."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import _layer_params

    model, params, doc, cfg = eng.model, eng.params, eng.doc, eng.model.cfg
    label = cfg.name
    logits, caches, _ = eng.builder.prefix_with_logits(
        doc, decode_at, doc_id=eng.doc_id, extras=eng.context, capacity=decode_at + 16)
    tok = torch.argmax(logits, dim=-1)[:, None]
    pos = torch.tensor([decode_at], dtype=torch.int32, device=dev)
    ext, _ = eng.builder.build_prefix(doc, extend_at, doc_id=eng.doc_id, extras=eng.context,
                                      materialize=False, capacity=extend_at + n_ext)
    chunk = torch.as_tensor(doc[None, extend_at:extend_at + n_ext].astype(np.int64),
                            device=dev)
    start = torch.tensor(extend_at, dtype=torch.int32, device=dev)
    runs = {"decode": (1, lambda: model.decode_step(params, caches, tok, pos), 4),
            "extend": (n_ext, lambda: model.prefill_extend(params, ext, chunk, start), 1)}
    if cfg.encoder_layers:
        first = eng.builder._tokens(doc[None, :n_ext])
        runs["cold prefill"] = (n_ext, lambda: model.prefill(
            params, {"tokens": first, **eng.context}), 1)
    steps = {name: profile_steps(f"{label} {name} ({n} tokens)", k, fn, dev)
             for name, (n, fn, k) in runs.items()}
    (s, j), = {(s, j) for s, (period, _) in enumerate(model.segments)
               for j, spec in enumerate(period) if spec.cross}
    n_cross = model.segments[s][1]
    n_dense = sum(n for period, n in model.segments for spec in period
                  if spec.mlp == "dense")
    lp = _layer_params(params["segments"][s][f"p{j}"], 0)
    ctx_kv = (caches[s][f"p{j}"]["ck"][0], caches[s][f"p{j}"]["cv"][0])
    enc_ms = 0.0
    if cfg.encoder_layers:
        enc_ms, enc_n = device_profile(lambda: model._context(params, eng.context, dev),
                                       "", launches=2)
        print(f"  {label} encoder alone ({cfg.encoder_layers} layers over "
              f"{cfg.encoder_context} frames): {enc_ms:.3f} ms ({enc_n:g} device activities)")
    for name, (n, _, _) in runs.items():
        x = randn((1, n, cfg.d_model), model.compute_dtype, dev, 5)
        cross_ms, cross_n = device_profile(lambda: model._cross(lp, x, ctx_kv), "", launches=5)
        dense_ms, dense_n = device_profile(
            lambda: moe_mod.dense_ffn(lp["mlp"], x, cfg.activation), "", launches=5)
        st = steps[name]
        each = (f"cross sublayer {cross_ms:.3f} ms ({cross_n:g} device activities), dense "
                f"FFN {dense_ms:.3f} ms ({dense_n:g})")
        if not st:
            print(f"  {label} {name}: one layer's parts alone on {n} tokens: {each}; step "
                  f"split not measured")
            continue
        enc = enc_ms if name == "cold prefill" else 0.0
        cross_all, dense_all = cross_ms * n_cross, dense_ms * n_dense
        rest = st["busy"] - st["ours"] - cross_all - dense_all - enc
        print(f"  {label} {name} split: wall {st['wall']:.2f} ms = device busy "
              f"{st['busy']:.2f} ms + host idle {max(st['wall'] - st['busy'], 0.0):.2f} ms; "
              f"busy = attention kernel {st['ours']:.3f} ms + {n_cross} cross sublayers "
              f"{cross_all:.2f} ms + encoder {enc:.2f} ms + {n_dense} dense FFN layers "
              f"{dense_all:.2f} ms + the rest (self-attention projections, norms, "
              f"embedding, head) {rest:.2f} ms; one layer's parts alone on {n} tokens: "
              f"{each}")


# ---------------------------------------------------------------------------
# phase 15: training at full width
# ---------------------------------------------------------------------------

#: phase 15 (a)'s depth: deepseek-67b cut from 95 layers to 2 (3.06 B
#: parameters: bf16 weights, fp32 AdamW moments and gradient sum fit one
#: 80 GB card)
TRAIN_LAYERS = 2
#: phase 15's runs: steps of batch 8 x seq 1024 from ``lm_pipeline``, the
#: peak learning rate after a warmup of 2 steps per run: at d 8192 an AdamW
#: step of 1e-3 moves a logit by up to d x lr (the loss rose from 13.2 to 46.6
#: in one step on the card), at mamba2-130m's d 768 it is safe
TRAIN_FULL = dict(steps=6, batch=8, seq=1024, warmup=2)
#: phase 15's measured step per config (step s, peak bytes, model FLOPs,
#: train_mfu), which phase 17 reads
TRAIN_INFO: dict = {}
TRAIN_LR = {"deepseek-67b": 2e-5, "mamba2-130m": 1e-3}
#: the weights each token's forward multiplies (the embedding is a gather
#: unless tied to the head)
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in", "w_out",
                 "lm_head")
#: kernel names of the dense products (cuBLAS / CUTLASS) in a trace
GEMM_NAMES = ("gemm", "Gemm", "xmma", "cutlass", "sm90_", "nvjet")


def model_flops(model, params, tokens: int, seq: int) -> tuple[float, str]:
    """Model FLOPs of one training step over ``tokens`` tokens of ``seq``:
    (the count, its formula).  Products 6·T·N (N the weights in products:
    forward 2, backward 4), causal attention 6·T·S·H·hd per attention layer
    (QKᵀ and PV over S/2 keys on average, times 3), the SSD scan's chunked
    products as computed, 3·T·h·(2·l·(n + p) + 4·p·n) per SSD layer.
    Remat's recomputation is not counted."""
    from repro_torch.models.common import tree_items_sorted

    cfg = model.cfg
    keys = MATMUL_LEAVES + (("embed",) if cfg.tie_embeddings else ())
    n = sum(x.numel() for path, x in tree_items_sorted(params) if path[-1] in keys)
    kinds = [spec.mixer for period, reps in model.segments for spec in period
             for _ in range(reps)]
    n_attn = sum(k == "attn" for k in kinds)
    n_ssd = sum(k == "ssd" for k in kinds)
    flops = 6.0 * tokens * n + 6.0 * tokens * seq * cfg.n_heads * cfg.head_dim * n_attn
    formula = f"6·T·N ({n / 1e9:.4f} B weights in products)"
    if n_attn:
        formula += f" + 6·T·S·H·hd·{n_attn} attention layers"
    if n_ssd:
        s = cfg.ssm
        h, l = s.n_heads(cfg.d_model), min(s.chunk, seq)
        flops += 3.0 * tokens * h * (2 * l * (s.d_state + s.head_dim)
                                     + 4 * s.head_dim * s.d_state) * n_ssd
        formula += f" + 3·T·h·(2·l·(n + p) + 4·p·n)·{n_ssd} SSD layers"
    return flops, formula + f", T {tokens}, S {seq}"


def timed_optimizer(opt, events: list):
    """``opt`` whose update records a CUDA event pair around it (the
    optimizer's share of a step, on the device's clock)."""
    from repro_torch.train.optim import Optimizer

    def update(*args):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = opt.update(*args)
        ev[1].record()
        events.append(ev)
        return out

    return Optimizer(opt.init, update)


def profile_train_step(label, model, state, batch, step_idx, sched, k, dev) -> dict:
    """One more training step under ``torch.profiler`` (device activities):
    wall and device busy time, the idle share, the dense products' kernels,
    the optimizer (CUDA events around its update) and the top kernels.
    Updates ``state`` in place."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import make_optimizer

    events: list = []
    step, _ = make_train_step(model, timed_optimizer(make_optimizer(model.cfg.optimizer), events),
                              microbatches=k, schedule=sched)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state.params, state.opt_state, m = step(state.params, state.opt_state, batch, step_idx)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    opt_ms = events[0][0].elapsed_time(events[0][1])
    check(bool(torch.isfinite(m["loss"])), f"{label}: profiled step's loss not finite")
    if not rows:
        print(f"  {label} profiled step: wall {wall:.1f} ms; the profiler saw no device "
              f"time (split not measured); optimizer {opt_ms:.1f} ms (CUDA events)")
        return {"wall": wall, "optimizer": opt_ms}
    busy = sum(ms for _, ms, _ in rows)
    gemm = sum(ms for key, ms, _ in rows if any(g in key for g in GEMM_NAMES))
    print(f"  {label} profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle "
          f"{max(wall - busy, 0.0):.1f} ms ({max(wall - busy, 0.0) / wall:.0%}); dense "
          f"product kernels {gemm:.1f} ms ({gemm / busy:.0%} of busy; attention's "
          f"products among them), optimizer {opt_ms:.1f} ms (CUDA events around its "
          f"update), the rest {busy - gemm:.1f} ms of other kernels")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"    {ms:9.3f} ms  {ms / busy:5.1%}  x{n:<5d} {key[:90]}")
    return {"wall": wall, "busy": busy, "gemm": gemm, "optimizer": opt_ms}


def attention_alone(cfg, dev, seq: int, calls: int) -> float:
    """Blocked attention at the step's shape (one row of ``seq``, bf16),
    forward and forward + backward timed alone (CUDA events, median of 5);
    returns ``calls`` × (forward + forward-and-backward), what a step with
    remat runs (the first forward, then the recomputation and backward)."""
    from repro_torch.models.attention import blocked_attention

    g = torch.Generator(device=dev).manual_seed(0)
    def rnd(h):
        return torch.randn((1, seq, h, cfg.head_dim), generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
    q, k, v = rnd(cfg.n_heads), rnd(cfg.n_kv_heads), rnd(cfg.n_kv_heads)
    pos = torch.arange(seq, device=dev)[None]

    def fwd():
        with torch.no_grad():
            blocked_attention(q, k, v, pos, pos, causal=True, block=cfg.attn_block)

    def fwd_bwd():
        out = blocked_attention(q, k, v, pos, pos, causal=True, block=cfg.attn_block)
        torch.autograd.grad(out.float().sum(), (q, k, v))

    def ms(fn):
        fn()
        times = []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    f, fb = ms(fwd), ms(fwd_bwd)
    print(f"  blocked attention alone (1 x {seq}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
          f"{cfg.head_dim}, bf16 in, fp32 scores): forward {f:.2f} ms, forward + backward "
          f"{fb:.2f} ms; x {calls} per step = {calls * (f + fb):.1f} ms")
    return calls * (f + fb)


def train_full_width(dev, cfg, label: str, *, ckpt: bool) -> list[float]:
    """``train_loop`` over ``TRAIN_FULL`` on ``cfg`` on the card (seed 0),
    batches from ``lm_pipeline``: each step's loss, grad norm, lr and time
    (CUDA events from the batch's hand-over to its metrics, the first step
    apart), tokens/s, ``train_mfu``, peak memory, no retry and no extend or
    decode launch; the loss finite and falling.  With ``ckpt`` the loop
    checkpoints every 4 steps and at the end through ``AsyncCheckpointer``:
    the last checkpoint must restore bitwise, and a step from it must give
    bitwise the in-memory state's loss.  Then one more step profiled.
    Returns the loss of every step of the loop."""
    from repro_torch.data.pipeline import lm_pipeline
    from repro_torch.models.common import tree_items_sorted, tree_leaves
    from repro_torch.models.lm import LM
    from repro_torch.train.checkpoint import latest_step, restore_checkpoint
    from repro_torch.train.loop import make_train_step, train_loop
    from repro_torch.train.optim import warmup_cosine

    t = TRAIN_FULL
    k = cfg.train_microbatches
    tokens = t["batch"] * t["seq"]
    lr = TRAIN_LR[cfg.name]
    sched = warmup_cosine(lr, t["warmup"], t["steps"] + 2)
    pipe = lm_pipeline(cfg.vocab_size, batch=t["batch"], seq=t["seq"], n_shards=4, seed=0)
    starts, ends, hist = [], [], []

    def batches():
        for b in pipe:
            dev_b = {kk: torch.from_numpy(v).to(dev) for kk, v in b.items()}
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            yield dev_b

    def on_metrics(m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        hist.append(m)

    model = LM(cfg, device=dev)
    root = Path(tempfile.mkdtemp(prefix="repro_torch_smoke_")) if ckpt else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = kernel_launches()
    it = batches()
    try:
        state, _ = train_loop(model, it, steps=t["steps"], seed=0, on_metrics=on_metrics,
                              checkpoint_every=4 if ckpt else 0,
                              checkpoint_dir=str(root) if ckpt else None, schedule=sched)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        n_params = sum(x.numel() for x in tree_leaves(state.params))
        times = [a.elapsed_time(b) / 1e3 for a, b in zip(starts, ends)]
        steady = float(np.mean(times[1:]))
        flops, formula = model_flops(model, state.params, tokens, t["seq"])
        TRAIN_INFO[cfg.name] = {"step_s": steady, "peak": peak, "model_flops": flops,
                                "mfu": flops / steady / PEAK_FLOPS[torch.bfloat16]}
        losses = [h["loss"] for h in hist]
        print(f"  {label}: {n_params / 1e9:.4f} B parameters ({cfg.param_dtype}, compute "
              f"{cfg.compute_dtype}), {cfg.optimizer}, remat {cfg.remat}, {k} microbatches, "
              f"batch {t['batch']} x seq {t['seq']} from lm_pipeline, lr warmup_cosine("
              f"{lr:g}, {t['warmup']}, {t['steps'] + 2})")
        for h, s in zip(hist, times):
            print(f"    step {h['step']}: loss {h['loss']:.4f}, grad norm {h['grad_norm']:.4f}, "
                  f"lr {h['lr']:.3e}, {s:.3f} s, retries {h['retries']}")
        print(f"    step time {steady:.4f} s (mean of steps 1-{t['steps'] - 1}; step 0 "
              f"{times[0]:.3f} s), {tokens / steady:,.0f} tokens/s; train_mfu "
              f"{flops / steady / PEAK_FLOPS[torch.bfloat16]:.4f} = model FLOPs per step "
              f"{flops:.4e} / step time / 989e12 (model FLOPs = {formula}); peak memory "
              f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)")
        check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
        check(sum(h["retries"] for h in hist) == 0, f"{label}: a step was retried")
        if ckpt:
            last = latest_step(root)
            check(last == t["steps"], f"{label}: latest checkpoint {last}")
            live = {"params": state.params, "opt_state": state.opt_state}
            back = restore_checkpoint(root / f"step_{last}", live, verify=True, device=dev)
            same = all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(tree_leaves(back), tree_leaves(live)))
            check(same, f"{label}: the restored checkpoint differs from the saved state")
            batch = next(it)
            step, _ = make_train_step(model, microbatches=k, schedule=sched)
            p_r, _, m_r = step(back["params"], back["opt_state"], batch, last)
            p_m, _, m_m = step(state.params, state.opt_state, batch, last)
            check(torch.equal(m_r["loss"], m_m["loss"]),
                  f"{label}: a step from the restored checkpoint gave another loss "
                  f"({float(m_r['loss'])!r} vs {float(m_m['loss'])!r})")
            worst, equal = 0.0, 0
            items = tree_items_sorted(p_m)
            for (path, a), (_, b) in zip(items, tree_items_sorted(p_r)):
                equal += bool(torch.equal(a, b))
                worst = max(worst, float(torch.linalg.vector_norm((a - b).double())
                                         / torch.linalg.vector_norm(a.double()).clamp(min=1e-30)))
            print(f"    checkpoint step_{last} through AsyncCheckpointer: restored bitwise; "
                  f"the next step's loss from it {float(m_r['loss']):.6f} bitwise the "
                  f"in-memory state's; parameters after it: {equal} of {len(items)} leaves "
                  f"bitwise, worst leaf {worst:.2e} of its norm (limit 1e-4: the card may "
                  f"sum a gradient in another order)")
            check(worst <= 1e-4, f"{label}: parameters after the restored step: {worst:.3e}")
            del back, p_r
        check(kernel_launches() == before,
              f"{label}: training launched an attention kernel: {before} -> {kernel_launches()}")
        batch = next(it)
        split = profile_train_step(label, model, state, batch, t["steps"] + int(ckpt), sched, k, dev)
        if any(spec.mixer == "attn" for period, _ in model.segments for spec in period):
            att = attention_alone(cfg, dev, t["seq"], cfg.n_layers * k)
            if "busy" in split:
                print(f"    split: dense products {split['gemm']:.1f} ms (attention's "
                      f"{att:.1f} ms alone, part fp32 on the CUDA cores), optimizer "
                      f"{split['optimizer']:.1f} ms, device idle "
                      f"{max(split['wall'] - split['busy'], 0.0) / split['wall']:.0%} of "
                      f"{split['wall']:.1f} ms")
        check(kernel_launches() == before,
              f"{label}: training launched an attention kernel: {before} -> {kernel_launches()}")
        return losses
    finally:
        pipe.close()
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)


def training_phase(dev) -> list[float]:
    """Phase 15; returns (a)'s losses, step by step."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import param_specs

    base = get_config("deepseek-67b")
    cfg = dataclasses.replace(base, n_layers=TRAIN_LAYERS)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(param_specs(cfg)))
    print(f"  (a) deepseek-67b, {TRAIN_LAYERS} of {base.n_layers} layers: reckoned "
          f"{n / 1e9:.4f} B parameters x 16 B (bf16 parameter 2, fp32 moments 8, fp32 "
          f"gradient sum 4, bf16 gradient 2) = {16 * n / 1e9:.1f} GB before activations")
    losses = train_full_width(dev, cfg, "(a) deepseek-67b", ckpt=False)
    torch.cuda.empty_cache()
    print("  (b) mamba2-130m, 24 layers (full depth)")
    train_full_width(dev, get_config("mamba2-130m"), "(b) mamba2-130m", ckpt=True)
    torch.cuda.empty_cache()
    return losses


# ---------------------------------------------------------------------------
# phase 16: distribution on a world-size-1 NCCL mesh
# ---------------------------------------------------------------------------

def full_width_state(model, dev, seed: int = 0):
    """Parameters as ``train_loop`` draws them (a generator on the card
    seeded with ``seed``) and the optimizer's initial state."""
    from repro_torch.train.optim import make_optimizer

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    return params, make_optimizer(model.cfg.optimizer).init(params)


def pipeline_batches(cfg, dev, steps: int) -> list:
    """The first ``steps`` batches phase 15 trains on, on the card."""
    from repro_torch.data.pipeline import lm_pipeline

    t = TRAIN_FULL
    pipe = lm_pipeline(cfg.vocab_size, batch=t["batch"], seq=t["seq"], n_shards=4, seed=0)
    try:
        return [{k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
                for _ in range(steps)]
    finally:
        pipe.close()


def same_leaves(a, b) -> tuple[int, int]:
    """(leaves equal bitwise in dtype and value, leaves) of two trees."""
    from repro_torch.models.common import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return sum(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb)), len(la)


def multipod_parity(dev, mesh) -> None:
    """Phase 16 (a): full-depth ``mamba2-130m``, two uncompressed multipod
    steps against ``make_train_step``, and ``compressed_psum`` at n = 1
    against ``ef_compress``, all bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import compressed_psum, ef_compress
    from repro_torch.distributed.multipod import ef_init, make_multipod_train_step
    from repro_torch.models.common import tree_leaves, tree_map_with_path
    from repro_torch.models.lm import LM
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import warmup_cosine

    cfg = get_config("mamba2-130m")
    model = LM(cfg, device=dev)
    k = cfg.train_microbatches
    sched = warmup_cosine(TRAIN_LR[cfg.name], TRAIN_FULL["warmup"], TRAIN_FULL["steps"] + 2)
    batches = pipeline_batches(cfg, dev, 2)
    captured = []

    def capture(grads):
        captured.append(tree_map_with_path(lambda _, g: g.clone(), grads))
        return grads

    single, _ = make_train_step(model, microbatches=k, schedule=sched, grad_transform=capture)
    multi, _ = make_multipod_train_step(model, mesh, microbatches=k, schedule=sched,
                                        compress=False)
    p_s, o_s = full_width_state(model, dev)
    p_m, o_m = full_width_state(model, dev)
    ef = ef_init(p_m)
    for i, batch in enumerate(batches):
        p_s, o_s, m_s = single(p_s, o_s, batch, i)
        p_m, o_m, ef, m_m = multi(p_m, o_m, ef, batch, i)
        check(torch.equal(m_s["loss"], m_m["loss"]),
              f"16 (a): step {i} loss {float(m_m['loss'])!r} vs make_train_step's "
              f"{float(m_s['loss'])!r}")
    params, opt = same_leaves(p_m, p_s), same_leaves(o_m, o_s)
    n = sum(x.numel() for x in tree_leaves(p_s))
    print(f"  (a) mamba2-130m, {cfg.n_layers} layers ({n / 1e9:.4f} B, {cfg.param_dtype}), "
          f"{k} microbatches of lm_pipeline's {TRAIN_FULL['batch']} x {TRAIN_FULL['seq']}: 2 "
          f"uncompressed multipod steps vs make_train_step: losses "
          f"{float(m_m['loss']):.6f} bitwise, parameters {params[0]} of {params[1]} leaves "
          f"bitwise, optimizer state {opt[0]} of {opt[1]}")
    check(params[0] == params[1] and opt[0] == opt[1],
          "16 (a): the multipod step's state differs from make_train_step's")
    del p_s, o_s, p_m, o_m, ef
    grads = captured[0]
    ef = ef_init(grads)
    for label in ("zero residual", "carried residual"):
        mean, new_ef = compressed_psum(grads, ef, mesh["pod"])
        equal = 0
        for g, e, mm, ne in zip(tree_leaves(grads), tree_leaves(ef), tree_leaves(mean),
                                tree_leaves(new_ef)):
            q, scale, residual = ef_compress(g, e)
            equal += torch.equal(mm, q.float() * scale) and torch.equal(ne, residual)
        leaves = len(tree_leaves(grads))
        print(f"    compressed_psum at n = 1 ({label}): {equal} of {leaves} leaves bitwise "
              f"ef_compress's dequantized value and residual")
        check(equal == leaves, f"16 (a): compressed_psum at n = 1 ({label}) differs from "
                               f"ef_compress")
        ef = new_ef


def multipod_full_width(dev, mesh, phase15_losses: list[float]) -> dict:
    """Phase 16 (b): ``deepseek-67b`` at ``TRAIN_LAYERS`` layers, 6
    compressed multipod steps from phase 15 (a)'s parameters, batches and
    schedule."""
    import repro_torch.distributed.multipod as multipod
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import LM
    from repro_torch.train.optim import warmup_cosine

    cfg = dataclasses.replace(get_config("deepseek-67b"), n_layers=TRAIN_LAYERS)
    model = LM(cfg, device=dev)
    t = TRAIN_FULL
    k = cfg.train_microbatches
    sched = warmup_cosine(TRAIN_LR[cfg.name], t["warmup"], t["steps"] + 2)
    batches = pipeline_batches(cfg, dev, t["steps"])
    exchange: list = []
    inner = multipod.compressed_mean

    def timed_mean(*args):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = inner(*args)
        ev[1].record()
        exchange.append(ev)
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt_state = full_width_state(model, dev)
    ef = multipod.ef_init(params)
    leaves = tree_leaves(params)
    n = sum(x.numel() for x in leaves)
    largest = max(x.numel() for x in leaves)
    step, _ = multipod.make_multipod_train_step(model, mesh, microbatches=k, schedule=sched,
                                                compress=True)
    losses, times, exch = [], [], []
    multipod.compressed_mean = timed_mean
    try:
        for i, batch in enumerate(batches):
            exchange.clear()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            params, opt_state, ef, m = step(params, opt_state, ef, batch, i)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
            exch.append(sum(x.elapsed_time(y) for x, y in exchange))
            losses.append(float(m["loss"]))
            print(f"    step {i}: loss {losses[-1]:.4f}, grad norm {float(m['grad_norm']):.4f}, "
                  f"lr {float(m['lr']):.3e}, {times[-1]:.3f} s, pod exchange "
                  f"{exch[-1]:.1f} ms ({len(exchange)} leaves), retries 0")
    finally:
        multipod.compressed_mean = inner
    peak = torch.cuda.max_memory_allocated(dev)
    steady = float(np.mean(times[1:]))
    tokens = t["batch"] * t["seq"]
    gap = losses[-1] - phase15_losses[-1]
    print(f"  (b) deepseek-67b, {TRAIN_LAYERS} layers ({n / 1e9:.4f} B, {cfg.param_dtype}), "
          f"{cfg.optimizer}, {k} microbatches, lr warmup_cosine({TRAIN_LR[cfg.name]:g}, "
          f"{t['warmup']}, {t['steps'] + 2}), EF-int8 pod exchange at n = 1: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; phase 15 (a) on the same batches "
          f"{phase15_losses[0]:.4f} -> {phase15_losses[-1]:.4f}, last-loss gap {gap:+.4f}")
    print(f"    step time {steady:.4f} s (mean of steps 1-{t['steps'] - 1}; step 0 "
          f"{times[0]:.3f} s), {tokens / steady:,.0f} tokens/s; pod exchange "
          f"{float(np.mean(exch[1:])):.1f} ms a step (CUDA events around each leaf's "
          f"compressed_mean); retries 0")
    print(f"    peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); reckoned steady "
          f"{18 * n / 1e9:.1f} GB (bf16 parameter 2, fp32 moments 8, fp32 gradient sum 4, "
          f"fp32 EF 4 B a parameter) + the largest leaf's exchange temporaries "
          f"{13 * largest / 1e9:.1f} GB (13 B an element of {largest / 1e6:.0f} M)")
    check(all(np.isfinite(losses)), f"16 (b): non-finite loss {losses}")
    check(losses[-1] < losses[0], f"16 (b): loss did not fall: {losses}")
    return {"losses": losses, "step_s": steady, "peak": peak}


#: phase 16 (b)'s readings in PR 26's run (NVIDIA H100 80GB HBM3, 700 W)
PHASE16B_PR26 = {"step_s": 0.8791, "peak_gb": 67.76}
#: phase 16 (d)'s comparison: the uncompressed multi-pod train_4k cell of
#: deepseek-67b in PR 27's dry-run table (arguments a device, FLOPs a device)
MULTI_POD_CELL_PR27 = {"arg_gb": 2.63, "flops": 1.513e15}


def sharded_full_width(dev, mesh, phase16b: dict) -> None:
    """Phase 16 (c): the multipod step's sharded form (tensor parallelism)
    on the card: ``deepseek-67b`` at ``TRAIN_LAYERS`` layers, parameters,
    AdamW state and ``ef`` as ``DTensor`` s on the (1, 1) ``data`` x
    ``model`` sub-mesh under the sub-mesh's rules.  Two uncompressed steps
    against ``make_train_step`` from the same state (the two runs one
    after the other: both states do not fit the card at once; the
    sharded run's parameters wait on the host), then 6 compressed steps
    timed as phase 16 (b)'s."""
    import repro_torch.distributed.multipod as multipod
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_rules, place, strip_axis, use_rules
    from repro_torch.models.common import tree_items_sorted, tree_leaves, tree_map_with_path
    from repro_torch.models.lm import LM
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import make_optimizer, warmup_cosine

    cfg = dataclasses.replace(get_config("deepseek-67b"), n_layers=TRAIN_LAYERS)
    model = LM(cfg, device=dev)
    t = TRAIN_FULL
    k = cfg.train_microbatches
    sched = warmup_cosine(TRAIN_LR[cfg.name], t["warmup"], t["steps"] + 2)
    batches = pipeline_batches(cfg, dev, t["steps"])
    sub = mesh["data", "model"]
    rules = strip_axis(make_rules(multi_pod=True, fsdp=True), "pod")
    opt = make_optimizer(cfg.optimizer)

    def sharded_state():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = tree_map_with_path(lambda _, p, sp: place(p, sp.axes, rules, sub),
                                    model.init(gen), model.specs)
        return params, opt.init(params), multipod.ef_init(params)

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    # (c.1) two uncompressed steps, the sharded program against make_train_step
    before = kernel_launches()
    step_u, _ = multipod.make_multipod_train_step(model, mesh, opt, microbatches=k,
                                                  schedule=sched, compress=False)
    params, opt_state, ef = sharded_state()
    check(all(x.placements == y.placements for x, y in
              zip(tree_leaves(params), tree_leaves(opt_state["m"])))
          and all(x.placements == y.placements for x, y in
                  zip(tree_leaves(params), tree_leaves(ef))),
          "16 (c): the AdamW state or ef is not laid out like the parameters")
    layout = sorted({str(tuple(x.placements)) for x in tree_leaves(params)})
    sharded_losses = []
    with use_rules(rules, sub):
        for i in range(2):
            params, opt_state, ef, m = step_u(params, opt_state, ef, batches[i], i)
            sharded_losses.append(m["loss"].clone())
    host = [(path, local(x).cpu()) for path, x in tree_items_sorted(params)]
    del params, opt_state, ef
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    plain = model.init(gen)
    first = [x.clone() for _, x in tree_items_sorted(plain)]
    state = opt.init(plain)
    single, _ = make_train_step(model, opt, microbatches=k, schedule=sched)
    plain_losses = []
    for i in range(2):
        plain, state, m = single(plain, state, batches[i], i)
        plain_losses.append(m["loss"].clone())
    equal, worst = 0, 0.0
    for (path, got), (_, want), b in zip(host, tree_items_sorted(plain), first):
        got = got.to(dev)
        equal += bool(torch.equal(got, want))
        gap = torch.linalg.vector_norm((got - want).double())
        upd = torch.linalg.vector_norm((want - b).double()).clamp(min=1e-30)
        worst = max(worst, float(gap / upd))
    n_leaves = len(first)
    del host, plain, state, first
    torch.cuda.empty_cache()
    same_loss = all(torch.equal(a, b) for a, b in zip(sharded_losses, plain_losses))
    print(f"  (c) deepseek-67b, {TRAIN_LAYERS} layers, {cfg.optimizer}, {k} microbatches, "
          f"parameters / AdamW state / ef as DTensors on mesh['data', 'model'] "
          f"{tuple(sub.shape)} (layouts {', '.join(layout)}), use_rules(strip_axis("
          f"make_rules(multi_pod=True, fsdp=True), 'pod')): 2 uncompressed multipod steps "
          f"vs make_train_step: losses {[round(float(x), 6) for x in sharded_losses]} vs "
          f"{[round(float(x), 6) for x in plain_losses]} "
          f"({'bitwise' if same_loss else 'not bitwise'}), "
          f"parameters {equal} of {n_leaves} "
          f"leaves bitwise, worst leaf {worst:.3e} of its update (limit 2e-3)")
    check(worst <= 2e-3, f"16 (c): the sharded step's parameters are {worst:.3e} of the "
                         f"update from make_train_step's")

    # (c.2) six compressed steps, timed as phase 16 (b)'s
    exchange: list = []
    inner = multipod.compressed_mean

    def timed_mean(*args):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = inner(*args)
        ev[1].record()
        exchange.append(ev)
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    params, opt_state, ef = sharded_state()
    step, _ = multipod.make_multipod_train_step(model, mesh, opt, microbatches=k,
                                                schedule=sched, compress=True)
    losses, times, exch = [], [], []
    multipod.compressed_mean = timed_mean
    try:
        with use_rules(rules, sub):
            for i, batch in enumerate(batches):
                exchange.clear()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                params, opt_state, ef, m = step(params, opt_state, ef, batch, i)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) / 1e3)
                exch.append(sum(x.elapsed_time(y) for x, y in exchange))
                losses.append(float(m["loss"]))
                print(f"    step {i}: loss {losses[-1]:.4f}, grad norm "
                      f"{float(m['grad_norm']):.4f}, {times[-1]:.3f} s, pod exchange "
                      f"{exch[-1]:.1f} ms ({len(exchange)} leaves)")
    finally:
        multipod.compressed_mean = inner
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    del params, opt_state, ef
    steady = float(np.mean(times[1:]))
    gap = losses[-1] - phase16b["losses"][-1]
    print(f"    6 compressed steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}; phase 16 (b) on "
          f"the same batches {phase16b['losses'][0]:.4f} -> {phase16b['losses'][-1]:.4f}, "
          f"last-loss gap {gap:+.6f}, worst step gap "
          f"{max(abs(x - y) for x, y in zip(losses, phase16b['losses'])):.6f}")
    print(f"    step time {steady:.4f} s (mean of steps 1-{t['steps'] - 1}; step 0 "
          f"{times[0]:.3f} s) beside phase 16 (b)'s {phase16b['step_s']:.4f} s in this run "
          f"(PR 26: {PHASE16B_PR26['step_s']} s); pod exchange "
          f"{float(np.mean(exch[1:])):.1f} ms a step; peak memory {peak / 1e9:.2f} GB of "
          f"{total / 1e9:.2f} GB beside phase 16 (b)'s {phase16b['peak'] / 1e9:.2f} GB "
          f"(PR 26: {PHASE16B_PR26['peak_gb']} GB)")
    check(all(np.isfinite(losses)), f"16 (c): non-finite loss {losses}")
    check(losses[-1] < losses[0], f"16 (c): loss did not fall: {losses}")
    check(peak < total, f"16 (c): peak memory {peak} passes the card's {total}")
    check(kernel_launches() == before,
          f"16 (c): an extend or decode kernel launched: {before} -> {kernel_launches()}")


def compress_pod_dryrun() -> None:
    """Phase 16 (d): the ``--compress-pod`` cell on the production 2 x 16 x
    16 mesh, in a subprocess (its own fake group of 512 ranks)."""
    out = Path(tempfile.mkdtemp(prefix="repro_torch_dryrun_"))
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "deepseek-67b",
             "--shape", "train_4k", "--multi-pod", "--compress-pod", "--out", str(out)],
            cwd=ROOT, env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"16 (d): the dry run failed: {proc.stderr[-2000:]}")
        rec = json.loads((out / "deepseek-67b__train_4k__multi.json").read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    m, la = rec["memory"], rec["loop_aware"]
    ex = la["pod_exchange"]
    ref = MULTI_POD_CELL_PR27
    print(f"  (d) python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k "
          f"--multi-pod --compress-pod: {wall:.1f} s wall (trace {rec['seconds']['trace']:.1f} "
          f"s) on {rec['devices']} fake ranks: per device arguments "
          f"{m['argument_bytes'] / 1e9:.3f} GB, of them ef {ex['ef_bytes'] / 1e9:.3f} GB "
          f"(the uncompressed multi-pod cell: {ref['arg_gb']} GB), {la['flops']:.4e} FLOPs "
          f"({ref['flops']:.3e}), temp {m['temp_bytes'] / 1e9:.3f} GB; the pod exchange "
          f"{ex['all_gathers']:.0f} all-gathers, {ex['sent_bytes'] / 1e9:.4f} GB sent and "
          f"{ex['received_bytes'] / 1e9:.4f} GB received a device")
    check(la["flops"] > 0 and ex["sent_bytes"] == ex["ef_bytes"] / 4 + 2 * ex["all_gathers"],
          "16 (d): the pod exchange does not send each local shard's int8 codes and a scale")


def distribution_phase(dev, phase15_losses: list[float]) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.multipod import BACKENDS

    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_dist_"))
    dist.init_process_group(BACKENDS["cuda"], init_method=f"file://{tmp / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("pod", "data"))
        print(f"  mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on cuda, backend "
              f"{dist.get_backend(mesh['pod'].get_group())}")
        before = kernel_launches()
        multipod_parity(dev, mesh)
        torch.cuda.empty_cache()
        phase16b = multipod_full_width(dev, mesh, phase15_losses)
        torch.cuda.empty_cache()
        check(kernel_launches() == before,
              f"16: an extend or decode kernel launched: {before} -> {kernel_launches()}")
        tp = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        print(f"  mesh {tuple(tp.shape)} {tp.mesh_dim_names} on cuda (world size 1: the "
              f"multi-rank checks are the CPU tests' on 4 gloo ranks)")
        sharded_full_width(dev, tp, phase16b)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    compress_pod_dryrun()


# ---------------------------------------------------------------------------
# phase 17: introspection on the card
# ---------------------------------------------------------------------------

#: phase 17 (b)'s serving counts: phase 4's model, a 2048-token prefix, one
#: 128-token extend chunk at 2048 and one decode step at 2176, in a cache of
#: capacity 2304
INTRO_PREFIX, INTRO_CHUNK, INTRO_CAP = 2048, 128, 2304


def fake_train_count(cfg, *, memory: bool):
    """Phase 15 (a)'s training step traced on fake CPU tensors, no mesh:
    (op_analysis' result, argument bytes).  Structs from the registry."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models.common import struct_bytes, tree_leaves
    from repro_torch.models.registry import get_bundle
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import make_optimizer

    t = TRAIN_FULL
    b = get_bundle(cfg)
    with FakeTensorMode():
        params = b.param_structs(None, None, device="cpu")
        opt = make_optimizer(cfg.optimizer)
        state = b.opt_state_structs(opt, params, None, None, device="cpu")
        batch = b.train_batch_structs(ShapeSpec("phase 15", t["seq"], t["batch"], "train"),
                                      None, None, device="cpu")
        args = sum(struct_bytes(x) for x in tree_leaves([params, state, batch]))
        step, _ = make_train_step(b.model, opt, microbatches=cfg.train_microbatches)
        with OpCounter(memory=memory) as c:
            step(params, state, batch, 0)
    return c.result(), args


def registry_on_the_card(dev, cfg) -> None:
    """Phase 17 (a): the registry's structs on a world-size-1 mesh against
    the real parameter and AdamW trees of phase 15 (a)'s config, leaf for
    leaf; the dry run's bytes for one step against phase 15 (a)'s peak."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.multipod import BACKENDS
    from repro_torch.distributed.sharding import make_rules, strip_axis
    from repro_torch.models.common import struct_bytes, struct_shape, tree_items_sorted
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_bundle
    from repro_torch.train.optim import make_optimizer

    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_intro_"))
    dist.init_process_group(BACKENDS["cuda"], init_method=f"file://{tmp / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("pod", "data"))
        rules = strip_axis(make_rules(multi_pod=True, fsdp=True), "model")
        b = get_bundle(cfg)
        opt = make_optimizer(cfg.optimizer)
        ps = b.param_structs(rules, mesh)
        os_ = b.opt_state_structs(opt, ps, rules, mesh)
        model = LM(cfg, device=dev)
        params, state = full_width_state(model, dev)
        for label, structs, real in (("parameter", ps, params), ("optimizer-state", os_, state)):
            a, r = tree_items_sorted(structs), tree_items_sorted(real)
            same = [pa == pr and struct_shape(x) == tuple(y.shape) and x.dtype == y.dtype
                    and struct_bytes(x) == y.numel() * y.element_size()
                    for (pa, x), (pr, y) in zip(a, r)]
            n_bytes = sum(struct_bytes(x) for _, x in a)
            print(f"  (a) {label} structs on mesh {tuple(mesh.shape)}: {sum(same)} of {len(r)} "
                  f"leaves equal the card's in path, per-device shape, dtype and bytes "
                  f"({n_bytes / 1e9:.3f} GB)")
            check(len(a) == len(r) and all(same), f"17 (a): {label} structs differ from the "
                                                  f"card's tree")
        del params, state, model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    res, args = fake_train_count(cfg, memory=True)
    peak = TRAIN_INFO[cfg.name]["peak"]
    need = args + res["peak_bytes"]
    print(f"  (a) dry-run bytes of one phase 15 (a) step (fake trace, {time.perf_counter() - t0:.1f}"
          f" s): arguments {args / 1e9:.3f} GB + eager temp peak {res['peak_bytes'] / 1e9:.3f} GB "
          f"= {need / 1e9:.3f} GB against phase 15 (a)'s max_memory_allocated "
          f"{peak / 1e9:.3f} GB: ratio {need / peak:.4f}")
    check(0 < need and res["flops"] > 0, "17 (a): the dry run counted nothing")


def step_counts_on_the_card(dev, cfg) -> None:
    """Phase 17 (b), training: one phase 15 (a) step counted on the card
    and traced on fake CPU tensors; the FLOPs must be equal."""
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models.lm import LM
    from repro_torch.train.loop import make_train_step

    model = LM(cfg, device=dev)
    params, state = full_width_state(model, dev)
    batch = pipeline_batches(cfg, dev, 1)[0]
    step, _ = make_train_step(model, microbatches=cfg.train_microbatches)
    before = kernel_launches()
    t0 = time.perf_counter()
    with OpCounter() as c:
        step(params, state, batch, 0)
    torch.cuda.synchronize(dev)
    card = c.result()
    counted_s = time.perf_counter() - t0
    del params, state, model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu, _ = fake_train_count(cfg, memory=False)
    info = TRAIN_INFO[cfg.name]
    print(f"  (b) training step, phase 15 (a): card {card['flops']:.6e} FLOPs ({counted_s:.1f} s "
          f"counted), CPU fake trace {cpu['flops']:.6e} ({time.perf_counter() - t0:.1f} s); "
          f"op bytes card {card['op_bytes']:.6e}, CPU {cpu['op_bytes']:.6e}")
    print(f"      train_mfu over the counted FLOPs: {card['flops']:.4e} / "
          f"{info['step_s']:.4f} s / 989e12 = "
          f"{card['flops'] / info['step_s'] / PEAK_FLOPS[torch.bfloat16]:.4f}, against "
          f"6·N·D's {info['mfu']:.4f} ({info['model_flops']:.4e} model FLOPs); counted / "
          f"model {card['flops'] / info['model_flops']:.4f}")
    check(card["flops"] == cpu["flops"], f"17 (b): training FLOPs card {card['flops']} vs CPU "
                                         f"{cpu['flops']}")
    check(kernel_launches() == before, "17 (b): training launched an attention kernel")


def serving_counts_on_the_card(dev) -> None:
    """Phase 17 (b), serving: phase 4's model, one extend chunk and one
    decode step counted on the card (both kernels, by their formulas) and
    traced on fake CPU tensors (their plain versions, by the same
    formulas; ``pos`` stays a real tensor, so the decode formula reads its
    live length); the FLOPs must be equal, and each kernel must have
    launched once a layer."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.extend_attention import kernel as ek
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models.common import make_struct, tree_map_with_path
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config("deepseek-67b"), n_layers=FULL_LAYERS)
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 4096).astype(np.int32)
    toks = torch.from_numpy(doc[:INTRO_PREFIX + INTRO_CHUNK + 1])[None]
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": toks[:, :INTRO_PREFIX].to(dev)})
        caches = tree_map_with_path(lambda _, x: torch.nn.functional.pad(
            x, (0, 0, 0, 0, 0, INTRO_CAP - INTRO_PREFIX)), caches)
    chunk = toks[:, INTRO_PREFIX:INTRO_PREFIX + INTRO_CHUNK]
    last = toks[:, INTRO_PREFIX + INTRO_CHUNK:]
    at = INTRO_PREFIX + INTRO_CHUNK

    def steps(p, c, device):
        model.prefill_extend(p, c, chunk.to(device), INTRO_PREFIX)
        model.decode_step(p, c, last.to(device),
                          torch.tensor([at], dtype=torch.int32, device=device))

    ek.KERNEL.launches = 0
    dk.KERNEL.launches = 0
    with torch.no_grad(), OpCounter() as c:
        steps(params, caches, dev)
    torch.cuda.synchronize(dev)
    card = c.result()
    launches = {"extend_attention": ek.KERNEL.launches, "decode_attention": dk.KERNEL.launches}
    shapes = tree_map_with_path(lambda _, x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                                caches)
    del params, caches
    torch.cuda.empty_cache()
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        fparams = tree_map_with_path(lambda _, s: make_struct(s.shape, model.param_dtype,
                                                              device="cpu"), model.specs)
        fcaches = tree_map_with_path(lambda _, m: make_struct(m.shape, m.dtype, device="cpu"),
                                     shapes)
        with OpCounter() as c:
            steps(fparams, fcaches, "cpu")
    cpu = c.result()
    print(f"  (b) phase 4's model ({FULL_LAYERS} layers, bf16), a {INTRO_CHUNK}-token extend at "
          f"{INTRO_PREFIX} and a decode step at {at}, capacity {INTRO_CAP}: card "
          f"{card['flops']:.6e} FLOPs, CPU fake trace {cpu['flops']:.6e}; kernels by formula: "
          f"card {card['kernels']}, CPU {cpu['kernels']}; launches {launches}")
    check(card["flops"] == cpu["flops"], f"17 (b): serving FLOPs card {card['flops']} vs CPU "
                                         f"{cpu['flops']}")
    check(card["kernels"] == cpu["kernels"], "17 (b): the kernels' formulas differ card vs CPU")
    check(launches == {"extend_attention": FULL_LAYERS, "decode_attention": FULL_LAYERS}
          and card["kernels"]["extend_attention"]["calls"] == FULL_LAYERS
          and card["kernels"]["decode_attention"]["calls"] == FULL_LAYERS,
          f"17 (b): launches {launches}, counted {card['kernels']}")


def dryrun_cell() -> None:
    """Phase 17 (c): one full-size dry-run cell, in a subprocess (this
    process holds the card; the dry run starts its own fake group)."""
    out = Path(tempfile.mkdtemp(prefix="repro_torch_dryrun_"))
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "deepseek-67b",
             "--shape", "train_4k", "--out", str(out)],
            cwd=ROOT, env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"17 (c): the dry run failed: {proc.stderr[-2000:]}")
        rec = json.loads((out / "deepseek-67b__train_4k__single.json").read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    m, la = rec["memory"], rec["loop_aware"]
    print(f"  (c) python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k: "
          f"{wall:.1f} s wall (trace {rec['seconds']['trace']:.1f} s, build "
          f"{rec['seconds']['build']:.1f} s) on {rec['devices']} fake ranks: per device "
          f"arguments {m['argument_bytes'] / 1e9:.3f} GB, temp {m['temp_bytes'] / 1e9:.3f} GB, "
          f"{la['flops']:.4e} FLOPs, collectives {la['collective_bytes'] / 1e9:.1f} GB")
    check(la["flops"] > 0 and m["argument_bytes"] > 0, "17 (c): the dry run counted nothing")


def introspection_phase(dev) -> None:
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("deepseek-67b"), n_layers=TRAIN_LAYERS)
    registry_on_the_card(dev, cfg)
    torch.cuda.empty_cache()
    step_counts_on_the_card(dev, cfg)
    torch.cuda.empty_cache()
    serving_counts_on_the_card(dev)
    torch.cuda.empty_cache()
    dryrun_cell()


# ---------------------------------------------------------------------------
# phase 6: residency at full width
# ---------------------------------------------------------------------------

#: phase 4's requests, then a replay of the 4096-token prefix: once every
#: segment is stored, a replay reads only stored copies (the 4096 request
#: itself decoded from the KV it had just computed, before its int8 copies
#: were stored), so it is what a reloaded snapshot must reproduce
RESIDENCY_PREFIXES = (2048, 4096, 3072, 2048, 4096)


def residency_cost_model():
    """The serving calibration with a reuse prior of 4 stored-segment hits.

    Tier moves are priced per victim: demote now plus a promotion per
    expected hit, against a prefill per expected hit for a drop.  The
    observed prior is (hits + prior) / (puts + 1); with the default prior 1
    it falls to 1/17 by the end of the cold 2048 request, where a drop
    (0.76 ms of expected prefill) undercuts a host demotion of a 6.3 MB int8
    segment (0.84 ms), and a dropped segment is rebuilt in another plan:
    the runs would not compare.  This document is requested four times.
    """
    from repro_torch.core.cost import serve_cost_model

    cm = serve_cost_model()
    cm.expected_reuses = 4.0
    return cm


def serve_requests(eng, prefixes, label: str) -> list[dict]:
    out = []
    for prefix in prefixes:
        s0 = dataclasses.replace(eng.stats)
        toks, plan = eng.generate(prefix, 16)
        st = eng.stats
        out.append({"prefix": prefix, "tokens": toks,
                    "plan": [(s.rng.lo, s.rng.hi, s.model_id) for s in plan.steps],
                    "reused": st.tokens_reused - s0.tokens_reused,
                    "computed": st.tokens_computed - s0.tokens_computed,
                    "prefill_s": st.prefill_s - s0.prefill_s,
                    "decode_s": st.decode_s - s0.decode_s})
        r = out[-1]
        print(f"    {label} prefix {prefix}: prefill {r['prefill_s']:.3f} s ({r['reused']} "
              f"reused, {r['computed']} computed), decode {16 / r['decode_s']:.1f} tok/s, "
              f"tokens {toks[:8]}")
    return out


def tier_line(store) -> str:
    return (f"tiers {store.tier_bytes()}, demotions {store.demotions}, promotions "
            f"{store.promotions}, evictions {store.evictions}, quantized {store.quantized}, "
            f"spill writes {store.spill_writes}")


def residency_phase(base, ref, dev) -> int:
    """Phase 4's requests over int8 and tiered stores on phase 4's model;
    returns the ``quant_kv`` launches of the phase."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.extend_attention import kernel as ek
    from repro_torch.kernels.quant_kv import kernel as qk
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import SegmentStore

    model, params, doc = base.model, base.params, base.doc

    def engine(store):
        return ServeEngine(model, params, doc, chunk_tokens=128, store=store, device=dev)

    root = Path(tempfile.mkdtemp(prefix="repro_torch_smoke_"))
    dequants = 0
    for k in (ek.KERNEL, dk.KERNEL, qk.KERNEL):
        k.launches = 0
    try:
        # 1. int8, device only
        eng1 = engine(SegmentStore(precision="int8", cost_model=residency_cost_model(),
                                   device=dev))
        print("  1. int8 store, device only")
        w1 = serve_requests(eng1, RESIDENCY_PREFIXES, "int8")
        logits1, _, _ = eng1.builder.prefix_with_logits(doc, 3072, doc_id=eng1.doc_id,
                                                        capacity=3088)
        torch.cuda.synchronize(dev)
        store1 = eng1.store
        leaves = {len(s.quant.scales) for s in store1._segs.values() if s.quant is not None}
        launches1 = qk.KERNEL.launches
        dequants += eng1.builder.dequants
        doc_bytes = store1.nbytes()
        drift = float((logits1.float() - ref["logits"].float()).abs().max())
        same_tok = [sum(a == b for a, b in zip(r["tokens"], t))
                    for r, t in zip(w1, ref["tokens"])]
        print(f"    {len(store1)} segments, all int8: {store1.quantized_segments() == len(store1)}; "
              f"{leaves} quantized leaves each; dequants {eng1.builder.dequants}, quant_kv "
              f"launches {launches1}")
        print(f"    store {doc_bytes} B vs phase 4's bf16 store {ref['store_bytes']} B "
              f"({doc_bytes / ref['store_bytes']:.3f}x); 3072-prefix logits max |d| vs "
              f"the bf16 store's {drift:.4g} (max |logit| "
              f"{float(ref['logits'].float().abs().max()):.4g}); tokens equal to phase 4's "
              f"per request (of 16): {same_tok}; replay of 2048 vs its cold request: "
              f"{sum(a == b for a, b in zip(w1[3]['tokens'], w1[0]['tokens']))}/16 "
              f"(int8 copies vs the freshly computed bf16 KV; not gated)")
        check(len(store1) > 0 and store1.quantized_segments() == len(store1),
              "int8 store holds a segment at model precision")
        check(len(leaves) == 1, f"segments with different quantized leaves: {leaves}")
        n_leaves = leaves.pop()
        check(eng1.builder.dequants > 0 and launches1 == eng1.builder.dequants,
              f"quant_kv launches {launches1} != dequantized segments "
              f"{eng1.builder.dequants} (one launch per segment)")
        check(bool(torch.isfinite(logits1.float()).all()), "int8 logits not finite")
        # the quantization error alone: the cold request's first segment was
        # computed the same way for both stores
        from repro_torch.core.quant import dequantize_tree
        from repro_torch.models.common import tree_leaves

        sid = next(iter(base.store._segs))
        pairs = zip(tree_leaves(base.store._segs[sid].caches),
                    tree_leaves(dequantize_tree(store1._segs[sid].caches,
                                                store1._segs[sid].quant)))
        kv_err = [(float((b.float() - a.float()).abs().max() / a.float().abs().max()),
                   float((b.float() - a.float()).norm() / a.float().norm()))
                  for a, b in pairs]
        dequants += 1                    # this check's own dequantization
        print(f"    KV of {sid}, int8 against bf16 per leaf: max |d| / max |x|, "
              f"|d| / |x| = {[(f'{m:.3g}', f'{r:.3g}') for m, r in kv_err]}")
        # the writer thread sees host arrays only: save_async copies the
        # device-tier entries to the host before it returns
        t0 = time.perf_counter()
        check(store1.save_async(root / "snap1"), "save_async was refused")
        capture_s = time.perf_counter() - t0
        write_s = store1.flush_saves()
        check(not store1.save_errors, f"background save failed: {store1.save_errors}")
        print(f"    save_async of the all-device int8 store: the caller waited "
              f"{capture_s:.3f} s (device-to-host copies), the writer {write_s:.3f} s more")
        del eng1, store1, logits1
        torch.cuda.empty_cache()

        # 2. int8 with host and disk tiers under a quarter of the bytes each
        tiers = dict(byte_budget=doc_bytes // 4, host_budget=doc_bytes // 4)
        print(f"  2. int8 store, device budget {tiers['byte_budget']} B, host budget "
              f"{tiers['host_budget']} B, spill directory")
        eng2 = engine(SegmentStore(precision="int8", cost_model=residency_cost_model(),
                                   spill_dir=root / "spill2", device=dev, **tiers))
        w2 = serve_requests(eng2, RESIDENCY_PREFIXES, "int8 tiered")
        store2 = eng2.store
        store2.flush_saves()
        dequants += eng2.builder.dequants
        same = [r["tokens"] == s["tokens"] for r, s in zip(w2, w1)]
        print(f"    {tier_line(store2)}; tokens identical to way 1: {same}; plans "
              f"identical: {[r['plan'] == s['plan'] for r, s in zip(w2, w1)]}")
        check(min(store2.demotions.values()) > 0 and min(store2.promotions.values()) > 0,
              f"the tiered int8 run skipped a tier: {tier_line(store2)}")
        check(all(same), "tiered int8 tokens differ from the untiered int8 run")
        cm = store2.cost
        for tier in ("host", "disk"):
            seg = next((g for g in store2._segs.values() if g.tier == tier), None)
            if seg is None:
                continue
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            store2.promote(seg.seg_id)
            torch.cuda.synchronize(dev)
            print(f"    one promotion from {tier} ({seg.nbytes} B): "
                  f"{(time.perf_counter() - t0) * 1e3:.2f} ms measured; the cost "
                  f"model prices it at {cm.promote_s(seg.nbytes, tier) * 1e3:.2f} ms")

        # 3. bf16 (lossless) with the same tiers
        print("  3. bf16 store (precision fp32: lossless), same tiers")
        eng3 = engine(SegmentStore(precision="fp32", cost_model=residency_cost_model(),
                                   spill_dir=root / "spill3", device=dev, **tiers))
        w3 = serve_requests(eng3, RESIDENCY_PREFIXES[:4], "bf16 tiered")
        eng3.store.flush_saves()
        same3 = [r["tokens"] == t for r, t in zip(w3, ref["tokens"])]
        print(f"    {tier_line(eng3.store)}; tokens identical to phase 4's: {same3}")
        check(min(eng3.store.demotions.values()) > 0,
              f"the tiered bf16 run skipped a tier: {tier_line(eng3.store)}")
        check(all(same3), "tiered bf16 tokens differ from phase 4's")
        del eng3
        torch.cuda.empty_cache()

        # 4. snapshot of way 2, reloaded with the same tiers
        print("  4. snapshot of way 2's store, reloaded")
        t0 = time.perf_counter()
        store2.save(root / "snap")
        save_s = time.perf_counter() - t0
        snap_bytes = sum(f.stat().st_size for f in (root / "snap").iterdir())
        t0 = time.perf_counter()
        store4 = SegmentStore.load(root / "snap", cost_model=residency_cost_model(),
                                   precision="int8", spill_dir=root / "spill4",
                                   device=dev, **tiers)
        torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        print(f"    save {save_s:.3f} s, load {load_s:.3f} s, snapshot {snap_bytes} B "
              f"({len(store4)} segments, {store2.nbytes()} B resident), "
              f"{tier_line(store4)}")
        eng4 = engine(store4)
        w4 = serve_requests(eng4, (4096,), "reloaded")
        dequants += eng4.builder.dequants
        print(f"    prefix build computed {w4[0]['computed'] - 1} tokens (plus the last "
              f"prefix token's 1-token extend); tokens identical to way 2's replay: "
              f"{w4[0]['tokens'] == w2[4]['tokens']}")
        check(len(store4) == len(store2), "the snapshot lost segments")
        check(w4[0]["computed"] == 1 and w4[0]["reused"] == 4095,
              f"the reloaded store did not serve the prefix: {w4[0]}")
        check(w4[0]["tokens"] == w2[4]["tokens"],
              "the reloaded snapshot's tokens differ from the store it was saved from")
        del eng2, store2, eng4, store4
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = qk.KERNEL.launches
    print(f"  residency-phase launches: quant_kv {launches} (= {dequants} dequantized "
          f"segments of {n_leaves} leaves, one launch each), extend {ek.KERNEL.launches}, "
          f"decode {dk.KERNEL.launches}")
    check(launches == dequants, "quant_kv launched off the reuse path, or more than "
                                "once per segment")
    return launches


# ---------------------------------------------------------------------------
# phase 9: batched serving at full width
# ---------------------------------------------------------------------------

#: (shared document?, prefix) per session and round: four sessions on phase
#: 4's document, four on their own; round 2 reads a segment another session
#: made in round 1 (1024 after 1024's gap), and the continuations that
#: write-back made of the 4096-token requests (4112 = 4096 + 16)
SESSION_ROUNDS = (
    ((True, 2048), (True, 4096), (True, 3072), (True, 1024),
     (False, 512), (False, 1024), (False, 2048), (False, 4096)),
    ((True, 1024), (True, 4112), (True, 2048), (True, 3072),
     (False, 1024), (False, 2048), (False, 512), (False, 4112)),
)
SESSION_NEW_TOKENS = 16
#: phase 9's decode bucket (``SessionManager``'s default, passed explicitly)
SESSION_DECODE_BUCKET = 64


def session_pack_cap() -> int:
    """Capacity of phase 9's round-2 merged pack: the longest row's prefix
    plus its new tokens, rounded up to the decode bucket."""
    longest = max(p for _, p in SESSION_ROUNDS[1]) + SESSION_NEW_TOKENS
    return -(-longest // SESSION_DECODE_BUCKET) * SESSION_DECODE_BUCKET


def top2_gap(logits) -> tuple[float, float]:
    """(top-1 minus top-2 logit, largest |logit|) of a (1, V) row."""
    top = torch.topk(logits.float()[0], 2).values
    return float(top[0] - top[1]), float(logits.float().abs().max())


def single_logits(eng, prefix: int, tokens: list, at: int):
    """The logits ``ServeEngine.generate(prefix, ...)`` sampled token ``at``
    from, replayed through the same calls with the stream it produced."""
    model, params = eng.model, eng.params
    logits, caches, _ = eng.builder.prefix_with_logits(
        eng.doc, prefix, doc_id=eng.doc_id, extras=eng.context,
        capacity=prefix + SESSION_NEW_TOKENS)
    pos = torch.tensor([prefix], dtype=torch.int32, device=eng.device)
    for tok in tokens[:at]:
        nxt = torch.tensor([[tok]], dtype=torch.int64, device=eng.device)
        logits, caches = model.decode_step(params, caches, nxt, pos)
        pos = pos + 1
    return logits


def sessions_phase(base, dev) -> dict:
    """Eight sessions through ``SessionManager`` on phase 4's model and
    store, two rounds, async prefill, merged packs; every stream against
    ``ServeEngine.generate``.  Returns the attention kernels' launches."""
    from repro_torch.kernels.common import bf16_ulp
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.extend_attention import kernel as ek
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import cache_len, pad_cache_to
    from repro_torch.serve.session import SessionManager, batch_caches

    model, params, store = base.model, base.params, base.store
    cfg = model.cfg
    rng = np.random.default_rng(9)
    own = [rng.integers(0, cfg.vocab_size, 4096).astype(np.int32) for _ in range(4)]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mgr = SessionManager(model, params, chunk_tokens=128, max_batch=8, store=store,
                         async_prefill=True, decode_bucket=SESSION_DECODE_BUCKET)
    check(mgr.merge_decode_packs and mgr.decode_materialize,
          "phase 9 needs merged packs and decode write-back")
    sids, k = [], 0
    for shared, _ in SESSION_ROUNDS[0]:
        if shared:
            sids.append(mgr.add_session(base.doc, doc_id=base.doc_id))
        else:
            sids.append(mgr.add_session(own[k]))
            k += 1
    hits0 = store.cross_session_hits
    requests = []
    # the (batch, capacity) of every pack decoded, read from shapes alone
    # (no synchronisation); phase 2 holds the kernel against its plain
    # version at the full pack's shape
    pack_shapes: dict = {}

    def decode_step(params, caches, toks, pos):
        shape = (int(toks.shape[0]), cache_len(caches))
        pack_shapes[shape] = pack_shapes.get(shape, 0) + 1
        return type(model).decode_step(model, params, caches, toks, pos)

    model.decode_step = decode_step
    ek.KERNEL.launches = 0
    dk.KERNEL.launches = 0
    t0 = time.perf_counter()
    for r, reqs in enumerate(SESSION_ROUNDS):
        t_round = time.perf_counter()
        for sid, (_, prefix) in zip(sids, reqs):
            s = mgr.sessions[sid]
            check(prefix <= len(s.doc), f"phase 9: prefix {prefix} past session {sid}'s "
                                        f"{len(s.doc)}-token document")
            plan = mgr.submit(sid, prefix, SESSION_NEW_TOKENS)
            requests.append({"round": r, "sid": sid, "prefix": prefix, "doc": s.doc.copy(),
                             "doc_id": s.doc_id, "plan": plan})
        submit_s = time.perf_counter() - t_round
        out = mgr.run()
        torch.cuda.synchronize(dev)
        for q in requests[-len(sids):]:
            q["tokens"] = out[q["sid"]]
        print(f"  round {r + 1}: submit {submit_s:.3f} s (dispatch only), round "
              f"{time.perf_counter() - t_round:.3f} s; prefixes {[p for _, p in reqs]}; "
              f"reused per request {[len(q['plan'].models_used) for q in requests[-len(sids):]]} "
              f"segments")
    wall = time.perf_counter() - t0
    launches = {"extend_attention": ek.KERNEL.launches, "decode_attention": dk.KERNEL.launches}
    del model.decode_step
    peak = torch.cuda.max_memory_allocated(dev)
    rep = mgr.report()
    sc = mgr.sched
    agg = mgr.aggregate_stats()
    forks = [q for q in requests if q["round"] == 1 and q["prefix"] == 4112]
    print(f"  {len(sids)} sessions x {len(SESSION_ROUNDS)} rounds x {SESSION_NEW_TOKENS} "
          f"tokens: wall {wall:.2f} s, aggregate decode {agg.decode_tok_s:.1f} tok/s "
          f"({agg.tokens_decoded} tokens in {agg.decode_s:.2f} s of decode rounds), "
          f"{agg.tokens_decoded / wall:.1f} tok/s wall")
    print(f"  decode calls {sc.decode_calls}, mean batch {sc.mean_batch:.2f}, padded "
          f"occupancy {sc.decode_padded_frac:.3f} ({sc.decode_valid_tokens} valid / "
          f"{sc.decode_padded_tokens} padded KV tokens), pack rebuilds {sc.pack_rebuilds}, "
          f"attention {sc.decode_attn_flops / 1e12:.3f} TFLOP")
    print(f"  reuse {agg.reuse_frac:.1%} ({agg.tokens_reused} reused / {agg.tokens_computed} "
          f"computed), cross-session hits {store.cross_session_hits - hits0}, write-back "
          f"{sc.decode_segments} admitted / {sc.decode_rejects} rejected, forks served "
          f"{[len(q['plan'].models_used) for q in forks]} segments")
    print(f"  tickets {sc.tickets_launched} launched / {sc.tickets_joined} joined, join wait "
          f"{sc.join_wait_s:.3f} s (mean {sc.mean_join_wait_s * 1e3:.1f} ms), "
          f"{sc.overlap_steps} decode rounds overlapped builds; peak memory "
          f"{peak / 2**30:.2f} GiB; store {len(store)} segments "
          f"({store.nbytes() / 2**20:.0f} MiB); {nvidia_smi_line()}")
    print(f"  launches: {launches} (decode {launches['decode_attention']} = "
          f"{FULL_LAYERS} x {sc.decode_calls} decode calls); decode calls per (batch, "
          f"capacity): {dict(sorted(pack_shapes.items()))}")
    print(f"  decode graphs: {sc.decode_replays} of {sc.decode_calls} decode calls replayed, "
          f"{sc.decode_captures} captured; {sc.pack_reuses} of {sc.pack_rebuilds} packs built "
          f"in a reused buffer")
    full_pack = (len(SESSION_ROUNDS[1]), session_pack_cap())
    check(pack_shapes.get(full_pack, 0) > 0,
          f"phase 9 never decoded the pack shape {full_pack} that phase 2 checks")
    check(launches["decode_attention"] == FULL_LAYERS * sc.decode_calls,
          f"decode launches {launches['decode_attention']} != {FULL_LAYERS} x "
          f"{sc.decode_calls} decode calls")
    check(launches["extend_attention"] > 0, "phase 9 launched no extend kernel")
    check(sc.mean_batch > 1.0, f"phase 9 decoded at mean batch {sc.mean_batch}")
    check(store.cross_session_hits - hits0 > 0, "phase 9 saw no cross-session hit")
    check(sc.tickets_launched == sc.tickets_joined == len(requests),
          f"tickets {sc.tickets_launched} launched, {sc.tickets_joined} joined")
    check(all(len(q["tokens"]) == SESSION_NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in q["tokens"]) for q in requests),
          "phase 9: a stream is short or holds a token out of range")
    check(len(forks) == 2 and all(len(q["doc"]) == 4112 and q["plan"].models_used
                                  for q in forks),
          "phase 9: the continuations were not served from aliased segments")
    check(bool(rep) and all(np.isfinite(v) for v in rep.values()),
          "phase 9: the report holds a value that is not finite")
    mgr_builder = mgr.builder
    del mgr
    torch.cuda.empty_cache()

    # each stream against ServeEngine.generate on the same (document, prefix, 16)
    parted = []
    for q in requests:
        eng = ServeEngine(model, params, q["doc"], chunk_tokens=128, store=store,
                          doc_id=q["doc_id"], device=dev)
        single, _ = eng.generate(q["prefix"], SESSION_NEW_TOKENS)
        at = next((i for i, (x, y) in enumerate(zip(q["tokens"], single)) if x != y), None)
        if at is None:
            continue
        gap, top = top2_gap(single_logits(eng, q["prefix"], single, at))
        ulps = gap / float(bf16_ulp(torch.tensor(top)))
        parted.append((q["round"], q["sid"], q["prefix"], at, gap, ulps))
        print(f"  round {q['round'] + 1} session {q['sid']} prefix {q['prefix']}: batched and "
              f"single part at token {at}; the single run's top-2 gap there {gap:.4g} "
              f"({ulps:.2f} bf16 ulps of its largest logit {top:.4g}; limit "
              f"{REDUCED_BF16_LOGIT_ULPS})")
    print(f"  batched vs single-session streams: {len(requests) - len(parted)} of "
          f"{len(requests)} identical, {len(parted)} parted at a near-tie")
    check(all(p[5] <= REDUCED_BF16_LOGIT_ULPS for p in parted),
          f"phase 9: a batched stream parted from its single run away from a near-tie: "
          f"{parted}")

    # where a batched step's time goes: round 2's eight requests in one
    # merged pack (phase 5 profiles the batch-1 step)
    rows = [q for q in requests if q["round"] == 1]
    caches = [mgr_builder.prefix_with_logits(q["doc"], q["prefix"], doc_id=q["doc_id"],
                                             capacity=q["prefix"] + SESSION_NEW_TOKENS)[1]
              for q in rows]
    cap = max(cache_len(c) for c in caches)
    pack = batch_caches([pad_cache_to(c, cap) for c in caches])
    del caches
    toks = torch.tensor([[q["tokens"][0]] for q in rows], dtype=torch.int64, device=dev)
    pos = torch.tensor([q["prefix"] for q in rows], dtype=torch.int32, device=dev)
    profile_steps(f"batched decode step (B {len(rows)}, capacity {cap}, pos "
                  f"{[q['prefix'] for q in rows]})", 4,
                  lambda: model.decode_step(params, pack, toks, pos), dev)
    del pack
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 12: sharded serving at full width
# ---------------------------------------------------------------------------

#: phase 12's traffic: four sessions over four documents of this many
#: tokens, two homed on each of two shards, one full-prefix request per
#: session and round, these many greedy tokens each, chunk 128
SHARD_DOC_LEN = 1024
SHARD_NEW_TOKENS = 8


def shard_codec_times(store, seg, dev, label: str) -> None:
    """Host seconds of ``encode_segment`` (quantize on the card, copy to
    the host, deflate) and ``decode_segment`` (inflate, copy to the card)
    of one full-width segment, per wire precision, median of 5, beside
    what the cost model prices the same fetch at and a rebuild."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve.shard_store import decode_segment, encode_segment

    cm = store.cost
    for precision in ("int8", "fp32"):
        enc, dec = [], []
        for _ in range(5):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            blob = encode_segment(store, seg, precision=precision)
            enc.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            back = decode_segment(blob, device=dev)
            torch.cuda.synchronize(dev)
            dec.append(time.perf_counter() - t0)
        check(all(x.device == dev for x in tree_leaves(back.caches)),
              "a decoded segment did not land on the card")
        priced = cm.fetch_s(len(blob)) + cm.dequantize_s(len(blob))
        print(f"    {label}, {precision} wire: {seg.nbytes} B resident -> {len(blob)} B on the "
              f"wire; encode {float(np.median(enc)):.4f} s, decode {float(np.median(dec)):.4f} s "
              f"(host, median of 5); priced fetch_s + dequantize_s {priced:.4f} s; "
              f"recompute_s({seg.valid}) {cm.recompute_s(seg.valid):.4f} s")


def sharded_phase(base, dev) -> int:
    """Sharded serving on phase 4's model: four sessions over four
    1024-token documents, two homed on each of two shards, through
    ``SessionManager`` and ``ShardedSegmentStore``.  (a) a plain store, 2
    rounds; (b) fp32 wire, 2 rounds (round 2 fetches the remote documents'
    segments): bitwise (a); (c) a 1e6x straggler on shard 1, rounds 3 and
    4: hedged, rebuilt, bitwise (a); (d) int8 wire twice: ``quant_kv``
    launches = dequants, bitwise repeatable.  Returns (d)'s ``quant_kv``
    launches."""
    from repro_torch.core.cost import serve_cost_model
    from repro_torch.kernels.quant_kv import kernel as qk
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import SegmentStore
    from repro_torch.serve.session import SessionManager, doc_key
    from repro_torch.serve.shard_store import HashRing, ShardedSegmentStore

    model, params = base.model, base.params
    cfg = model.cfg
    docs = balanced_docs(np.random.default_rng(12), cfg.vocab_size, SHARD_DOC_LEN, 4, 2)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def sharded_store(wire):
        return ShardedSegmentStore(2, cost_model=serve_cost_model(), seq_bucket=64,
                                   wire_precision=wire, device=dev)

    def serve(label, store, rounds, *, mgr=None, seed0=0):
        mgr = mgr or SessionManager(model, params, chunk_tokens=128, max_batch=8,
                                    decode_bucket=64, decode_materialize=False, store=store)
        sids = [mgr.add_session(d) for d in docs]
        streams, plans = [], []
        for r in range(rounds):
            t0 = time.perf_counter()
            for plan in mgr.submit_many([(sid, SHARD_DOC_LEN, SHARD_NEW_TOKENS, seed0 + r)
                                         for sid in sids]):
                plans.append([(s.rng.lo, s.rng.hi, s.model_id) for s in plan.steps])
            toks = mgr.run()
            torch.cuda.synchronize(dev)
            streams.append(tuple(tuple(toks[sid]) for sid in sids))
            st = mgr.store
            extra = ""
            if isinstance(st, ShardedSegmentStore):
                extra = (f"; fetched {st.remote_fetches} segments so far "
                         f"({st.fetched_wire_bytes / 1e6:.1f} MB wire, simulated transfers "
                         f"{st.transport.sim_transfer_s:.4f} s), hedged {st.hedged_fetches} "
                         f"({st.hedge_rebuild_wins} rebuild wins)")
            print(f"    {label} round {r + 1}: {time.perf_counter() - t0:.3f} s wall; reused "
                  f"{[sum(s[2] is not None for s in p) for p in plans[-4:]]} "
                  f"segments per request{extra}")
        return streams, plans, mgr

    def content_id(sid):
        # "kv:{doc}:{lo}-{hi}#{n}": n counts the puts of the store that
        # made the segment, and each shard numbers its own puts
        return None if sid is None else sid.rsplit("#", 1)[0]

    def all_segments(store):
        shards = store._shards() if isinstance(store, ShardedSegmentStore) else [store]
        return sorted(content_id(sid) for st in shards for sid in st._segs)

    def plan_ids(plans):
        return [[(lo, hi, content_id(sid)) for lo, hi, sid in p] for p in plans]

    qk.KERNEL.launches = 0
    homes = [HashRing(2).place(doc_key(d)) for d in docs]
    print(f"  {len(docs)} documents of {SHARD_DOC_LEN} tokens homed on shards {homes}; "
          f"chunk 128, {SHARD_NEW_TOKENS} greedy tokens per request, submit_many per round")
    print("  (a) plain one-shard store (lossless reference)")
    store_a = SegmentStore(cost_model=serve_cost_model(), seq_bucket=64, device=dev)
    a_streams, a_plans, _ = serve("(a)", store_a, 2)
    seg = next(iter(store_a._segs.values()))
    shard_codec_times(store_a, seg, dev, "one full-width segment")

    print("  (b) 2 shards, fp32 wire (bf16 residents ship as stored)")
    store_b = sharded_store("fp32")
    b_streams, b_plans, mgr_b = serve("(b)", store_b, 2)
    remote = [d for d, h in zip(docs, homes) if h != 0]
    remote_puts = sum(store_b.remotes[0]._doc_stats.get(doc_key(d), [0, 0])[0]
                      for d in remote)
    rep_b = store_b.shard_report()
    same_b = (b_streams == a_streams, plan_ids(b_plans) == plan_ids(a_plans),
              all_segments(store_b) == all_segments(store_a))
    print(f"    streams, plans, segment ids (document, range) == (a): {same_b}; remote fetches "
          f"{rep_b['remote_fetches']}, fetched hits {rep_b['fetched_hits']}, builder reuse "
          f"steps from fetches {mgr_b.builder.fetched_segments}, coalesce violations "
          f"{rep_b['coalesce_violations']}, most transfers to a shard in a tick "
          f"{rep_b['max_transfers_per_shard_tick']}, put-forwards {rep_b['put_forwards']} "
          f"(remote-homed chunks written {remote_puts})")
    check(all(same_b), f"phase 12 (b): the fp32-wire run is not (a)'s: {same_b}")
    check(rep_b["remote_fetches"] > 0 and rep_b["fetched_hits"] > 0,
          f"phase 12 (b): no cross-shard hit: {rep_b}")
    check(rep_b["coalesce_violations"] == 0 and rep_b["max_transfers_per_shard_tick"] <= 1,
          f"phase 12 (b): a tick broke the one-transfer-per-shard contract: {rep_b}")
    check(rep_b["put_forwards"] == remote_puts > 0,
          f"phase 12 (b): put-forwards {rep_b['put_forwards']} != remote-homed chunks "
          f"written {remote_puts}")

    print("  (c) after (b): shard 1 slowed 1e6x, rounds 3 and 4")
    store_b.transport.slowdown[1] = 1e6
    c_streams, _, _ = serve("(c)", store_b, 2, mgr=mgr_b, seed0=2)
    rep_c = store_b.shard_report()
    same_c = [s == a_streams[1] for s in c_streams]
    print(f"    hedged {rep_c['hedged_fetches']} ({rep_c['hedge_rebuild_wins']} rebuild wins, "
          f"{rep_c['hedge_fetch_wins']} fetch wins, {rep_c['cancelled_fetches']} fetches "
          f"cancelled); rounds 3, 4 streams == (a)'s round 2: {same_c}; (a)'s rounds 1 and 2 "
          f"equal: {a_streams[0] == a_streams[1]}")
    check(rep_c["hedged_fetches"] > 0 and rep_c["hedge_rebuild_wins"] > 0,
          f"phase 12 (c): the straggler was never hedged away: {rep_c}")
    check(all(same_c), "phase 12 (c): a hedged rebuild changed a stream")
    del mgr_b, store_b
    torch.cuda.empty_cache()

    print("  (d) 2 shards, int8 wire (the default), twice")
    d_runs = []
    for k in range(2):
        finite = []

        def decode_step(params, caches, toks, pos):
            logits, caches = type(model).decode_step(model, params, caches, toks, pos)
            finite.append(torch.isfinite(logits.float()).all())
            return logits, caches

        model.decode_step = decode_step
        before = qk.KERNEL.launches
        try:
            store_d = sharded_store("int8")
            d_streams, _, mgr_d = serve(f"(d) run {k + 1}", store_d, 2)
        finally:
            del model.decode_step
        launches = qk.KERNEL.launches - before
        dequants = mgr_d.builder.dequants
        ok = bool(torch.stack(finite).all())
        d_runs.append(d_streams)
        print(f"    run {k + 1}: quant_kv launches {launches}, dequants {dequants}, fetched "
              f"{store_d.remote_fetches} segments ({store_d.fetched_wire_bytes / 1e6:.1f} MB "
              f"wire), logits finite: {ok}")
        check(launches == dequants > 0,
              f"phase 12 (d): quant_kv launches {launches} != dequantized segments {dequants}")
        check(ok, "phase 12 (d): int8-wire logits not finite")
        del mgr_d, store_d
        torch.cuda.empty_cache()
    check(d_runs[0] == d_runs[1], "phase 12 (d): two int8-wire runs differ")
    for r in range(2):
        for i, (got, want) in enumerate(zip(d_runs[0][r], a_streams[r])):
            at = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y), None)
            if at is None:
                print(f"    (d) round {r + 1} document {i}: identical to (a)")
                continue
            eng = ServeEngine(model, params, docs[i], chunk_tokens=128, store=store_a,
                              doc_id=doc_key(docs[i]), device=dev)
            gap, top = top2_gap(single_logits(eng, SHARD_DOC_LEN, list(want), at))
            print(f"    (d) round {r + 1} document {i}: parts from (a) at token {at}; "
                  f"(a)'s top-2 gap there {gap:.4g} (largest logit {top:.4g}; not gated)")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  phase 12: two int8 runs bitwise equal: True; quant_kv launches "
          f"{qk.KERNEL.launches}; peak memory {peak / 2**30:.2f} GiB; {nvidia_smi_line()}")
    return qk.KERNEL.launches


# ---------------------------------------------------------------------------
# phases 7 and 8: the analytics engine
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


def store_reload(eng, table, family, params, rng, n, P, queries: int = 10) -> None:
    """Save the family's model store, load it back, and answer ``queries``
    more queries over each (materializing nothing): the reloaded store must
    give the live store's plans and bitwise statistics."""
    from repro_torch.core.descriptors import Range
    from repro_torch.core.engine import IncrementalAnalyticsEngine
    from repro_torch.core.store import ModelStore

    root = Path(tempfile.mkdtemp(prefix="repro_torch_smoke_"))
    try:
        t0 = time.perf_counter()
        eng.store.save(root / family)
        save_s = time.perf_counter() - t0
        snap_bytes = sum(f.stat().st_size for f in (root / family).iterdir())
        t0 = time.perf_counter()
        loaded = ModelStore.load(root / family)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(sorted(loaded._models) == sorted(eng.store._models),
          f"{family}: the reloaded model store lost models")
    live = IncrementalAnalyticsEngine(table, store=eng.store, materialize="never")
    back = IncrementalAnalyticsEngine(table, store=loaded, materialize="never")
    same = True
    for _ in range(queries):
        size = min(max(int(rng.normal(P.query_mean, P.query_std)), 1000), n - 1)
        lo = int(rng.integers(0, n - size))
        a = live.query(family, Range(lo, lo + size), **params)
        b = back.query(family, Range(lo, lo + size), **params)
        same &= plan_key(a.plan) == plan_key(b.plan) and all(
            np.array_equal(np.asarray(getattr(a.stats, f.name)),
                           np.asarray(getattr(b.stats, f.name)))
            for f in dataclasses.fields(a.stats))
    print(f"    store snapshot: {len(loaded)} models, {snap_bytes} B, save {save_s:.3f} s, "
          f"load {load_s:.3f} s; {queries} queries over the reloaded store: identical "
          f"plans and bitwise statistics: {same}")
    check(same, f"{family}: the reloaded model store answers differently")


def analytics_main_path(dev) -> dict:
    """The paper's workload through ``IncrementalAnalyticsEngine`` on the
    card, against ``baseline`` on the same queries."""
    from repro_torch.configs.paper import PAPER_WORKLOAD as P
    from repro_torch.core import linreg as core_linreg
    from repro_torch.core import logreg as core_logreg
    from repro_torch.core import naive_bayes as core_nb
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
    # count each family's statistics passes over tensors (each one kernel
    # call): linreg's, Gaussian NB's, and logreg's segment fits (an
    # uncovered step, a baseline query or a warm-up model)
    passes = {"linreg": 0, "gaussian_nb": 0, "logreg": 0}
    hooks = ((core_linreg, "compute_stats", "linreg"),
             (core_nb, "compute_gaussian_stats", "gaussian_nb"),
             (core_logreg, "fit_chunks", "logreg"))
    originals = [getattr(module, fn) for module, fn, _ in hooks]

    def counted(fn, family):
        def wrapper(X, y, *args, **kwargs):
            passes[family] += isinstance(X, torch.Tensor)
            return fn(X, y, *args, **kwargs)
        return wrapper

    for (module, fn, family), original in zip(hooks, originals):
        setattr(module, fn, counted(original, family))
    try:
        analytics_families(dev, tables, kernels, n, n_queries, P)
    finally:
        for (module, fn, _), original in zip(hooks, originals):
            setattr(module, fn, original)
    counts = {name: k.launches for name, k in kernels.items()}
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"  analytics main-path launches: {counts}; max memory allocated "
          f"{mem / 2**20:.0f} MiB (resident tables {resident / 2**20:.0f} MiB)")
    check(all(v > 0 for v in counts.values()),
          f"a statistics kernel was not launched on the analytics path: {counts}")
    for family, name in (("linreg", "linreg_stats"), ("gaussian_nb", "nb_stats"),
                         ("logreg", "logreg_sgd")):
        print(f"  {family} statistics passes over the card's tables: {passes[family]}, "
              f"{name} launches: {counts[name]} (one per pass)")
        check(counts[name] == passes[family],
              f"{name} launched other than once per {family} statistics pass")
    check(mem >= resident, "max memory allocated does not cover the resident tables")
    return counts


def analytics_families(dev, tables, kernels, n, n_queries, P) -> None:
    """Phase 8's run of each family: warm-up, queries against baseline,
    the profiler, the store's save and reload."""
    from repro_torch.core.descriptors import Range, coalesce
    from repro_torch.core.engine import IncrementalAnalyticsEngine

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
        store_reload(eng, tables[family], family, params, rng, n, P)
        print(f"    launches (warm-up, {n_queries} queries and baselines, 10 profiled "
              f"queries and baselines, 2 x 10 reload-check queries): "
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
        for line in ptxas_summary(log):
            print(f"    {stem}: {line}")

    timer = Timer(dev)
    print("[2] kernels vs plain versions on the card")
    rows = [extend_phase(dev, timer), extend_mla_phase(dev, timer),
            extend_phase(dev, timer, g=12, hd=192, cap=4160, shapes=EXTEND_SHAPES_GRID,
                         name="extend_attention_hd192"),
            extend_phase(dev, timer, g=4, hd=128, shapes=EXTEND_SHAPES_GRID,
                         name="extend_attention_g4"),
            decode_phase(dev, timer), mla_decode_phase(dev, timer),
            decode_phase(dev, timer, g=12, hd=192, name="decode_attention_hd192", pack=False),
            decode_phase(dev, timer, g=4, hd=128, name="decode_attention_g4", pack=False),
            extend_phase(dev, timer, g=1, hd=64, kv=20, cap=512, small=320, timed=(64, 448),
                         shapes=EXTEND_SHAPES_WHISPER, name="extend_attention_hd64"),
            decode_phase(dev, timer, g=1, hd=64, kv=20, shapes=DECODE_SHAPES_WHISPER,
                         name="decode_attention_hd64", pack=False),
            quant_kv_phase(dev, timer), linreg_stats_phase(dev, timer),
            nb_stats_phase(dev, timer), logreg_sgd_phase(dev, timer)]
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms")
    del timer

    from repro_torch.configs import get_config, reduced

    print("[3] reduced deepseek-67b (fp32): card vs CPU")
    reduced_parity(dev, reduced(get_config("deepseek-67b")))
    print("    reduced deepseek-67b (bf16 params and compute): card vs CPU")
    reduced_bf16_parity(dev, reduced(get_config("deepseek-67b")))
    print("    reduced deepseek-67b (fp32): SessionManager, card vs CPU")
    reduced_sessions(dev, reduced(get_config("deepseek-67b")))
    deferred_build_waits_for_nothing(dev)
    print("    reduced deepseek-67b (fp32): SessionManager over 2 shards, card vs CPU")
    reduced_sharded_sessions(dev, reduced(get_config("deepseek-67b")))
    print("    reduced deepseek-v2-236b (MLA + MoE, fp32): card vs CPU")
    reduced_parity(dev, reduced(get_config("deepseek-v2-236b")))
    print("    reduced deepseek-v2-236b (bf16 params and compute): card vs CPU")
    reduced_bf16_parity(dev, reduced(get_config("deepseek-v2-236b")))
    print("    reduced deepseek-v2-236b (fp32) with moe_groups=2: card vs CPU")
    reduced_grouped_moe(dev, reduced(get_config("deepseek-v2-236b")))
    nemotron = get_config("nemotron-4-340b")
    for label, cfg in (("reduced", reduced(nemotron)), ("reduced-wide", reduced_wide(nemotron))):
        print(f"    {label} nemotron-4-340b (squared-ReLU, G {cfg.n_heads // cfg.n_kv_heads}, "
              f"hd {cfg.head_dim}; fp32): card vs CPU")
        reduced_parity(dev, cfg)
        print(f"    {label} nemotron-4-340b (bf16 params and compute): card vs CPU")
        reduced_bf16_parity(dev, cfg)
    print("    reduced-wide nemotron-4-340b (fp32): SessionManager, card vs CPU")
    reduced_sessions(dev, reduced_wide(nemotron))
    for arch in ARCHS_8A:
        print(f"    reduced {arch} (fp32): card vs CPU")
        reduced_parity(dev, reduced(get_config(arch)))
    for arch in ("mamba2-130m", "jamba-v0.1-52b"):
        print(f"    reduced {arch} (SSD; fp32): card vs CPU")
        reduced_parity(dev, reduced(get_config(arch)))
        print(f"    reduced {arch} (bf16 params and compute): card vs CPU")
        reduced_bf16_parity(dev, reduced(get_config(arch)))
    print("    reduced jamba-v0.1-52b (fp32): SessionManager, card vs CPU")
    reduced_sessions(dev, reduced(get_config("jamba-v0.1-52b")))
    for arch in ("whisper-large-v3", "llama-3.2-vision-11b"):
        cfg = reduced(get_config(arch))
        print(f"    reduced {arch} (cross-attention; fp32): card vs CPU")
        reduced_parity(dev, cfg)
        print(f"    reduced {arch} (bf16 params and compute): card vs CPU")
        reduced_bf16_parity(dev, cfg)
        print(f"    reduced {arch} (fp32): SessionManager, card vs CPU")
        reduced_sessions(dev, cfg)
        reduced_context_isolation(dev, cfg)
    print("    reduced training (fp32): card vs CPU, make_train_step")
    for arch, opt_name in (("deepseek-67b", ""), ("deepseek-v2-236b", ""),
                           ("deepseek-v2-236b", "adafactor"), ("mamba2-130m", ""),
                           ("whisper-large-v3", "")):
        reduced_training(dev, arch, opt_name)

    print(f"[4] full-width main path ({FULL_LAYERS} layers, bf16)")
    counts, eng, ref = main_path(dev)
    print("[5] where the time goes (torch.profiler, full width)")
    where_time_goes(eng, dev)
    print(f"[6] residency at full width ({FULL_LAYERS} layers, bf16 model)")
    counts["quant_kv"] = residency_phase(eng, ref, dev)
    print(f"[9] batched serving at full width ({FULL_LAYERS} layers, bf16 model, "
          f"phase 4's store)")
    counts.update(sessions_phase(eng, dev))
    print(f"[12] sharded serving at full width ({FULL_LAYERS} layers, bf16 model, 2 "
          f"simulated shards)")
    counts["quant_kv"] += sharded_phase(eng, dev)
    del eng, ref
    torch.cuda.empty_cache()
    print(f"[10] MLA main path at full width (deepseek-v2-236b, {MLA_LAYERS} layers, bf16)")
    counts.update(mla_main_path(dev))
    torch.cuda.empty_cache()
    print(f"[11] GQA at head dim 192 at full width (nemotron-4-340b, {NEMOTRON_LAYERS} "
          f"layers, bf16)")
    counts.update(nemotron_main_path(dev))
    torch.cuda.empty_cache()
    print("[13] SSD serving at full width")
    print("  (a) mamba2-130m, 24 layers (full depth), fp32 params, bf16 compute")
    mamba_main_path(dev)
    torch.cuda.empty_cache()
    print(f"  (b) jamba-v0.1-52b, {JAMBA_LAYERS} layers, bf16")
    counts.update(jamba_main_path(dev))
    torch.cuda.empty_cache()
    print("[14] cross-attention serving at full width (bf16)")
    print("  (a) whisper-large-v3, 32 encoder + 32 decoder layers (full depth)")
    counts.update(cross_main_path(dev, "whisper-large-v3"))
    torch.cuda.empty_cache()
    print("  (b) llama-3.2-vision-11b, 40 layers (full depth, 8 cross)")
    cross_main_path(dev, "llama-3.2-vision-11b")    # G 4 / hd 128: phase 13 (b)'s rows
    torch.cuda.empty_cache()
    print("[15] training at full width")
    phase15_losses = training_phase(dev)
    print("[16] distribution: a world-size-1 NCCL mesh")
    distribution_phase(dev, phase15_losses)
    print("[17] introspection on the card: the registry, the step counter, a dry run")
    introspection_phase(dev)

    print("[7] analytics engine (200K x 10): card vs CPU")
    analytics_parity(dev)
    print("[8] analytics main path: the paper's workload on the card")
    counts.update(analytics_main_path(dev))

    sources = {
        "extend_attention": ("src/repro_torch/kernels/extend_attention/csrc/extend_attention.cu",
                             "src/repro/kernels/extend_attention/kernel.py:108"),
        "extend_attention_mla": ("src/repro_torch/kernels/extend_attention/csrc/"
                                 "extend_attention.cu",
                                 "src/repro/kernels/extend_attention/kernel.py:108"),
        "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:103"),
        "extend_attention_hd192": ("src/repro_torch/kernels/extend_attention/csrc/"
                                   "extend_attention.cu",
                                   "src/repro/kernels/extend_attention/kernel.py:108"),
        "decode_attention_hd192": ("src/repro_torch/kernels/decode_attention/csrc/"
                                   "decode_attention.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:103"),
        "extend_attention_g4": ("src/repro_torch/kernels/extend_attention/csrc/"
                                "extend_attention.cu",
                                "src/repro/kernels/extend_attention/kernel.py:108"),
        "decode_attention_g4": ("src/repro_torch/kernels/decode_attention/csrc/"
                                "decode_attention.cu",
                                "src/repro/kernels/decode_attention/kernel.py:103"),
        "extend_attention_hd64": ("src/repro_torch/kernels/extend_attention/csrc/"
                                  "extend_attention.cu",
                                  "src/repro/kernels/extend_attention/kernel.py:108"),
        "decode_attention_hd64": ("src/repro_torch/kernels/decode_attention/csrc/"
                                  "decode_attention.cu",
                                  "src/repro/kernels/decode_attention/kernel.py:103"),
        "mla_decode": ("src/repro_torch/kernels/mla_decode/csrc/mla_decode.cu",
                       "none (src/repro/models/mla.py::mla_decode is XLA)"),
        "quant_kv": ("src/repro_torch/kernels/quant_kv/csrc/quant_kv.cu",
                     "src/repro/kernels/quant_kv/kernel.py:50"),
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
    print("[profiler] sessions with a count of device activities that is not a "
          "whole number per call: " + ", ".join(
              f"{role} {partial} of {n}" for role, (n, partial) in PROFILE_SESSIONS.items()))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
