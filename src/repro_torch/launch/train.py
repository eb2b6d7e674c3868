"""Training entry point of the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b --reduced \
      --steps 200 --batch 16 --seq 128 --ckpt-dir /tmp/ckpt

runs on the CUDA device; ``--device cpu`` runs the same path on the CPU.
The flags are those of ``python -m repro.launch.train`` plus ``--device``,
and the printed lines keep its wording.  A cross-attention stack trains
over ``repro``'s stub context, zero encoder frames or image patches.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.launch import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs the "
                         "same path on the CPU)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import lm_pipeline
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import LM
    from repro_torch.train.loop import train_loop
    from repro_torch.train.optim import warmup_cosine

    device = resolve_device(args.device, "repro_torch.launch.train")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = LM(cfg, device=device)
    pipe = lm_pipeline(cfg.vocab_size, batch=args.batch, seq=args.seq,
                       n_shards=min(4, args.batch), seed=args.seed,
                       hedge_deadline_s=5.0)

    def to_dev(b):
        out = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        if cfg.encoder_layers:
            out["enc_feats"] = torch.zeros(
                (args.batch, cfg.encoder_context, cfg.d_model), device=device)
        if cfg.vision_context:
            out["image_embeds"] = torch.zeros(
                (args.batch, cfg.vision_context, cfg.d_model), device=device)
        return out

    batches = (to_dev(b) for b in pipe)
    history = []

    def on_metrics(m):
        history.append(m)
        if m["step"] % 10 == 0:
            print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}")

    state, hist = train_loop(
        model,
        batches,
        steps=args.steps,
        seed=args.seed,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir or None,
        on_metrics=on_metrics,
        microbatches=args.microbatches or None,
        schedule=warmup_cosine(args.lr, args.warmup, args.steps),
    )
    pipe.close()
    print(f"done: loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f} "
          f"({args.steps} steps, {sum(x.numel() for x in tree_leaves(state.params)):,} params)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(hist, f)


if __name__ == "__main__":
    main()
