"""Train step and loop: microbatched gradient accumulation, clipping,
metrics, and an outer loop that retries a failed step and cuts checkpoints.

The counterpart of ``repro.train.loop``.  ``make_train_step`` returns
``train_step(params, opt_state, batch, step) -> (params, opt_state,
metrics)`` over the functional parameter tree: gradients come from
``torch.autograd.grad`` over the tree's leaves (no ``nn.Parameter``, no
``.grad`` fields), one microbatch after another into an fp32 sum.

``repro``'s jitted step is atomic (its donated buffers are replaced when it
returns); this one updates parameters and optimizer state in place, after
every gradient is computed.  A failure before that first write leaves the
inputs untouched and the loop retries the step; a failure during the
update raises :class:`UpdateInterrupted`, which is never retried, since
the state is then half updated.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import KEEP, local_region
from repro_torch.models.common import tree_leaves, tree_unflatten

from .optim import Optimizer, clip_scale, global_norm, make_optimizer, warmup_cosine


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


class UpdateInterrupted(RuntimeError):
    """The optimizer update failed after it began writing parameters or
    optimizer state in place: the step cannot be retried from them."""


def _split_microbatches(batch: dict, k: int) -> dict:
    """Each entry (b, ...) as (p, b/p, ...), pass i's rows at index i.

    On plain tensors p = k and rows [i·b/k, (i+1)·b/k) form microbatch i.
    In a sharded program no row moves: a rank holding r rows runs p =
    gcd(k, r) passes, pass i its i-th p-th of its rows.  When p < k the
    batch shards form k/p groups of consecutive ranks and a pass runs k/p
    microbatches side by side, one a group, each as many rows as on plain
    tensors (rank r of n holds rows [r·b/n, (r+1)·b/n))."""
    def re(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch of {b} rows does not split into {k} microbatches")
        return _split_region(x, k=k)

    return {kk: re(v) for kk, v in batch.items()}


def passes(rows: int, k: int) -> int:
    """Passes of a step over ``k`` microbatches when a rank holds ``rows``
    rows (the rank's rows split evenly, no row computed twice)."""
    return math.gcd(rows, k)


def _split_rows(x, *, k: int):
    b = x.shape[0]
    p = passes(b, k)
    return x.reshape(p, b // p, *x.shape[1:])


def _behind_microbatch(ins):
    """The rows' layout, one dimension down (behind the microbatch axis)."""
    return tuple(type(p)(p.dim + 1) if p.is_shard() else p for p in ins[0])


_split_region = local_region(_split_rows, (KEEP,), (_behind_microbatch,))


def _side_by_side(model, g: int):
    """``model`` over a pass of ``g`` microbatches side by side: the MoE
    routes each microbatch's tokens as its own groups (``moe_groups`` × g;
    a pass's loss is then the mean of its microbatches' losses)."""
    lm = copy.copy(model)
    lm.cfg = model.cfg.replace(moe_groups=model.cfg.moe_groups * g)
    return lm


def make_train_step(
    model,
    optimizer: Optional[Optimizer] = None,
    *,
    schedule: Optional[Callable] = None,
    microbatches: Optional[int] = None,
    max_grad_norm: float = 1.0,
    grad_transform: Optional[Callable] = None,
):
    """Build the train step for an LM; returns ``(train_step, optimizer)``.

    ``batch`` holds tensors on the parameters' device (``tokens``,
    ``targets`` and a cross stack's context features).  The step sums each
    microbatch's gradients in fp32, divides by their number, applies
    ``grad_transform(grads) -> grads`` (the distribution layer's hook),
    clips to ``max_grad_norm``, takes the schedule's learning rate and
    updates; ``metrics`` holds ``loss`` (the microbatches' mean),
    ``grad_norm`` (before clipping) and ``lr`` as 0-d tensors.
    """
    cfg: ArchConfig = model.cfg
    opt = optimizer if optimizer is not None else make_optimizer(cfg.optimizer)
    sched = schedule if schedule is not None else warmup_cosine(3e-4, 200, 10_000)
    k = microbatches if microbatches is not None else cfg.train_microbatches

    def train_step(params, opt_state, batch, step):
        leaves = tree_leaves(params)
        gsum = [torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        mbs = _split_microbatches(batch, k)
        n = next(iter(mbs.values())).shape[0]
        lm = model if n == k else _side_by_side(model, k // n)
        for i in range(n):
            live = [p.detach().requires_grad_() for p in leaves]
            loss, _ = lm.loss_fn(tree_unflatten(params, live),
                                 {kk: v[i] for kk, v in mbs.items()})
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            for a, g in zip(gsum, grads):
                if g is not None:
                    a.add_(g)
            lsum = lsum + loss.detach()
            del live, loss, grads     # one pass's gradients alive at a time
        for a in gsum:
            a.div_(n)
        grads = tree_unflatten(params, gsum)
        if grad_transform is not None:
            grads = grad_transform(grads)
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, max_grad_norm)
        for g in tree_leaves(grads):
            g.mul_(scale)
        lr = sched(step)
        try:
            params, opt_state = opt.update(grads, opt_state, params, lr)
        except Exception as exc:
            raise UpdateInterrupted(f"optimizer update of step {step} failed") from exc
        return params, opt_state, {"loss": lsum / n, "grad_norm": gnorm, "lr": lr}

    return train_step, opt


def train_loop(
    model,
    batches,
    *,
    steps: int,
    seed: int = 0,
    checkpoint_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    on_metrics: Optional[Callable] = None,
    max_retries: int = 2,
    microbatches: Optional[int] = None,
    schedule: Optional[Callable] = None,
):
    """Single-device training loop with retry-on-transient-failure.

    ``batches`` is an iterator of batch dicts on the model's device.
    Parameters are drawn by ``model.init`` from a ``torch.Generator`` on
    the model's device seeded with ``seed``.  A step that raises before
    its first write is retried up to ``max_retries`` times; each history
    entry holds the step's metrics as floats, ``step``, and ``retries``,
    the failed attempts before it succeeded.  Checkpoints are cut
    asynchronously every ``checkpoint_every`` steps and at the end.
    """
    from .checkpoint import AsyncCheckpointer

    train_step, opt = make_train_step(model, microbatches=microbatches,
                                      schedule=schedule)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    params = model.init(gen)
    opt_state = opt.init(params)

    ckpt = AsyncCheckpointer(checkpoint_dir) if checkpoint_dir else None
    history = []
    step = 0
    it = iter(batches)
    while step < steps:
        batch = next(it)
        attempt = 0
        while True:
            try:
                params, opt_state, metrics = train_step(params, opt_state, batch, step)
                break
            except UpdateInterrupted:
                raise
            except Exception:
                attempt += 1
                if attempt > max_retries:
                    raise
        m = {k: float(v) for k, v in metrics.items()}
        m["step"] = step
        m["retries"] = attempt
        history.append(m)
        if on_metrics:
            on_metrics(m)
        if ckpt and checkpoint_every and (step + 1) % checkpoint_every == 0:
            ckpt.save(step + 1, {"params": params, "opt_state": opt_state})
        step += 1
    if ckpt:
        ckpt.save(step, {"params": params, "opt_state": opt_state})
        ckpt.wait()
    return TrainState(params=params, opt_state=opt_state, step=step), history
