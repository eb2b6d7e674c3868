"""Multi-pod train step: data-parallel ranks on a ``pod`` × ``data`` device
mesh, with an EF-int8 gradient exchange over the pod dimension.

The counterpart of ``repro.distributed.multipod``.  Cross-pod links are
~an order of magnitude slower than intra-pod links, so the pod dimension
carries int8 payloads with error feedback (the residual rides in ``ef``,
one fp32 tree per rank) and the data dimension an fp32 all-reduce.

Every rank holds the whole parameter and optimizer state.  The step takes
the global batch and keeps its own rows: the pod's shard first, split into
the microbatches, then each microbatch split over ``data``, so microbatch
``i`` on every rank is that rank's slice of the pod's microbatch ``i``.
On top of ``train.loop.make_train_step`` (local microbatch sum divided by
``k``), its ``grad_transform``:

  1. all-reduces the gradients to their mean over ``data`` (fp32);
  2. exchanges them over ``pod``: ``compressed_mean`` leaf by leaf when
     compressed, an fp32 mean otherwise;

then the step clips, takes the learning rate and updates, as on one
device.  ``metrics["loss"]`` is the mean over pod and data.

Tensor parallelism over a ``model`` dimension is ``repro``'s GSPMD and has
no counterpart here: a mesh whose ``model`` dimension is larger than 1 is
refused.

Memory: gradients are exchanged in place of the fp32 gradient sum, and each
leaf's new residual is written over its ``ef`` leaf before the next leaf,
so the exchange holds one leaf's temporaries at a time.  Parameters and
optimizer state are written only after every gradient is exchanged; a
failure once the first residual is written raises ``UpdateInterrupted``
(the ``ef`` tree is then part updated), which is never retried.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves
from repro_torch.train.loop import UpdateInterrupted, make_train_step
from repro_torch.train.optim import Optimizer, make_optimizer, warmup_cosine

from .compression import compressed_mean, ef_state_like

#: the process-group backend of a mesh's device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _dim(mesh, name: str):
    """(size, coordinate of this rank, process group) of mesh dimension
    ``name``; a dimension the mesh lacks is (1, 0, None)."""
    if name not in mesh.mesh_dim_names:
        return 1, 0, None
    sub = mesh[name]
    return sub.size(), sub.get_local_rank(), sub.get_group()


def local_batch(batch: dict, mesh, microbatches: int) -> dict:
    """This rank's rows of the global ``batch``: the pod's shard, then per
    microbatch this ``data`` coordinate's slice, concatenated in
    microbatch order (so ``make_train_step``'s split gives them back)."""
    n_pod, pod, _ = _dim(mesh, "pod")
    n_data, data, _ = _dim(mesh, "data")
    k = microbatches

    def rows(x):
        b = x.shape[0]
        if b % (n_pod * k * n_data):
            raise ValueError(f"a batch of {b} rows does not split over {n_pod} pods x "
                             f"{k} microbatches x {n_data} data ranks")
        shard = x[pod * (b // n_pod):(pod + 1) * (b // n_pod)]
        m = shard.shape[0] // k
        per = m // n_data
        mbs = shard.reshape(k, m, *x.shape[1:])[:, data * per:(data + 1) * per]
        return mbs.reshape(k * per, *x.shape[1:])

    return {kk: rows(v) for kk, v in batch.items()}


def _mean_(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """``x`` replaced in place by its mean over ``group`` (``n`` ranks; a
    dimension the mesh lacks has no group and leaves ``x`` as it is)."""
    if group is not None:
        dist.all_reduce(x, group=group)
        x.div_(n)
    return x


def make_multipod_train_step(
    model,
    mesh,
    optimizer: Optional[Optimizer] = None,
    *,
    schedule: Optional[Callable] = None,
    microbatches: Optional[int] = None,
    max_grad_norm: float = 1.0,
    compress: bool = True,
):
    """``(step_fn, optimizer)`` with ``step_fn(params, opt_state, ef, batch,
    step) → (params, opt_state, ef, metrics)``; params, optimizer state and
    ``ef`` are updated in place.  ``mesh`` is a ``DeviceMesh`` with a
    ``pod`` dimension (``data`` optional, ``model`` of size 1) whose
    process group has its device type's backend (:data:`BACKENDS`)."""
    names = mesh.mesh_dim_names or ()
    if "pod" not in names:
        raise ValueError(f"the multipod step needs a 'pod' mesh dimension; mesh has {names}")
    if "model" in names and mesh["model"].size() > 1:
        raise NotImplementedError(
            "tensor parallelism over the 'model' mesh dimension is not ported (repro "
            "leaves it to GSPMD); use a mesh whose 'model' dimension has size 1")
    want = BACKENDS[mesh.device_type]
    for name in ("pod", "data"):
        _, _, pg = _dim(mesh, name)
        if pg is not None and dist.get_backend(pg) != want:
            raise ValueError(f"mesh dimension {name!r} runs on backend "
                             f"{dist.get_backend(pg)!r}; a {mesh.device_type} mesh needs "
                             f"{want!r}")
    cfg = model.cfg
    opt = optimizer if optimizer is not None else make_optimizer(cfg.optimizer)
    sched = schedule if schedule is not None else warmup_cosine(3e-4, 200, 10_000)
    k = microbatches if microbatches is not None else cfg.train_microbatches
    n_pod, _, pod_pg = _dim(mesh, "pod")
    n_data, _, data_pg = _dim(mesh, "data")

    def step_fn(params, opt_state, ef, batch, step):
        def exchange(grads):
            for g in tree_leaves(grads):
                _mean_(g, n_data, data_pg)
            if not compress:
                for g in tree_leaves(grads):
                    _mean_(g, n_pod, pod_pg)
                return grads
            written = False
            try:
                for g, e in zip(tree_leaves(grads), tree_leaves(ef)):
                    mean, new_ef = compressed_mean(g, e, pod_pg)
                    written = True
                    e.copy_(new_ef)
                    g.copy_(mean)
                    del mean, new_ef
            except Exception as exc:
                if written:
                    raise UpdateInterrupted(
                        f"the pod exchange of step {step} failed after it began "
                        f"writing the error-feedback state") from exc
                raise
            return grads

        train_step, _ = make_train_step(model, opt, schedule=sched, microbatches=k,
                                        max_grad_norm=max_grad_norm,
                                        grad_transform=exchange)
        params, opt_state, metrics = train_step(params, opt_state,
                                                local_batch(batch, mesh, k), step)
        metrics["loss"] = _mean_(_mean_(metrics["loss"], n_data, data_pg), n_pod, pod_pg)
        return params, opt_state, ef, metrics

    return step_fn, opt


def ef_init(params):
    """fp32 zeros shaped like every parameter: the error-feedback state."""
    return ef_state_like(params)
