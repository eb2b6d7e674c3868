"""Multi-pod train step: data-parallel ranks on a ``pod`` × ``data`` device
mesh, with an EF-int8 gradient exchange over the pod dimension, and tensor
parallelism over ``model`` as the sharded program.

The counterpart of ``repro.distributed.multipod``.  Cross-pod links are
~an order of magnitude slower than intra-pod links, so the pod dimension
carries int8 payloads with error feedback (the residual rides in ``ef``,
one fp32 tree per rank) and the data dimension an fp32 all-reduce.

The step takes the global batch and keeps the pod's rows.  Parameters,
optimizer state and ``ef`` come in one of two forms:

* **Plain tensors** (the mesh's ``model`` dimension, if any, of size 1):
  every rank holds the whole state.  A rank keeps its own rows: the pod's
  shard split into the microbatches, then each microbatch split over
  ``data``, so microbatch ``i`` on every rank is that rank's slice of the
  pod's microbatch ``i``.  On top of ``train.loop.make_train_step`` (local
  microbatch sum divided by ``k``), its ``grad_transform`` all-reduces the
  gradients to their mean over ``data`` (fp32), then exchanges them over
  ``pod``.  ``metrics["loss"]`` is the mean over pod and data.
* **``DTensor`` s** on the ``data`` × ``model`` sub-mesh, the same on every
  pod, as ``repro`` leaves ``data`` and ``model`` to GSPMD inside a
  ``shard_map`` over ``pod``: the caller activates
  ``use_rules(strip_axis(rules, "pod"), mesh["data", "model"])``, and the
  step runs ``make_train_step`` as that sharded program over the pod's rows
  (a plain batch leaf is sliced to them; a ``DTensor`` one, laid out on the
  whole mesh with its rows over ``pod``, gives its local rows).  The
  gradient reaching the exchange is each leaf's mean over the pod's rows,
  laid out as its parameter; the exchange works on each rank's shard: the
  int8 scale comes from the leaf's maximum over every ``data`` and
  ``model`` shard, so the codes are the whole leaf's, and only the shard's
  codes and one fp32 scale cross ``pod``.  ``metrics["loss"]`` is the mean
  over pod.

The exchange over ``pod`` is ``compressed_mean`` leaf by leaf when
compressed, an fp32 mean otherwise; then the step clips (the global norm
over every shard), takes the learning rate and updates, as on one device.

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
from torch.distributed.tensor import DTensor

from repro_torch.models.common import contiguous_strides, tree_leaves
from repro_torch.train.loop import UpdateInterrupted, make_train_step
from repro_torch.train.optim import Optimizer, make_optimizer, warmup_cosine

from .compression import compressed_mean, ef_state_like, shard_of
from .sharding import active, place

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


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s value as a plain tensor (a 0-d metric), or ``x``."""
    return x.full_tensor() if isinstance(x, DTensor) else x


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
    ``pod`` dimension (``data`` and ``model`` optional) whose process group
    has its device type's backend (:data:`BACKENDS`); see the module
    docstring for the two forms of the state."""
    names = mesh.mesh_dim_names or ()
    if "pod" not in names:
        raise ValueError(f"the multipod step needs a 'pod' mesh dimension; mesh has {names}")
    want = BACKENDS[mesh.device_type]
    for name in ("pod", "data", "model"):
        _, _, pg = _dim(mesh, name)
        if pg is not None and dist.get_backend(pg) not in (want, "fake"):
            raise ValueError(f"mesh dimension {name!r} runs on backend "
                             f"{dist.get_backend(pg)!r}; a {mesh.device_type} mesh needs "
                             f"{want!r}")
    cfg = model.cfg
    opt = optimizer if optimizer is not None else make_optimizer(cfg.optimizer)
    sched = schedule if schedule is not None else warmup_cosine(3e-4, 200, 10_000)
    k = microbatches if microbatches is not None else cfg.train_microbatches
    n_pod, pod, pod_pg = _dim(mesh, "pod")
    n_data, _, data_pg = _dim(mesh, "data")
    n_model = _dim(mesh, "model")[0]

    def exchange(ef, step, over_data: bool):
        """The ``grad_transform``: each gradient leaf (a rank's shard of a
        ``DTensor`` one) replaced in place by its mean over ``data`` (plain
        state: each rank's rows give a partial mean) and then over ``pod``;
        compressed, ``ef`` takes the new residuals."""
        def transform(grads):
            leaves = tree_leaves(grads)
            if over_data:
                for g in leaves:
                    _mean_(g, n_data, data_pg)
            if not compress:
                for g in leaves:
                    _mean_(shard_of(g)[0], n_pod, pod_pg)
                return grads
            written = False
            try:
                for g, e in zip(leaves, tree_leaves(ef)):
                    (g, max_over), e = shard_of(g), shard_of(e)[0]
                    mean, new_ef = compressed_mean(g, e, pod_pg, max_over)
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

        return transform

    def pod_rows(x, rules, sub):
        """The pod's rows of batch leaf ``x`` on the sub-mesh ``sub``."""
        if isinstance(x, DTensor):       # rows over pod (and data) on the whole mesh
            dims = x.device_mesh.mesh_dim_names
            if not x.placements[dims.index("pod")].is_shard(0):
                raise ValueError("a DTensor batch leaf must have its rows sharded over 'pod'")
            pl = [q for name, q in zip(dims, x.placements) if name != "pod"]
            shape = (x.shape[0] // n_pod,) + tuple(x.shape[1:])
            return DTensor.from_local(shard_of(x)[0], sub, pl, run_check=False,
                                      shape=torch.Size(shape), stride=contiguous_strides(shape))
        b = x.shape[0]
        if b % n_pod:
            raise ValueError(f"a batch of {b} rows does not split over {n_pod} pods")
        rows = x[pod * (b // n_pod):(pod + 1) * (b // n_pod)]
        return place(rows, ("batch",) + (None,) * (x.ndim - 1), rules, sub)

    def step_fn(params, opt_state, ef, batch, step):
        sharded = any(isinstance(p, DTensor) for p in tree_leaves(params))
        if sharded:
            if active() is None:
                raise ValueError("DTensor parameters need the sharded program's rules: "
                                 "use_rules(strip_axis(rules, 'pod'), mesh['data', 'model'])")
            rows = {kk: pod_rows(v, *active()) for kk, v in batch.items()}
        elif n_model > 1:
            raise ValueError("a 'model' mesh dimension larger than 1 needs DTensor parameters "
                             "on mesh['data', 'model'] (tensor parallelism runs as the "
                             "sharded program)")
        else:
            rows = local_batch(batch, mesh, k)
        # the sharded program's gradient sum is laid out as the parameters
        # (``make_train_step``): the mean over the pod's rows, no partial sum
        train_step, _ = make_train_step(model, opt, schedule=sched, microbatches=k,
                                        max_grad_norm=max_grad_norm,
                                        grad_transform=exchange(ef, step, not sharded))
        params, opt_state, metrics = train_step(params, opt_state, rows, step)
        loss = _whole(metrics["loss"])
        if not sharded:
            loss = _mean_(loss, n_data, data_pg)
        metrics = {"loss": _mean_(loss, n_pod, pod_pg),
                   "grad_norm": _whole(metrics["grad_norm"]), "lr": metrics["lr"]}
        return params, opt_state, ef, metrics

    return step_fn, opt


def ef_init(params):
    """fp32 zeros shaped like every parameter (laid out like a ``DTensor``
    parameter): the error-feedback state."""
    return ef_state_like(params)
