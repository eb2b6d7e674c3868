"""Per-device cost of a step, counted by running it eagerly.

The counterpart of ``repro.launch.hlo_analysis``.  ``repro`` reads the
cost of a step from its compiled, SPMD-partitioned HLO; the port has no
compiled program, so :class:`OpCounter` runs the step (on real tensors, or
on fake ones under a ``FakeTensorMode``, which allocates nothing) and
counts every ATen op it dispatches:

* ``flops``: ``torch.utils.flop_counter``'s formula of each op, with its
  decompositions, so that with no mesh the count equals
  ``FlopCounterMode``'s;
* ``op_bytes``: 2 × the bytes each op writes (write + one later read), the
  proxy of ``hlo_analysis``'s ``_fusion_bytes`` but per **unfused** eager
  op: it is not ``fusion_bytes`` and runs higher than it (a view writes
  nothing; an in-place op writes its whole output);
* ``collective_bytes`` and ``collective_by_kind``: every
  ``_c10d_functional`` / ``c10d`` collective with ``parse_collectives``'
  ring multipliers (all-reduce 2 × the result, reduce-scatter the operand,
  the rest the result).

**Per device.**  On ``DTensor`` s the counter steps aside
(``NotImplemented``) and counts the local ops that ``DTensor`` then runs on
one rank's shards, never the global op, and it skips the global-shape ops
that ``DTensor``'s sharding propagation runs to learn output shapes.  A CPU
mesh has no all-to-all, so ``DTensor`` runs an all-gather and keeps a chunk
where it asked for one; such an all-gather is counted as the all-to-all it
stands for (the all-to-all's result: the operand's bytes).

**Kernels.**  A kernel wrapper (``kernels/*/ops.py``) declares the FLOPs
and bytes of one call from its arguments; while it runs, the counter adds
them and counts none of its inner ops, on the card (a ``ctypes`` launch
that no dispatch mode sees) and on the CPU (its plain version) alike.  A
wrapper's formula gives the FLOPs ``FlopCounterMode`` counts in its plain
version.  Outside a counter a wrapper pays one thread-local read for this.

``memory=True`` also follows the bytes of the storages that the ops make
(their sum while alive, and its peak): an **eager** peak, op after op,
which is not XLA's ``temp_size_in_bytes`` (XLA fuses, schedules and reuses
buffers).
"""
from __future__ import annotations

import sys
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.common import WORK

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute", "broadcast")

#: ops that ask a tensor about itself (``FlopCounterMode`` passes them by)
_META_OPS = {torch.ops.aten.is_contiguous.default, torch.ops.aten.is_contiguous.memory_format,
             torch.ops.aten.is_strides_like_format.default,
             torch.ops.aten.is_non_overlapping_and_dense.default,
             torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
             torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
             torch.ops.aten.storage_offset.default, torch.ops.aten.sym_storage_offset.default,
             torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
             torch.ops.aten.dim.default, torch.ops.prim.layout.default}
for _name in ("sym_is_contiguous",):
    if hasattr(torch.ops.aten, _name):
        _META_OPS.add(getattr(torch.ops.aten, _name).default)

#: products whose operands must share a dtype (a fake tensor does not check)
_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}

_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
_PORT = "/repro_torch/"
#: the autograd node running now (None outside a backward pass)
_current_node = getattr(torch._C, "_current_autograd_node", lambda: None)
_SELF = __file__


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _collective_kind(name: str):
    n = name.replace("_", "")
    for kind, keys in (("all-reduce", ("allreduce",)), ("all-gather", ("allgather",)),
                       ("reduce-scatter", ("reducescatter",)),
                       ("all-to-all", ("alltoall",)), ("broadcast", ("broadcast",)),
                       ("collective-permute", ("send", "recv"))):
        if any(k in n for k in keys):
            return kind
    return None


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched in its context; see the module docstring.
    :meth:`result` gives the totals, :meth:`top_contributors` the largest
    entries by code path."""

    supports_higher_order_operators = True

    def __init__(self, *, memory: bool = False):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0
        self.coll = defaultdict(float)
        self.coll_count = defaultdict(int)
        self.kernels: dict = defaultdict(lambda: {"calls": 0, "flops": 0, "bytes": 0})
        # flops, bytes, coll, ops, and a collective's operand bytes (what a rank sends)
        self.by_path: dict = defaultdict(lambda: [0.0, 0.0, 0.0, 0, 0.0])
        self._in_kernel = 0
        self._labels: dict = {}
        self.memory = memory
        self.live = 0
        self.peak = 0
        self._storages: dict = {}

    # -- context ---------------------------------------------------------
    def __enter__(self):
        self._prev_work = getattr(WORK, "counter", None)
        WORK.counter = self
        return super().__enter__()

    def __exit__(self, *exc):
        WORK.counter = self._prev_work
        return super().__exit__(*exc)

    # -- kernels -----------------------------------------------------------
    def kernel(self, name: str, work, fn, *args, **kwargs):
        """Run kernel wrapper body ``fn(*args, **kwargs)``, counting
        ``work(*args, **kwargs) = (flops, bytes)`` for it and nothing that
        it dispatches (a wrapper inside another adds nothing)."""
        if self._in_kernel:
            return fn(*args, **kwargs)
        self._in_kernel += 1
        try:
            flops, nbytes = (int(n) for n in work(*args, **kwargs))
        finally:
            self._in_kernel -= 1
        k = self.kernels[name]
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.op_bytes += 2 * nbytes
        rec = self.by_path[(self._label(sys._getframe(1)), f"kernel:{name}")]
        rec[0] += flops
        rec[1] += 2 * nbytes
        rec[3] += 1
        self._in_kernel += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._in_kernel -= 1

    # -- attribution -------------------------------------------------------
    def _label(self, frame) -> str:
        """The chain of the port's functions on the stack, outermost first
        (``lm.forward>attention.self_attention>…``); in a backward pass the
        autograd node's name follows it."""
        codes = []
        f = frame
        while f is not None:
            co = f.f_code
            if _PORT in co.co_filename and co.co_filename != _SELF:
                codes.append(co)
            f = f.f_back
        key = tuple(codes)
        lab = self._labels.get(key)
        if lab is None:
            parts = []
            for co in reversed(codes):
                mod = co.co_filename.rsplit("/", 1)[-1][:-3]
                parts.append(f"{mod}.{co.co_name}")
            lab = self._labels[key] = ">".join(parts) or "<outside the port>"
        node = _current_node()
        return lab if node is None else f"{lab}>backward:{node.name()}"

    @staticmethod
    def _context(frame):
        """(inside DTensor's sharding propagation, inside its CPU all-to-all
        fallback) for the op dispatched under ``frame``."""
        f = frame
        a2a = False
        while f is not None:
            co = f.f_code
            if co.co_filename.endswith("_sharding_prop.py"):
                return True, a2a
            if co.co_name == "shard_dim_alltoall":
                a2a = True
            f = f.f_back
        return False, a2a

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented           # let DTensor run its local ops
        if func in _META_OPS or self._in_kernel:
            return func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return NotImplemented
        frame = sys._getframe(1)
        shadow, a2a = self._context(frame)
        if shadow:                          # global-shape metadata only
            return func(*args, **kwargs)
        if func not in flop_registry and func._overloadpacket not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        if func in _PRODUCTS:
            dts = {t.dtype for t in _tensors(list(args))}
            if len(dts) > 1:
                raise TypeError(f"{func} of mixed dtypes {sorted(map(str, dts))}: the "
                                f"card would refuse it")
        out = func(*args, **kwargs)
        label = self._label(frame)
        rec = self.by_path[(label, str(func._overloadpacket))]
        rec[3] += 1
        ns = func.namespace
        if ns in _COLLECTIVE_NS:
            self._collective(func, args, out, a2a, rec)
            return out
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            n = int(f(*args, **kwargs, out_val=out))
            self.flops += n
            rec[0] += n
        written = self._written(func, out)
        self.op_bytes += 2 * written
        rec[1] += 2 * written
        return out

    def _written(self, func, out) -> int:
        """Bytes ``func`` wrote: its outputs, less those that are views of
        an input; new storages are followed for the memory peak."""
        total = 0
        rets = func._schema.returns
        for i, t in enumerate(_tensors(out)):
            alias = rets[min(i, len(rets) - 1)].alias_info if rets else None
            if alias is not None and not alias.is_write:
                continue                    # a view
            total += t.numel() * t.element_size()
            if self.memory and alias is None:
                self._track(t)
        return total

    def _track(self, t):
        """Follow a new storage.  The counter holds it, so a storage whose
        use count has fallen to 1 is dead; the dead are dropped only when
        the live sum could pass the peak, so the peak is exact.  (Holding
        storages keeps real memory until then: meant for fake tensors.)"""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = (st, n)
        self.live += n
        if self.live > self.peak:
            dead = [k for k, (s, _) in self._storages.items()
                    if torch._C._storage_Use_Count(k) <= 1]
            for k in dead:
                self.live -= self._storages.pop(k)[1]
            self.peak = max(self.peak, self.live)

    def _collective(self, func, args, out, a2a: bool, rec):
        name = func._schema.name.split("::")[-1]
        if "wait" in name:
            return
        kind = _collective_kind(name)
        if kind is None:
            return
        ins = [t for a in args for t in _tensors(a)]
        result_b = _nbytes(out)
        if func.namespace == "c10d":
            # (outputs, inputs, ...) or (tensors, ...): the result is the
            # first tensor argument, the operand the last
            result_b = _nbytes(args[0])
            operand_b = _nbytes(args[1]) if len(args) > 1 and _tensors(args[1]) else result_b
        else:
            operand_b = _nbytes(ins[0]) if ins else result_b
        if a2a and kind == "all-gather":
            kind, wire = "all-to-all", float(operand_b)
        elif kind == "all-reduce":
            wire = 2.0 * result_b
        elif kind == "reduce-scatter":
            wire = float(operand_b)
        else:
            wire = float(result_b)
        self.coll[kind] += wire
        self.coll_count[kind] += 1
        rec[2] += wire
        rec[4] += operand_b

    # -- results -------------------------------------------------------------
    def result(self) -> dict:
        """``analyze_hlo``'s keys (``fusion_bytes`` becomes ``op_bytes``),
        the collective counts and each kernel's calls, FLOPs and bytes."""
        out = {
            "flops": float(self.flops),
            "collective_bytes": float(sum(self.coll.values())),
            "collective_by_kind": dict(self.coll),
            "collective_count": dict(self.coll_count),
            "op_bytes": float(self.op_bytes),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }
        if self.memory:
            out["peak_bytes"] = int(self.peak)
        return out

    def collectives_in(self, fn: str) -> dict:
        """Kind → (count, result bytes, operand bytes) of the collectives
        dispatched under the port's function ``fn`` (``"module.name"``, as
        in a code path)."""
        out: dict = {}
        for (path, op), rec in self.by_path.items():
            kind = _collective_kind(op.rsplit(".", 1)[-1])
            if kind is None or rec[2] == 0 or fn not in path.split(">"):
                continue
            n, res, sent = out.get(kind, (0, 0.0, 0.0))
            out[kind] = (n + rec[3], res + rec[2], sent + rec[4])
        return out

    def top_contributors(self, n: int = 15, metric: str = "hbm") -> list:
        """Largest (value, op, code path, calls) entries; ``metric`` is
        ``"hbm"`` (``op_bytes``), ``"flops"`` or ``"coll"``."""
        col = {"flops": 0, "hbm": 1, "coll": 2}[metric]
        rows = [(v[col], op, path, v[3]) for (path, op), v in self.by_path.items() if v[col] > 0]
        rows.sort(key=lambda r: -r[0])
        return rows[:n]


def analyze(fn, *args, memory: bool = False, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter`; its
    :meth:`~OpCounter.result` (``analyze_hlo``'s counterpart)."""
    with OpCounter(memory=memory) as c:
        fn(*args, **kwargs)
    return c.result()
