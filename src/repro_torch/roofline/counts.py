"""What one device does in a traced step, counted at the dispatcher: the
port's counterpart of what the JAX package's ``roofline/hlo_flops.py``
reads out of compiled HLO, with the same return shapes.

``Counts`` is one dispatch mode with three counters:

* ``dot_flops()``: ``{"flops", "dot_ops"}``, the products that
  ``torch.utils.flop_counter.FlopCounterMode`` counts (its formula table,
  the scan's included: ``kernels.ops`` registers it), op by op as that mode
  counts them (an op it would decompose is decomposed here too);
* ``traffic_bytes()``: ``{"bytes"}``, each op's operand and result bytes;
  an op that only makes a view of its input (``view``, ``transpose``,
  ``wait_tensor``) or only allocates (``empty``) moves nothing, and a
  hand-written kernel, one operator of its own, counts once with its
  inputs and outputs, as XLA's fusion-aware count counts a fusion;
* ``collective_bytes()``: ``{kind: {"bytes", "count", "seconds"},
  "total_bytes"}`` with JAX's kind names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``; another
  collective, such as a broadcast, under its own op name), each
  collective's operand bytes as JAX counts them, and its seconds over the
  links of its group (``constants.link_bw`` of the group's size).  Counted
  at the functional collectives (``_c10d_functional``, what DTensor
  issues) and the process-group ops (``c10d``, what
  ``all_gather_object`` issues), so a backend's own fallback inside one
  (the fake backend runs an all-to-all as an all-gather) is not counted.

Per device: a DTensor op is not counted itself.  The mode hands it to
DTensor (``NotImplemented``, as ``CommDebugMode`` does), which runs it as
ops on this rank's local shards and as collectives, and those are
counted: work replicated over a mesh axis counts whole on every device, as
in JAX's partitioned module.  DTensor's sharding propagation runs the op
once more on fake tensors of the global shapes to learn the output's
shape; those ops are not counted (``propagation_marked``), nor are ops on
``meta`` tensors (shapes only).  A plain tensor op counts as it is.
"""

from __future__ import annotations

import contextlib
import threading
import types

import torch
import torch.utils.flop_counter as flop_counter
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline import constants

# collective op name (namespace-free, overload-free) -> JAX's kind name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "send_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")
# process-group ops that take (outputs, inputs): the operand is the second
_OUTPUT_FIRST = {"allgather_", "_allgather_base_",
                 "allgather_into_tensor_coalesced_", "reduce_scatter_",
                 "_reduce_scatter_base_", "reduce_scatter_tensor_coalesced_",
                 "alltoall_", "alltoall_base_"}
# ops of those namespaces that move nothing
_NOT_COLLECTIVES = {"wait_tensor", "barrier", "monitored_barrier"}

# ops that report a tensor's metadata: no work (FlopCounterMode's list)
_METADATA = {torch.ops.prim.device.default, torch.ops.prim.layout.default,
             torch.ops.aten.is_contiguous.default,
             torch.ops.aten.size.default, torch.ops.aten.stride.default,
             torch.ops.aten.numel.default, torch.ops.aten.dim.default,
             torch.ops.aten.storage_offset.default}

_TLS = threading.local()
_marks = {"depth": 0, "restore": []}
_marks_lock = threading.Lock()


def propagating() -> bool:
    """True on a thread inside DTensor's sharding propagation."""
    return getattr(_TLS, "propagating", 0) > 0


def _marked(fn):
    def run(*args, **kwargs):
        _TLS.propagating = getattr(_TLS, "propagating", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _TLS.propagating -= 1
    return run


# ShardingPropagator's methods that run ops on fake tensors of the global
# shapes (the output's shape, or a decomposition's strategy): torch 2.11
# runs a decomposition inside propagate_op_sharding_non_cached, 2.13 also
# in propagate
_PROPAGATION = ("propagate", "propagate_op_sharding_non_cached",
                "_propagate_tensor_meta", "_propagate_tensor_meta_non_cached")


@contextlib.contextmanager
def propagation_marked():
    """Mark DTensor's sharding propagation (``_PROPAGATION``, the methods
    that run ops on fake tensors of the global shapes) for
    :func:`propagating`, for the ``with`` block; the marks nest and are
    taken off when the last block ends.  These methods are private to
    torch: those of them that this torch defines as plain functions are
    wrapped, and one at least must be."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    with _marks_lock:
        if _marks["depth"] == 0:
            names = [n for n in _PROPAGATION if isinstance(
                vars(ShardingPropagator).get(n), types.FunctionType)]
            if not names:
                raise RuntimeError("this torch's ShardingPropagator has none "
                                   "of the methods the counters mark")
            for n in names:
                real = vars(ShardingPropagator)[n]
                _marks["restore"].append((n, real))
                setattr(ShardingPropagator, n, _marked(real))
        _marks["depth"] += 1
    try:
        yield
    finally:
        with _marks_lock:
            _marks["depth"] -= 1
            if _marks["depth"] == 0:
                for n, real in _marks["restore"]:
                    setattr(ShardingPropagator, n, real)
                _marks["restore"].clear()


def tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of args or results; a DTensor as its local
    shard."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, DTensor):
            out.append(x._local_tensor)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LocalOps(TorchDispatchMode):
    """A dispatch mode that sees the ops one device runs: DTensor ops are
    handed to DTensor, whose local ops and collectives come back here, and
    the ops of DTensor's sharding propagation are run but not shown.
    Subclasses take each op in :meth:`on_op` after it ran."""

    def __enter__(self):
        marks = propagation_marked()
        marks.__enter__()
        self.__dict__.setdefault("_marks", []).append(marks)
        try:
            return super().__enter__()
        except BaseException:
            self._marks.pop().__exit__(None, None, None)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marks.pop().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if propagating() or func in _METADATA or _waits(func) or \
                _on_meta(args, kwargs):
            return func(*args, **kwargs)
        if func._overloadpacket not in flop_counter.flop_registry:
            # as FlopCounterMode: an op with a decomposition counts as it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.on_op(func, args, kwargs, out)
        return out

    def on_op(self, func, args, kwargs, out) -> None:
        raise NotImplementedError


def _on_meta(args, kwargs) -> bool:
    """Every tensor argument is a ``meta`` tensor (a shape, with no data:
    no device runs the op), and there is one; an op with no tensor
    argument (a factory) is judged by its ``device`` argument."""
    ts = tensors((args, kwargs))
    if ts:
        return all(t.device.type == "meta" for t in ts)
    dev = kwargs.get("device")
    return dev is not None and torch.device(dev).type == "meta"


def _waits(func) -> bool:
    """A wait on a collective, or a barrier: it moves and makes nothing
    (on fake tensors a wait returns a new tensor, on real ones its
    input)."""
    ns, _, base = func._schema.name.partition("::")
    return ns in _COLLECTIVE_NAMESPACES and base in _NOT_COLLECTIVES


def returns_alias(func, *, written: bool = True) -> bool:
    """Every result of the op aliases an input (a view, an in-place op, a
    wait on a collective): it makes no storage.  With ``written=False``
    only results that the op does not write count (views)."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and (written or not r.alias_info.is_write)
        for r in rets)


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective runs on: a functional
    collective names it by its last string argument, a process-group op
    passes it (boxed as a script object at the dispatcher)."""
    from torch.distributed.distributed_c10d import (ProcessGroup,
                                                    _resolve_process_group)
    vals = list(args) + list(kwargs.values())
    for a in vals:
        if isinstance(a, torch.ScriptObject):
            a = ProcessGroup.unbox(a)
        if isinstance(a, ProcessGroup):
            return a.size()
    names = [a for a in vals if isinstance(a, str)]
    if names:
        return _resolve_process_group(names[-1]).size()
    raise ValueError(f"{func}: no process group among its arguments")


class Counts(LocalOps):
    """FLOPs, traffic and collectives of one device over the ``with``
    block (the module's docstring says how each is counted)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.dot_ops = 0
        self.bytes = 0
        self.collectives: dict[str, dict] = {}

    def on_op(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in flop_counter.flop_registry:
            f = flop_counter.flop_registry[packet](*args, **kwargs,
                                                   out_val=out)
            self.flops += int(f)
            self.dot_ops += bool(f)
        ns, _, base = func._schema.name.partition("::")
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVES.get(base, base)
            operand = sum(nbytes(t) for t in tensors(
                args[1] if base in _OUTPUT_FIRST else args[0]))
            c = self.collectives.setdefault(
                kind, {"bytes": 0, "count": 0, "seconds": 0.0})
            c["bytes"] += operand
            c["count"] += 1
            c["seconds"] += operand / constants.link_bw(
                _group_size(func, args, kwargs))
        if returns_alias(func, written=False) or "empty" in base:
            return
        self.bytes += sum(nbytes(t) for t in tensors((args, kwargs))) + \
            sum(nbytes(t) for t in tensors(out))

    def dot_flops(self) -> dict:
        return {"flops": float(self.flops), "dot_ops": self.dot_ops}

    def traffic_bytes(self) -> dict:
        return {"bytes": float(self.bytes)}

    def collective_bytes(self) -> dict:
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        return out

    def collective_seconds(self) -> float:
        return float(sum(v["seconds"] for v in self.collectives.values()))
