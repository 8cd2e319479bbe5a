"""Logical sharding annotations for model code (the JAX package's
``repro.distributed.annotate``).

Model code stays mesh-agnostic: it calls ``constrain(x, "dp", None, "tp")``
with *logical* axes.  When a mesh context is active (set by the step
builders) and ``x`` is a ``DTensor``, this redistributes ``x`` to those
axes on the concrete mesh; otherwise it returns ``x`` as it is (every
single-device path).

``constrain`` is divisibility-aware: a logical axis that does not divide
the corresponding dimension is dropped (e.g. gemma3's 8 heads on a 16-wide
model axis, or batch=1 on the data axes) -- the constraint degrades to
replication instead of erroring.

``local_placements`` writes out the placements of a region that runs on
local shards (the ops without a DTensor rule, or whose rule would gather
more than they need): batch rows over the data axes and one channel dim
over "model", each where it divides.
"""

from __future__ import annotations

import contextlib
import threading

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed import partition

_TLS = threading.local()


def _ctx():
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def mesh_annotations(mesh):
    old = _ctx()
    _TLS.ctx = {"mesh": mesh, "dp": partition.data_axes(mesh)}
    try:
        yield
    finally:
        _TLS.ctx = old


@contextlib.contextmanager
def replicate_plain_tensors():
    """Plain tensors met by DTensor ops inside count as replicated (the
    positions, masks and zeros model code makes), as
    ``torch.distributed.tensor.experimental.implicit_replication`` has
    them, with the setting before restored on exit (that one clears it),
    so that the context nests."""
    dispatcher = DTensor._op_dispatcher
    old = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = old


@contextlib.contextmanager
def _restored(ctx):
    old = _ctx()
    _TLS.ctx = ctx
    try:
        with replicate_plain_tensors() if ctx is not None \
                else contextlib.nullcontext():
            yield
    finally:
        _TLS.ctx = old


def checkpoint_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the forward as it
    runs, and its recompute -- which runs in the backward, on the
    autograd engine's thread for CUDA tensors, where this module's
    thread-local context is not set -- under the forward's mesh
    annotations."""
    return contextlib.nullcontext(), _restored(_ctx())


def active() -> bool:
    return _ctx() is not None


def axis_size(logical: str) -> int:
    c = _ctx()
    if c is None:
        return 1
    axes = partition.mesh_axes(c["mesh"])
    if logical == "tp":
        return axes["model"]
    if logical == "dp":
        n = 1
        for a in c["dp"]:
            n *= axes[a]
        return n
    return 1


def spec_of(shape, axes) -> tuple:
    """The mesh spec of logical ``axes`` ("dp" | "tp" | None, one a dim)
    for a tensor of ``shape`` under the active mesh (JAX's rule)."""
    c = _ctx()
    n_tp = axis_size("tp")
    spec = []
    for dim, a in zip(shape, axes):
        if a is None:
            spec.append(None)
        elif a == "tp":
            spec.append("model" if dim % n_tp == 0 else None)
        elif a == "dp":
            n = axis_size("dp")
            spec.append(c["dp"] if (n and dim % n == 0 and c["dp"])
                        else None)
        else:
            raise ValueError(a)
    return partition.Spec(spec)


def constrain(x, *axes):
    """axes: one logical entry per dim: "dp" | "tp" | None."""
    c = _ctx()
    if c is None or not isinstance(x, DTensor):
        return x
    assert len(axes) == x.dim(), (axes, x.shape)
    return x.redistribute(x.device_mesh, partition.placements(
        spec_of(x.shape, axes), c["mesh"]))


def plan(mesh, batch: int, channels: int | None = None) -> tuple[bool, bool]:
    """Whether a region of ``batch`` rows and ``channels`` channels shards
    its rows over the data axes and its channels over "model" on
    ``mesh``: each where it divides (None channels: never)."""
    sizes = partition.mesh_axes(mesh)
    n_data = math.prod(sizes[a] for a in partition.data_axes(mesh))
    by_chan = channels is not None and "model" in sizes and \
        channels % sizes["model"] == 0
    return batch % n_data == 0, by_chan


def local_placements(mesh, by_batch: bool, by_chan: bool, batch_dim=None,
                     chan_dim=None, *, partial_batch: bool = False,
                     partial_chan: bool = False) -> tuple:
    """One placement a mesh dim: ``Shard(batch_dim)`` on the data axes
    (``Partial()`` with ``partial_batch``; a None dim replicates) when
    ``by_batch``, ``Shard(chan_dim)`` on "model" (``Partial()`` with
    ``partial_chan``) when ``by_chan``, ``Replicate()`` elsewhere."""
    def one(on, dim, partial):
        if not on:
            return Replicate()
        if partial:
            return Partial()
        return Replicate() if dim is None else Shard(dim)

    data = partition.data_axes(mesh)
    return tuple(one(by_batch, batch_dim, partial_batch) if n in data else
                 one(by_chan, chan_dim, partial_chan) if n == "model" else
                 Replicate() for n in partition.mesh_axes(mesh))


def to_mesh(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor (the same on every
    rank) as replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def greedy(logits):
    """``torch.argmax(logits, dim=-1)`` (the first index of the largest
    value), for a DTensor whose last dim is sharded over one mesh dim as
    a region on local shards: each rank takes its shard's largest value
    and its global index, the pairs are gathered over that mesh dim (a
    few bytes a row, as XLA's reduction of an argmax moves) and the first
    largest wins.  DTensor's own argmax rule for a sharded dim reads its
    shard offsets back to the host, which a fake-tensor trace (the dry
    run's) cannot.  A plain tensor, or a DTensor whose last dim is whole,
    takes ``torch.argmax``."""
    last = logits.dim() - 1
    if not isinstance(logits, DTensor):
        return torch.argmax(logits, dim=-1)
    pl = list(logits.placements)
    on = [i for i, p in enumerate(pl) if p.is_shard(last)]
    if len(on) != 1 or any(p.is_partial() for p in pl):
        return torch.argmax(logits, dim=-1)
    mesh, (i,) = logits.device_mesh, on
    local = logits.to_local()
    chunk = -(-logits.shape[-1] // mesh.size(i))
    if local.shape[-1]:
        idx = torch.argmax(local, dim=-1, keepdim=True)
        val = torch.gather(local, -1, idx).float()
    else:   # the shard past the end of an uneven split
        idx = local.new_zeros(local.shape[:-1] + (1,), dtype=torch.int64)
        val = local.new_full(local.shape[:-1] + (1,), float("-inf"),
                             dtype=torch.float32)
    idx = idx + mesh.get_coordinate()[i] * chunk
    whole = list(pl)
    whole[i] = Replicate()
    gathered = [DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
        mesh, whole).to_local() for t in (val, idx)]
    best = torch.argmax(gathered[0], dim=-1, keepdim=True)
    pick = torch.gather(gathered[1], -1, best)[..., 0]
    return DTensor.from_local(pick, mesh, [
        Replicate() if j == i else p for j, p in enumerate(pl)],
        run_check=False)
