"""Sharding rules: tree path -> partition spec (the JAX package's
``repro.distributed.partition``).

Strategy (Megatron-style TP + ZeRO-3 FSDP, both expressed as 2D weight
sharding):

* "model" axis: attention heads / FFN hidden / expert dim / vocab,
* FSDP axes (= the data axes): the other large dim of every matrix,
  so parameters + optimizer state scale with the full rank count,
* vectors (norm scales, biases) replicate.

KV caches shard sequence slots over "model" (GQA kv_heads of 8 do not
divide a 16-wide model axis, so head sharding is not generally available).

A spec is a tuple with JAX's ``PartitionSpec`` entries, entry for entry:
each an axis name, a tuple of two or more names, or None (a spec may be shorter than
the tensor's rank; the missing dims replicate).  The rules are pure
functions of the leaf's path and rank, the config and the mesh's axis
names and sizes, so they run on an ``AbstractMesh`` (no world needed) as
well as on a ``DeviceMesh``.  ``placements`` turns a spec into DTensor
placements on a mesh, one a mesh dim.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_map, tree_map_with_path

def Spec(entries=()) -> tuple:
    """A spec from its entries, normalized as JAX's ``PartitionSpec``
    normalizes them: a one-name tuple is the name, an empty one None."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 None if isinstance(e, tuple) and not e else e
                 for e in entries)


class AbstractMesh(NamedTuple):
    """A mesh's axis names and sizes, with no devices behind it."""
    shape_tuple: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape_tuple))


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or an
    ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    # sizes, not ``mesh.mesh``: newer torch builds that tensor anew, which
    # a fake-tensor trace (the dry run's) cannot take
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh_axes(mesh)["model"]


def param_spec(path_str: str, ndim: int, cfg: ModelConfig, mesh, *,
               fsdp: bool = True) -> tuple:
    """The spec of one parameter leaf (``path_str`` as JAX writes it:
    ``"blocks/p0/mixer/wq"``)."""
    da = data_axes(mesh) if fsdp else ()
    f = da if da else None      # fsdp axes (possibly ('pod','data'))
    name = path_str.rsplit("/", 1)[-1]
    stacked = path_str.startswith(("blocks/", "enc_blocks/"))
    nm = model_axis_size(mesh)

    def spec(*dims):
        dims = (None,) * (ndim - len(dims)) + tuple(dims) \
            if len(dims) < ndim else tuple(dims)
        if stacked:
            dims = (None,) + dims[1:] if len(dims) == ndim else dims
        return Spec(dims)

    base = ndim - (1 if stacked else 0)   # logical rank

    # ---- vectors: replicate
    if base <= 1:
        return spec(*([None] * ndim))

    if name in ("wq", "wk", "wv"):
        return spec(*([None] * (ndim - 2)), f, "model")
    if name == "wo" and "ffn" not in path_str:
        return spec(*([None] * (ndim - 2)), "model", f)
    if name == "table" or path_str.endswith("head"):
        return Spec(("model", f))         # [vocab, d], never stacked
    if name == "router":
        return spec(*([None] * (ndim - 2)), f, None)
    if name in ("wi", "wg", "wo") and base == 3:  # MoE experts [E, d/ff, *]
        e_ok = cfg.moe_experts and cfg.moe_experts % nm == 0
        if name == "wo":
            return spec("model" if e_ok else None,
                        None if e_ok else "model", f)
        return spec("model" if e_ok else None, f,
                    None if e_ok else "model")
    if name in ("wi", "wg"):              # dense MLP [d, ff]
        return spec(*([None] * (ndim - 2)), f, "model")
    if name == "wo":                      # dense MLP out [ff, d]
        return spec(*([None] * (ndim - 2)), "model", f)
    # ---- mamba
    if name == "in_proj":
        return spec(f, "model")
    if name == "out_proj":
        return spec("model", f)
    if name == "conv_w":
        return spec(None, "model")
    if name == "x_proj":
        return spec("model", None)
    if name == "dt_w":
        return spec(None, "model")
    if name == "A_log":
        return spec("model", None)
    if name == "proj":                    # frontend adapter [d, d]
        return spec(f, None)
    return spec(*([None] * ndim))


def param_specs(abstract_params, cfg: ModelConfig, mesh, *,
                fsdp: bool = True):
    """A tree of specs matching a (``meta``) param tree."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf.dim(), cfg, mesh,
                                      fsdp=fsdp), abstract_params)


class NamedSharding(NamedTuple):
    """A ``DeviceMesh`` and one DTensor placement a mesh dim (the role of
    JAX's ``NamedSharding``)."""
    mesh: object
    placements: tuple


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim that names a tensor dim (two mesh dims may shard one tensor
    dim, in mesh order, as JAX's ``("pod", "data")``), ``Replicate()`` on
    the rest."""
    out = []
    for axis in mesh_axes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def named_sharding(mesh, spec: tuple) -> NamedSharding:
    return NamedSharding(mesh, placements(spec, mesh))


def param_shardings(abstract_params, cfg: ModelConfig, mesh, *,
                    fsdp: bool = True):
    return map_specs(lambda s: named_sharding(mesh, s),
                     param_specs(abstract_params, cfg, mesh, fsdp=fsdp))


def is_spec(node) -> bool:
    """A spec (a plain tuple) or a ``NamedSharding``: a leaf of a spec or
    sharding tree."""
    return type(node) is tuple or isinstance(node, NamedSharding)


def map_specs(fn, tree):
    """``fn`` over a tree whose leaves are specs or shardings, keeping its
    dicts, lists and named tuples."""
    return tree_map(fn, tree, is_leaf=is_spec)


def place(tree, shardings):
    """``tree`` placed by ``shardings`` (a tree of ``NamedSharding``s of
    its structure; a None leaf of ``shardings`` leaves its leaf as it is).
    A plain tensor is distributed from the mesh's first rank (the others'
    values are not read, their shapes and dtypes must agree),
    on the mesh's device type; a DTensor is redistributed, or kept when it
    is placed already.  A collective: every rank calls it, in the same
    order."""
    def one(t, sh):
        if sh is None:
            return t
        if isinstance(t, DTensor):
            if tuple(t.placements) == tuple(sh.placements):
                return t
            return t.redistribute(sh.mesh, sh.placements)
        t = torch.as_tensor(t).to(sh.mesh.device_type)
        return distribute_tensor(t, sh.mesh, sh.placements,
                                 src_data_rank=0)
    return tree_map(one, tree, shardings)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def _n_data(mesh) -> int:
    axes = mesh_axes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= axes[a]
    return n


def batch_spec(mesh, batch_size: int) -> tuple:
    """Leading-axis spec for input batches."""
    if batch_size % _n_data(mesh) == 0:
        return Spec((data_axes(mesh),))
    return Spec((None,))


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's, or the first item of a ``(shape,
    dtype)`` pair (``train_step.make_batch_struct``'s leaves)."""
    return tuple(leaf[0]) if isinstance(leaf, tuple) else tuple(leaf.shape)


def batch_specs(batch_tree: dict, mesh) -> dict:
    return {k: Spec(batch_spec(mesh, _shape(v)[0]) +
                    (None,) * (len(_shape(v)) - 1))
            for k, v in batch_tree.items()}


def cache_specs(abstract_cache, mesh, batch_size: int):
    """KV caches: batch over data axes when divisible; sequence slots over
    "model" (plus the data axes too when the batch is unshardable, e.g.
    the 524k-token batch-1 long-context cell)."""
    da = data_axes(mesh)
    batch_ok = batch_size % _n_data(mesh) == 0
    b_ax = da if batch_ok else None
    s_ax = "model" if batch_ok else tuple(list(da) + ["model"])

    def one(path, leaf):
        name = path.rsplit("/", 1)[-1]
        nd = leaf.dim()
        if name in ("k", "v"):      # [*, B, slots, Hkv, hd]
            return Spec((None,) * (nd - 4) + (b_ax, s_ax, None, None))
        if name == "pos":           # [*, B, slots]
            return Spec((None,) * (nd - 2) + (b_ax, s_ax))
        if name == "conv":          # [*, B, w-1, d_inner]
            return Spec((None,) * (nd - 3) + (b_ax, None, "model"))
        if name == "ssm":           # [*, B, d_inner, d_state]
            return Spec((None,) * (nd - 3) + (b_ax, "model", None))
        return Spec(())
    return tree_map_with_path(one, abstract_cache)
