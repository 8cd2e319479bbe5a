"""Serving steps: batched prefill and single-token decode, on one device or
over a ``DeviceMesh`` with sharded KV caches (the JAX package's
``repro.serving.serve_step``; sequence-slot sharding, see
``distributed/partition.py``).

``shard_prefill`` and ``shard_decode_step`` return JAX's tuples: a callable
and the structs of its inputs (on the ``meta`` device).  The callable
places plain-tensor params, caches and tokens by ``partition``'s specs
(rank 0's values distributed; DTensors already placed are kept), runs the
step on DTensors under the mesh's annotations and returns DTensors placed
as JAX's ``out_shardings`` place its outputs.  Every rank calls it.
``fn.param_shardings`` places the params once ahead of many calls
(``partition.place``).
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.distributed import annotate, partition
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_map
from repro_torch.training.train_step import mesh_context


def serve_decode_step(params, cache, tokens, pos, enc_out=None, *,
                      cfg: ModelConfig, mesh=None, greedy: bool = True):
    """One new token for every sequence in the batch against a KV cache.
    Returns ``(next_tokens [B, 1] int32, logits [B, 1, V], cache)``."""
    with mesh_context(mesh), torch.no_grad():
        logits, cache = model.decode_step(params, cache, tokens, pos, cfg,
                                          enc_out=enc_out)
        nxt = annotate.greedy(logits).to(torch.int32)
        return nxt, logits, cache


def serve_prefill(params, batch, *, cfg: ModelConfig, max_len: int,
                  mesh=None):
    """Prefill ``batch`` into a new cache of ``max_len``.  Returns
    ``(next_tokens [B, 1] int32, cache, pos [B, 1])``."""
    with mesh_context(mesh), torch.no_grad():
        logit, cache, pos = model.prefill(params, batch, cfg, max_len)
        nxt = annotate.greedy(logit)[:, None].to(torch.int32)
        return nxt, cache, pos


def _on_meta(fn):
    """The tree ``fn()`` builds on the CPU, traced with fake tensors, as
    ``meta`` tensors (no allocation)."""
    with FakeTensorMode():
        fake = fn()
    return tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                          device="meta"), fake)


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16):
    """Serving params are bf16 (no optimizer state): every fp32 leaf of
    two or more dimensions in ``dtype``."""
    p = _on_meta(lambda: model.init(0, cfg, device="cpu"))
    return tree_map(lambda a: torch.empty(
        a.shape, dtype=dtype if a.dtype == torch.float32 and a.dim() >= 2
        else a.dtype, device="meta"), p)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    return _on_meta(lambda: model.init_cache(cfg, batch, max_len,
                                             torch.bfloat16, device="cpu"))


def make_prefill_batch_struct(cfg: ModelConfig, batch: int,
                              seq: int) -> dict:
    """``(shape, dtype)`` of each tensor of one prefill batch."""
    out = {}
    if cfg.frontend == "vision":
        out["tokens"] = ((batch, seq - cfg.frontend_len), torch.int32)
        out["patches"] = ((batch, cfg.frontend_len, cfg.d_model),
                          torch.bfloat16)
    else:
        out["tokens"] = ((batch, seq), torch.int32)
    if cfg.enc_dec:
        out["frames"] = ((batch, seq, cfg.d_model), torch.bfloat16)
    return out


def _shardings(mesh, specs):
    return partition.map_specs(lambda s: partition.named_sharding(mesh, s),
                               specs)


def _placed_like(tree, shardings):
    """Outputs placed as JAX's ``out_shardings``: each DTensor leaf
    redistributed to its sharding."""
    def one(t, sh):
        if isinstance(t, DTensor):
            return t.redistribute(sh.mesh, sh.placements)
        return t
    return tree_map(one, tree, shardings)


def shard_decode_step(cfg: ModelConfig, mesh, batch: int, cache_len: int, *,
                      fsdp: bool = False):
    """Build the decode step and its abstract inputs for ``mesh``:
    ``(fn, params_struct, cache_struct, tok_struct, pos_struct,
    enc_struct)``, as JAX's.  ``fn(params, cache, tokens, pos[, enc_out])
    -> (next_tokens, logits, cache)``.  ``cache_len`` is the KV-cache
    length."""
    params_struct = abstract_params(cfg)
    cache_struct = abstract_cache(cfg, batch, cache_len)
    pspecs = partition.param_specs(params_struct, cfg, mesh, fsdp=fsdp)
    cspecs = partition.cache_specs(cache_struct, mesh, batch)
    bspec = partition.batch_spec(mesh, batch)
    tok_struct = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    pos_struct = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    tspec = bspec + (None,)
    enc_struct = None
    if cfg.enc_dec:  # whisper: decoder cross-attends 1500 encoder frames
        enc_struct = torch.empty((batch, 1500, cfg.d_model),
                                 dtype=torch.bfloat16, device="meta")
    psh, csh = _shardings(mesh, pspecs), _shardings(mesh, cspecs)
    tsh = partition.named_sharding(mesh, tspec)
    esh = partition.named_sharding(mesh, bspec + (None, None))

    def fn(params, cache, tokens, pos, enc_out=None):
        params = partition.place(params, psh)
        cache = partition.place(cache, csh)
        tokens, pos = partition.place(tokens, tsh), partition.place(pos, tsh)
        if enc_out is not None:
            enc_out = partition.place(enc_out, esh)
        nxt, logits, cache = serve_decode_step(
            params, cache, tokens, pos, enc_out, cfg=cfg, mesh=mesh)
        return (_placed_like(nxt, tsh), _placed_like(logits, esh),
                _placed_like(cache, csh))

    fn.param_shardings = psh
    return fn, params_struct, cache_struct, tok_struct, pos_struct, \
        enc_struct


def shard_prefill(cfg: ModelConfig, mesh, batch: int, seq: int, *,
                  max_len: int | None = None, fsdp: bool = False):
    """Build the prefill step for ``mesh``: ``(fn, params_struct,
    batch_struct)``, as JAX's.  ``fn(params, batch) -> (next_tokens,
    cache, pos)``."""
    max_len = max_len or seq
    params_struct = abstract_params(cfg)
    pspecs = partition.param_specs(params_struct, cfg, mesh, fsdp=fsdp)
    batch_struct = make_prefill_batch_struct(cfg, batch, seq)
    bspecs = partition.batch_specs(batch_struct, mesh)
    cache_struct = abstract_cache(cfg, batch, max_len)
    cspecs = partition.cache_specs(cache_struct, mesh, batch)
    bspec = partition.batch_spec(mesh, batch)
    psh, csh = _shardings(mesh, pspecs), _shardings(mesh, cspecs)
    bsh = _shardings(mesh, bspecs)
    tsh = partition.named_sharding(mesh, bspec + (None,))

    def fn(params, batch):
        params = partition.place(params, psh)
        batch = partition.place(batch, {k: bsh[k] for k in batch})
        nxt, cache, pos = serve_prefill(params, batch, cfg=cfg,
                                        max_len=max_len, mesh=mesh)
        return (_placed_like(nxt, tsh), _placed_like(cache, csh),
                _placed_like(pos, tsh))

    fn.param_shardings = psh
    return fn, params_struct, batch_struct
