"""int8 gradient all-reduce with error feedback (bandwidth-bound DP sync;
the JAX package's ``repro.distributed.grad_compress``).

A fp32 ring all-reduce moves ~2x the gradient bytes per rank.  This module
implements the compressed equivalent with explicit collectives over one
mesh axis's process group:

  1. quantize the local gradient to int8 (per-tensor max-abs scale),
     carrying the quantization residual into the next step (error
     feedback, which keeps SGD/Adam convergence),
  2. reduce-scatter the int8 payload (``all_to_all_single`` + local int32
     sum),
  3. re-quantize the reduced shard and all-gather int8.

Bytes on the wire: ~ 2 * size / 4 -- a true 4x reduction vs fp32.
Offered as an opt-in for pure-DP meshes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.convert import tree_leaves, tree_map


def quantize(x: torch.Tensor, err: torch.Tensor):
    """``(q int8, scale, new_err)`` with the error-feedback residual."""
    y = x + err
    scale = torch.max(torch.abs(y)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    new_err = y - q.to(torch.float32) * scale
    return q, scale, new_err


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def _compressed_mean_1d(x: torch.Tensor, err: torch.Tensor, group, n: int):
    """``x``: this rank's fp32 ``[d]`` (d divisible by n).  Returns
    ``(mean, new_err)``."""
    q, scale, new_err = quantize(x, err)
    d = x.shape[0]
    # reduce-scatter: each peer receives one shard of everyone's q
    qs = torch.empty((n, d // n), dtype=torch.int8, device=x.device)
    dist.all_to_all_single(qs, q.reshape(n, d // n).contiguous(),
                           group=group)
    scales = _all_gather(scale, group, n)                  # [n]
    # qs: [n, d//n] = peer-major rows of my shard
    part = (qs.to(torch.int32).reshape(n, -1).to(torch.float32)
            * scales[:, None]).sum(0) / n                   # fp32 [d//n]
    # requantize the reduced shard and all-gather
    pscale = torch.max(torch.abs(part)) / 127.0 + 1e-12
    pq = torch.clamp(torch.round(part / pscale), -127, 127).to(torch.int8)
    full_q = _all_gather(pq, group, n)                      # [n, d//n]
    full_s = _all_gather(pscale, group, n)                  # [n]
    mean = (full_q.to(torch.float32) * full_s[:, None]).reshape(d)
    return mean, new_err


def compressed_grad_mean(grads, err_tree, mesh, axis_name: str):
    """Mean the per-rank gradient tree across ``axis_name`` of ``mesh``
    with int8 compression + error feedback.  Returns ``(mean_grads,
    new_err_tree)``.  A collective: every rank of the axis calls it."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)

    def one(x, e):
        d = x.numel()
        pad = (-d) % n
        xf = torch.nn.functional.pad(x.reshape(-1).to(torch.float32),
                                     (0, pad))
        ef = torch.nn.functional.pad(e.reshape(-1).to(torch.float32),
                                     (0, pad))
        m, ne = _compressed_mean_1d(xf, ef, group, n)
        return m[:d].reshape(x.shape).to(x.dtype), ne[:d].reshape(x.shape)

    pairs = tree_map(one, grads, err_tree)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def wire_bytes_fp32(grads) -> int:
    """Ring all-reduce cost of the uncompressed baseline (per rank)."""
    total = sum(g.numel() for g in tree_leaves(grads))
    return 2 * 4 * total


def wire_bytes_compressed(grads) -> int:
    total = sum(g.numel() for g in tree_leaves(grads))
    return 2 * total  # int8 payloads (scales negligible)
