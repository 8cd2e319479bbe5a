"""Base layers: norms, MLPs, embeddings, logits and rotary embeddings
(the JAX package's ``repro.models.layers``).

Parameters are plain dicts of tensors; every apply function casts to the
compute dtype at the point of use, as the JAX package does (params are
kept in fp32).  The ``constrain`` sharding hints sit at JAX's sites: they
redistribute DTensors under a mesh and are the identity otherwise.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import annotate
from repro_torch.distributed.annotate import constrain
from repro_torch.models.config import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init helpers (scales as in the JAX package; the numbers differ, since a
# torch.Generator is not jax.random)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5
    return torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                       device=gen.device) * scale


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated silu / plain gelu)
# ---------------------------------------------------------------------------

#: Leaves of an MLP (and of a MoE FFN's experts) that every use casts to
#: the compute dtype.
MLP_LEAVES = ("wi", "wo", "wg")


def mlp_init(gen: torch.Generator, d: int, ff: int, gated: bool) -> dict:
    p = {"wi": dense_init(gen, d, ff), "wo": dense_init(gen, ff, d)}
    if gated:
        p["wg"] = dense_init(gen, d, ff)
    return p


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    h = torch.matmul(x, params["wi"].to(dt))
    if cfg.gated_mlp:
        g = torch.matmul(x, params["wg"].to(dt))
        h = _act(cfg.act)(g) * h
    else:
        h = _act(cfg.act)(h)
    h = constrain(h, *(("dp",) + (None,) * (h.dim() - 2) + ("tp",)))
    return torch.matmul(h, params["wo"].to(dt))


def _act(name: str):
    # jax.nn.gelu is the tanh form by default (approximate=True); the erf
    # form differs by up to 4e-4 on [-3, 3]
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d: int) -> dict:
    return {"table": torch.randn((vocab, d), generator=gen,
                                 dtype=torch.float32, device=gen.device)
            * 0.02}


def embed(params: dict, tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the same values as JAX's cast-then-gather, without
    # casting the whole table on every call
    table = params["table"]
    if isinstance(table, DTensor):
        out = _embed_sharded(table, tokens, cfg)
    else:
        out = table[tokens].to(cdtype(cfg))
    return constrain(out, "dp", None, None)


def _embed_sharded(table: DTensor, tokens, cfg: ModelConfig) -> DTensor:
    """The gather from a vocab-sharded table, on local shards (DTensor has
    no sharding rule for an index into a sharded dim): each ``"model"``
    rank looks up the tokens of its vocab rows and writes zeros for the
    rest, and the result is a partial sum over ``"model"`` (each token's
    row comes from one rank).  The table's FSDP dim is gathered over the
    data axes first (ZeRO-3's all-gather), and each data rank looks up its
    own batch rows, so the table's gradient is partial there."""
    mesh = table.device_mesh
    on = annotate.plan(mesh, tokens.shape[0], table.shape[0])
    local = table.redistribute(
        mesh, annotate.local_placements(mesh, False, on[1], None, 0)
    ).to_local(grad_placements=annotate.local_placements(
        mesh, *on, None, 0, partial_batch=True))
    rows_pl = annotate.local_placements(mesh, on[0], False, 0)
    tok = annotate.to_mesh(tokens, mesh).redistribute(
        mesh, rows_pl).to_local().long()
    if on[1]:
        rows = local.shape[0]
        idx = tok - mesh.get_local_rank("model") * rows
        hit = (idx >= 0) & (idx < rows)
        got = local[idx.clamp(0, rows - 1)]
        out = torch.where(hit[..., None], got, got.new_zeros(()))
    else:
        out = local[tok]
    return DTensor.from_local(
        out.to(cdtype(cfg)), mesh,
        annotate.local_placements(mesh, *on, 0, partial_chan=True),
        run_check=False)


def logits(params_head: torch.Tensor, x: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """``params_head``: the lm head table ``[vocab, d]`` (may be the tied
    embedding table).  fp32 logits over the padded vocab; the product runs
    in full fp32 (it is not a TF32 product unless the caller turns
    ``torch.backends.cuda.matmul.allow_tf32`` on, which the port never
    does)."""
    x = constrain(x, *(("dp",) + (None,) * (x.dim() - 1)))
    out = torch.matmul(x.to(torch.float32),
                       params_head.to(torch.float32).t())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = torch.tanh(out / c) * c
    return constrain(out, *(("dp",) + (None,) * (out.dim() - 2) + ("tp",)))


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """The half-split form.  ``x``: ``[B, S, H, D]``; ``positions``: int
    ``[B, S]`` (absolute).  The angles are fp32; cos and sin are cast to
    ``x``'s dtype before the products, as in the JAX package."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs   # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
