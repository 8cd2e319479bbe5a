"""Base layers: norms, embeddings and logits (the JAX package's
``repro.models.layers``).

Parameters are plain dicts of tensors; every apply function casts to the
compute dtype at the point of use, as the JAX package does (params are
kept in fp32).  JAX's ``constrain`` sharding hints are left out: on one
card they are the identity.  ``mlp`` and ``rope`` wait for the attention
archs (ROADMAP A12).
"""

from __future__ import annotations

import torch

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


def embed_init(gen: torch.Generator, vocab: int, d: int) -> dict:
    return {"table": torch.randn((vocab, d), generator=gen,
                                 dtype=torch.float32, device=gen.device)
            * 0.02}


def embed(params: dict, tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the same values as JAX's cast-then-gather, without
    # casting the whole table on every call
    return params["table"][tokens].to(cdtype(cfg))


def logits(params_head: torch.Tensor, x: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """``params_head``: the lm head table ``[vocab, d]`` (may be the tied
    embedding table).  fp32 logits over the padded vocab; the product runs
    in full fp32 (it is not a TF32 product unless the caller turns
    ``torch.backends.cuda.matmul.allow_tf32`` on, which the port never
    does)."""
    out = torch.matmul(x.to(torch.float32),
                       params_head.to(torch.float32).t())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = torch.tanh(out / c) * c
    return out
