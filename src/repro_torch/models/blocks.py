"""One block: mixer + FFN, pre-norm residual wiring (the JAX package's
``repro.models.blocks``):

    x = x + mixer(norm1(x))
    x = x + ffn(norm2(x))      # skipped when the arch has no FFN (mamba-1)

The port runs Mamba blocks without an FFN (falcon-mamba).  Attention
mixers, dense and MoE FFNs and cross attention raise
``NotImplementedError``: they wait for the next model slice (ROADMAP A12).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers, mamba
from repro_torch.models.config import ModelConfig


def _is_moe(cfg: ModelConfig, pos: int) -> bool:
    return bool(cfg.moe_experts and cfg.moe_positions and
                cfg.moe_positions[pos % cfg.period])


def _has_ffn(cfg: ModelConfig, pos: int) -> bool:
    return _is_moe(cfg, pos) or cfg.d_ff > 0


def check_supported(cfg: ModelConfig, pos: int, *, cross: bool = False):
    """Raise ``NotImplementedError`` for a block the port cannot run yet."""
    kind = cfg.pattern[pos % cfg.period]
    missing = []
    if kind != "mamba":
        missing.append(f"{kind!r} mixers")
    if _has_ffn(cfg, pos):
        missing.append("MoE FFNs" if _is_moe(cfg, pos) else "dense FFNs")
    if cross:
        missing.append("cross attention")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} are not ported yet (ROADMAP "
            "A12); the port runs Mamba blocks without an FFN")


def block_init(gen: torch.Generator, cfg: ModelConfig, pos: int, *,
               cross: bool = False) -> dict:
    check_supported(cfg, pos, cross=cross)
    return {"norm1": layers.rmsnorm_init(cfg.d_model, gen.device),
            "mixer": mamba.mamba_init(gen, cfg)}


def block_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, pos: int,
                  positions):
    """Full-sequence path.  Returns ``(x, aux_loss)``."""
    check_supported(cfg, pos)
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps)
    return x + mamba.mamba_forward(params["mixer"], h, cfg), 0.0


def block_cache_init(cfg: ModelConfig, pos: int, batch: int, max_len: int,
                     dtype: torch.dtype, device) -> dict:
    check_supported(cfg, pos)
    return mamba.mamba_state_init(cfg, batch, dtype, device)


def block_step(params: dict, x: torch.Tensor, cfg: ModelConfig, pos: int,
               positions, cache: dict):
    """Cached path (decode step or prefill into the cache).  Returns
    ``(x, new_cache)``."""
    check_supported(cfg, pos)
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if x.shape[1] == 1:
        mix, cache = mamba.mamba_step(params["mixer"], h, cfg, cache)
    else:   # prefill: the full scan, keeping the final state
        mix, cache = mamba.mamba_forward(params["mixer"], h, cfg,
                                         return_state=True)
    return x + mix, cache
