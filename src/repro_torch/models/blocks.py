"""One decoder/encoder block: mixer (attention or mamba) + FFN (dense or
MoE), pre-norm residual wiring (the JAX package's
``repro.models.blocks``).  Uniform across the zoo:

    x = x + mixer(norm1(x))
    x = x + ffn(norm2(x))      # skipped when the arch has no FFN (mamba-1)

Enc-dec decoder blocks add ``x = x + cross_attn(norm_cross(x), enc)``.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.annotate import constrain
from repro_torch.models import attention, layers, mamba, moe
from repro_torch.models.config import ModelConfig


def block_init(gen: torch.Generator, cfg: ModelConfig, pos: int, *,
               cross: bool = False) -> dict:
    kind = cfg.pattern[pos % cfg.period]
    dev = gen.device
    p = {"norm1": layers.rmsnorm_init(cfg.d_model, dev)}
    if kind == "attn":
        p["mixer"] = attention.attn_init(gen, cfg)
    else:
        p["mixer"] = mamba.mamba_init(gen, cfg)
    if cross:
        p["norm_cross"] = layers.rmsnorm_init(cfg.d_model, dev)
        p["cross"] = attention.attn_init(gen, cfg)
    if _has_ffn(cfg, pos):
        p["norm2"] = layers.rmsnorm_init(cfg.d_model, dev)
        if _is_moe(cfg, pos):
            p["ffn"] = moe.moe_init(gen, cfg)
        else:
            p["ffn"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                       cfg.gated_mlp)
    return p


def _is_moe(cfg: ModelConfig, pos: int) -> bool:
    return bool(cfg.moe_experts and cfg.moe_positions and
                cfg.moe_positions[pos % cfg.period])


def _has_ffn(cfg: ModelConfig, pos: int) -> bool:
    return _is_moe(cfg, pos) or cfg.d_ff > 0


def _ffn(params: dict, x: torch.Tensor, cfg: ModelConfig, pos: int):
    """Returns ``(y, aux)``; ``y`` is None for a block without an FFN
    (JAX adds zeros there)."""
    if not _has_ffn(cfg, pos):
        return None, 0.0
    h = layers.rmsnorm(params["norm2"], x, cfg.norm_eps)
    h = constrain(h, "dp", None, None)   # the sequence whole
    if _is_moe(cfg, pos):
        return moe.moe_ffn(params["ffn"], h, cfg)
    return layers.mlp(params["ffn"], h, cfg), 0.0


def _cross_and_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
                   pos: int, enc_kv):
    if enc_kv is not None:
        hc = constrain(layers.rmsnorm(params["norm_cross"], x, cfg.norm_eps),
                       "dp", None, None)
        x = x + _whole_seq(attention.cross_attention(params["cross"], hc,
                                                     enc_kv, cfg))
    y, aux = _ffn(params, x, cfg, pos)
    return (x if y is None else x + _whole_seq(y)), aux


def _whole_seq(y):
    """A sublayer's output with the sequence whole before it joins the
    sequence-sharded residual stream: its gradient then reaches the
    sublayer's products whole too (DTensor cannot flatten a
    sequence-sharded gradient into a matmul's backward)."""
    return constrain(y, "dp", None, None)


def block_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, pos: int,
                  positions, *, causal: bool = True, enc_kv=None):
    """Full-sequence (encode or forward) path.  Returns ``(x,
    aux_loss)``."""
    kind = cfg.pattern[pos % cfg.period]
    x = constrain(x, "dp", "tp" if cfg.seq_parallel else None, None)
    # the residual stream is sequence-sharded (JAX's hint); each sublayer
    # gathers the sequence of its normed input before its products (the
    # all-gather of Megatron's sequence parallelism, which JAX's
    # partitioner places itself and DTensor needs written out: it cannot
    # flatten a sequence-sharded activation into a matmul)
    h = constrain(layers.rmsnorm(params["norm1"], x, cfg.norm_eps),
                  "dp", None, None)
    if kind == "attn":
        mix = attention.self_attention(
            params["mixer"], h, cfg, positions, causal=causal,
            window=cfg.windows[pos % cfg.period])
    else:
        mix = mamba.mamba_forward(params["mixer"], h, cfg)
    return _cross_and_ffn(params, x + _whole_seq(mix), cfg, pos, enc_kv)


# each cache leaf's value in an empty cache, by the leaf's name
CACHE_FILL = {**attention.CACHE_FILL, **mamba.STATE_FILL}


def block_cache_init(cfg: ModelConfig, pos: int, batch: int, max_len: int,
                     dtype: torch.dtype, device) -> dict:
    """An attention layer's KV cache (a ring buffer of ``window`` slots
    for a windowed layer) or a mamba layer's state."""
    kind = cfg.pattern[pos % cfg.period]
    if kind == "attn":
        return attention.cache_init(cfg, batch, max_len,
                                    cfg.windows[pos % cfg.period], dtype,
                                    device)
    return mamba.mamba_state_init(cfg, batch, dtype, device)


def block_step(params: dict, x: torch.Tensor, cfg: ModelConfig, pos: int,
               positions, cache: dict, *, enc_kv=None):
    """Cached path (decode step or prefill into the cache).  Returns
    ``(x, new_cache)``."""
    kind = cfg.pattern[pos % cfg.period]
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        mix, cache = attention.attend_cache(
            params["mixer"], h, cfg, cache, positions,
            window=cfg.windows[pos % cfg.period])
    elif x.shape[1] == 1:
        mix, cache = mamba.mamba_step(params["mixer"], h, cfg, cache)
    else:   # prefill: the full scan, keeping the final state
        mix, cache = mamba.mamba_forward(params["mixer"], h, cfg,
                                         return_state=True)
    x, _ = _cross_and_ffn(params, x + mix, cfg, pos, enc_kv)
    return x, cache
