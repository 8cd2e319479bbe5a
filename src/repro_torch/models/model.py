"""The language model: init / forward / prefill / decode (the JAX package's
``repro.models.model``).

Params and caches keep the JAX package's tree layout: ``{"blocks": {"p0":
<tree with a leading n_periods dim>, ...}, "tail": [...]}`` plus the
embedding, final norm and head.  JAX's ``lax.scan`` over periods is a
Python loop over the leading dim here.  The port runs the archs whose
blocks ``blocks.check_supported`` accepts (falcon-mamba); the others
resolve as configs and raise here.  ``lm_loss`` waits for the training
slice (ROADMAP A14), encoder-decoder and frontend archs for A12.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers, mamba
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_map

VOCAB_PAD = 2048


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.enc_dec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend archs are not ported "
            "yet (ROADMAP A12)")
    for pos in range(cfg.period):
        blocks.check_supported(cfg, pos)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(seed: int, cfg: ModelConfig, *, device=None) -> dict:
    """fp32 params from a ``torch.Generator`` seeded with ``seed``, with the
    JAX package's scales (dense ``1/sqrt(d_in)``, embeddings 0.02,
    ``A_log = log(1..ds)``, ``D = 1``).  ``device`` None means ``cuda``."""
    dev = resolve_device(device)
    _check_supported(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vp = padded_vocab(cfg)
    params = {"embed": layers.embed_init(gen, vp, cfg.d_model),
              "final_norm": layers.rmsnorm_init(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        params["head"] = layers.embed_init(gen, vp, cfg.d_model)["table"]
    params["blocks"] = _stack_init(gen, cfg, cfg.n_periods)
    params["tail"] = [blocks.block_init(gen, cfg, cfg.n_periods * cfg.period
                                        + i) for i in range(cfg.n_tail)]
    return params


def _stack_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    """``{"p0": stacked block tree, "p1": ...}`` with leading dim ``n``,
    filled one layer at a time (a full copy of the stack is never held
    twice)."""
    out = {}
    for pos in range(cfg.period):
        if n == 0:
            out[f"p{pos}"] = None
            continue
        first = blocks.block_init(gen, cfg, pos)
        stack = tree_map(lambda a: torch.empty((n, *a.shape), dtype=a.dtype,
                                               device=a.device), first)
        tree_map(lambda s, a: s[0].copy_(a), stack, first)
        for j in range(1, n):
            tree_map(lambda s, a, j=j: s[j].copy_(a), stack,
                     blocks.block_init(gen, cfg, pos))
        out[f"p{pos}"] = stack
    return out


def cast_params(params: dict, cfg: ModelConfig) -> dict:
    """``params`` with the leaves that every use casts to the compute dtype
    (the mixers' matrices and the embedding table) cast once; the leaves
    used in fp32 (norms, ``A_log``, ``D``, ``dt_b``, the lm head) stay.
    The model gives the same results with either tree."""
    dt = layers.cdtype(cfg)

    def mixer_cast(block):
        return dict(block, mixer={k: (v.to(dt) if k in
                                      mamba.COMPUTE_DTYPE_LEAVES else v)
                                  for k, v in block["mixer"].items()})

    out = dict(params)
    if not cfg.tie_embeddings:   # a tied table is also the fp32 head
        out["embed"] = {"table": params["embed"]["table"].to(dt)}
    out["blocks"] = {k: None if v is None else mixer_cast(v)
                     for k, v in params["blocks"].items()}
    out["tail"] = [mixer_cast(b) for b in params["tail"]]
    return out


def _layer(stack: dict, j: int) -> dict:
    return tree_map(lambda a: a[j], stack)


def _stacked(trees: list) -> dict:
    return tree_map(lambda *a: torch.stack(a), trees[0], *trees[1:])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    """Token embedding.  Returns ``(x, positions)``."""
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    return x, positions


def _head(params: dict) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"]["table"]


def forward_hidden(params: dict, batch: dict, cfg: ModelConfig):
    """Backbone forward to the final normed hidden states.  Returns
    ``(x [B, S, d], aux_loss)``."""
    _check_supported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stack = params["blocks"]
    for j in range(cfg.n_periods):
        for pos in range(cfg.period):
            lp = _layer(stack[f"p{pos}"], j)
            x, a = blocks.block_forward(lp, x, cfg, pos, positions)
            aux = aux + a
    for i, lp in enumerate(params["tail"]):
        x, a = blocks.block_forward(lp, x, cfg, i, positions)
        aux = aux + a
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def forward(params: dict, batch: dict, cfg: ModelConfig):
    """Full forward.  ``batch``: ``{"tokens": [B, S] int}``.  Returns
    ``(logits [B, S, vocab_padded], aux_loss)``."""
    x, aux = forward_hidden(params, batch, cfg)
    return layers.logits(_head(params), x, cfg), aux


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, **kw):
    raise NotImplementedError("lm_loss waits for the training slice "
                              "(ROADMAP A14); the port serves only")


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None, *, device=None) -> dict:
    """Cache tree mirroring the stacked block layout.  ``device`` None
    means ``cuda``."""
    dev = resolve_device(device)
    dtype = dtype or layers.cdtype(cfg)
    n = cfg.n_periods

    def stacked(pos):
        one = blocks.block_cache_init(cfg, pos, batch, max_len, dtype, dev)
        return tree_map(lambda a: a[None].repeat(n, *(1,) * a.dim()), one)

    return {"blocks": {f"p{pos}": stacked(pos) for pos in range(cfg.period)},
            "tail": [blocks.block_cache_init(
                cfg, cfg.n_periods * cfg.period + i, batch, max_len, dtype,
                dev) for i in range(cfg.n_tail)]}


def _run_cached(params: dict, cache: dict, x: torch.Tensor, positions,
                cfg: ModelConfig):
    """Every block's cached path, in order.  Returns ``(x, new_cache)``."""
    new_stack = cache["blocks"]
    if cfg.n_periods > 0:
        per_layer = []
        for j in range(cfg.n_periods):
            new_caches = {}
            for pos in range(cfg.period):
                x, c = blocks.block_step(
                    _layer(params["blocks"][f"p{pos}"], j), x, cfg, pos,
                    positions, _layer(cache["blocks"][f"p{pos}"], j))
                new_caches[f"p{pos}"] = c
            per_layer.append(new_caches)
        new_stack = _stacked(per_layer)
    new_tail = []
    for i, lp in enumerate(params["tail"]):
        x, c = blocks.block_step(lp, x, cfg, i, positions, cache["tail"][i])
        new_tail.append(c)
    return x, {"blocks": new_stack, "tail": new_tail}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig):
    """One decode step.  ``tokens`` ``[B, 1]``; ``pos`` ``[B, 1]`` int32
    absolute.  Returns ``(logits [B, 1, vocab], new_cache)``."""
    _check_supported(cfg)
    x = layers.embed(params["embed"], tokens, cfg)
    x, new_cache = _run_cached(params, cache, x, pos, cfg)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.logits(_head(params), x, cfg), new_cache


def prefill(params: dict, batch: dict, cfg: ModelConfig, max_len: int):
    """Run the prompt through the stack, building the cache.  Returns
    ``(last_logits [B, vocab], cache, next_pos [B, 1])``."""
    _check_supported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max_len, dtype=x.dtype, device=x.device)
    x, cache = _run_cached(params, cache, x, positions, cfg)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logit = layers.logits(_head(params), x[:, -1:], cfg)
    next_pos = torch.full((b, 1), s, dtype=torch.int32, device=x.device)
    return logit[:, 0], cache, next_pos
