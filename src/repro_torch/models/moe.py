"""Mixture-of-experts FFN with sort-based token dispatch (the JAX
package's ``repro.models.moe``, its dense-global path).

Tokens scatter into one global ``[E, C, d]`` capacity buffer; a token's
slot within its expert comes from a stable argsort + searchsorted
ranking, so the ``[T, E, C]`` one-hot tensor of GShard is never made.
Capacity-dropped tokens fall through with zero contribution, exactly
where JAX drops them.  JAX's explicit expert-parallel path
(``_moe_ffn_ep``: ``shard_map`` and ``all_to_all`` over a mesh) waits
for the distributed slice; on one card JAX takes the dense-global path
too.

Every shape here is static (no ``.item()``, no data-dependent size), so
a decode step with MoE layers can be captured in a CUDA graph.  The
combine adds each token's k expert outputs in slot order in the compute
dtype, the order of JAX's scatter-add, without atomics: a run gives the
same bits every time.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.moe_experts
    scale_i = (1.0 / d) ** 0.5
    scale_o = (1.0 / ff) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=gen.device)

    p = {"router": layers.dense_init(gen, d, e),
         "wi": normal(e, d, ff) * scale_i,
         "wo": normal(e, ff, d) * scale_o}
    if cfg.gated_mlp:
        p["wg"] = normal(e, d, ff) * scale_i
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    e, k = cfg.moe_experts, cfg.moe_top_k
    c = int(n_tokens * k / e * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _positions_in_expert(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Rank of each expanded token within its expert (O(n) memory):
    int32 ``[n]``."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    starts = torch.searchsorted(
        e_sorted, torch.arange(e, dtype=e_sorted.dtype,
                               device=flat_e.device))
    pos_sorted = torch.arange(n, device=flat_e.device) - starts[e_sorted]
    return torch.zeros((n,), dtype=torch.int32, device=flat_e.device) \
        .scatter(0, order, pos_sorted.to(torch.int32))


def _route(params: dict, xt: torch.Tensor, cfg: ModelConfig):
    """The router, in fp32: returns ``(gates [t, k], eidx [t, k],
    aux_loss)``."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    t = xt.shape[0]
    logits = torch.matmul(xt.to(torch.float32),
                          params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    me = probs.mean(0)
    # tokens routed to each expert, counted by a comparison (exact, and
    # free of the host sync that bincount and one_hot make on the card)
    hits = eidx.reshape(-1, 1) == torch.arange(e, device=xt.device)
    ce = hits.sum(0).to(torch.float32) / (t * k)
    aux = e * torch.sum(me * ce)
    return gates, eidx, aux


def _expert_ffn(params: dict, buf: torch.Tensor, cfg: ModelConfig):
    """Batched expert products on ``buf [E, C, d]``."""
    dt = buf.dtype
    h = torch.matmul(buf, params["wi"].to(dt))
    if cfg.gated_mlp:
        g = torch.matmul(buf, params["wg"].to(dt))
        h = layers._act(cfg.act)(g) * h
    else:
        h = layers._act(cfg.act)(h)
    return torch.matmul(h, params["wo"].to(dt))


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """``x``: ``[B, S, d]`` -> ``(y, aux_loss)``, JAX's dense-global
    path."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    t = b * s
    xt = x.reshape(t, d)
    dt = x.dtype

    gates, eidx, aux = _route(params, xt, cfg)
    n = t * k
    flat_e = eidx.reshape(n)
    pos = _positions_in_expert(flat_e, e)
    c = capacity(cfg, t)
    keep = pos < c
    dst = torch.where(keep, flat_e * c + pos, e * c)   # e*c = dropped

    src_tok = torch.arange(t, device=x.device)[:, None].expand(t, k) \
        .reshape(n)
    # kept slots are distinct; the dropped ones all land in the spare last
    # row, which is cut off
    buf = torch.zeros((e * c + 1, d), dtype=dt, device=x.device) \
        .index_put((dst,), xt[src_tok])
    out_buf = _expert_ffn(params, buf[:-1].reshape(e, c, d), cfg)

    flat_out = out_buf.reshape(e * c, d)
    picked = torch.where(keep[:, None],
                         flat_out[torch.clamp(dst, 0, e * c - 1)],
                         torch.zeros((), dtype=dt, device=x.device))
    w = gates.reshape(n)[:, None].to(dt)
    contrib = (picked * w).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=dt, device=x.device)
    for j in range(k):   # JAX's scatter-add order: a token's slots in turn
        y = y + contrib[:, j]
    return y.reshape(b, s, d), aux
