"""Mixture-of-experts FFN with sort-based token dispatch (the JAX
package's ``repro.models.moe``).

Two execution paths:

* **dense-global** (no mesh context, or a model axis of 1): tokens
  scatter into one global ``[E, C, d]`` capacity buffer; a token's slot
  within its expert comes from a stable argsort + searchsorted ranking, so
  the ``[T, E, C]`` one-hot tensor of GShard is never made.  On a mesh
  each data rank runs this path on its own rows, with the slots ranked
  over the whole batch (``_moe_ffn_dp``).

* **explicit EP** (a mesh context whose model axis is above 1): local
  top-k on each rank's tokens, local capacity buffers, one
  ``all_to_all_single`` over the "model" group to the expert-owning ranks,
  the batched expert products, a second one back, local combine.  The
  experts are phantom-padded to a multiple of the model axis (phantoms
  receive no routing); the data axes stay pure DP.

Capacity-dropped tokens fall through with zero contribution, exactly
where JAX drops them.  Every shape here is static (no ``.item()``, no
data-dependent size), so a decode step with MoE layers can be captured in
a CUDA graph.  The combine adds each token's k expert outputs in slot
order in the compute dtype, the order of JAX's scatter-add, without
atomics: a run gives the same bits every time.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed import annotate, partition
from repro_torch.distributed.annotate import constrain
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


#: The experts' leaves (``[E, d|ff, ff|d]``).
MLP_EXPERT_LEAVES = ("wi", "wo", "wg")


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


def _router(params: dict, xt: torch.Tensor, cfg: ModelConfig):
    """The router, in fp32: returns ``(gates [t, k], eidx [t, k], probs
    [t, E], counts [E])``, ``counts`` the expanded tokens routed to each
    expert."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    logits = torch.matmul(xt.to(torch.float32),
                          params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # counted by a comparison (exact, and free of the host sync that
    # bincount and one_hot make on the card)
    hits = eidx.reshape(-1, 1) == torch.arange(e, device=xt.device)
    return gates, eidx, probs, hits.sum(0)


def _route(params: dict, xt: torch.Tensor, cfg: ModelConfig):
    """JAX's ``_route``: ``(gates [t, k], eidx [t, k], aux_loss)`` of the
    tokens ``xt``."""
    gates, eidx, probs, counts = _router(params, xt, cfg)
    return gates, eidx, _aux(probs.mean(0), counts, eidx.numel())


def _aux(me: torch.Tensor, counts: torch.Tensor, n: int) -> torch.Tensor:
    """The load-balance loss ``E * sum(me * ce)``: ``me [E]`` the mean
    router probability of each expert, ``ce`` its share of the ``n``
    expanded tokens."""
    ce = counts.to(torch.float32) / n
    return counts.shape[0] * torch.sum(me * ce)


def _dispatch(xt: torch.Tensor, eidx: torch.Tensor, pos: torch.Tensor,
              keep: torch.Tensor, e: int, c: int):
    """The kept (token, slot) pairs' rows of ``xt`` in an ``[e * c, d]``
    buffer, at row ``expert * c + pos``; returns it and each pair's row
    (``e * c`` where dropped)."""
    t, k = eidx.shape
    dst = torch.where(keep, eidx.reshape(t * k) * c + pos, e * c)
    src_tok = torch.arange(t, device=xt.device)[:, None].expand(t, k) \
        .reshape(t * k)
    # kept slots are distinct; the dropped ones all land in the spare last
    # row, which is cut off
    buf = torch.zeros((e * c + 1, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device).index_put((dst,), xt[src_tok])
    return buf[:-1], dst


def _undispatch(flat_out: torch.Tensor, dst: torch.Tensor,
                keep: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Each token's k gated expert outputs (rows ``dst`` of ``flat_out``,
    zero where dropped), added in slot order: ``[t, d]``."""
    t, k = gates.shape
    rows, d = flat_out.shape
    picked = torch.where(keep[:, None],
                         flat_out[torch.clamp(dst, 0, rows - 1)],
                         torch.zeros((), dtype=flat_out.dtype,
                                     device=flat_out.device))
    w = gates.reshape(t * k)[:, None].to(flat_out.dtype)
    return _combine(picked * w, t, k, d)


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
    """``x``: ``[B, S, d]`` -> ``(y, aux_loss)``.  Picks the EP path when a
    mesh context with a model axis above 1 is active, else the
    dense-global path (on each data rank's rows for a DTensor ``x``)."""
    if annotate.active() and annotate.axis_size("tp") > 1:
        return _moe_ffn_ep(params, x, cfg)
    if isinstance(x, DTensor):
        return _moe_ffn_dp(params, x, cfg)
    return _moe_ffn_dense(params, x, cfg)


def _moe_ffn_dense(params: dict, x: torch.Tensor, cfg: ModelConfig):
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    t = b * s
    xt = x.reshape(t, d)

    gates, eidx, aux = _route(params, xt, cfg)
    pos = _positions_in_expert(eidx.reshape(t * k), e)
    c = capacity(cfg, t)
    keep = pos < c
    buf, dst = _dispatch(xt, eidx, pos, keep, e, c)
    buf = constrain(buf.reshape(e, c, d), "tp", None, None)
    out_buf = _expert_ffn(params, buf, cfg)
    y = _undispatch(out_buf.reshape(e * c, d), dst, keep, gates)
    return y.reshape(b, s, d), aux


def _data_rank(mesh) -> int:
    """This rank's block of rows over the data axes (a batch sharded on
    several mesh dims splits on the first one first)."""
    sizes = partition.mesh_axes(mesh)
    data = partition.data_axes(mesh)
    i = 0
    for name, coord in zip(sizes, mesh.get_coordinate()):
        if name in data:
            i = i * sizes[name] + coord
    return i


def _moe_ffn_dp(params: dict, x: DTensor, cfg: ModelConfig):
    """The dense-global path of a DTensor ``x`` (a mesh whose model axis
    is 1, where JAX takes it too), on each data rank's own rows.  JAX's
    capacity ranks the whole batch: a pair's slot in its expert is its rank
    among this rank's pairs plus the expert's pairs on the ranks before,
    whose counts come from an all-gather of ``E`` ints a rank.  Each rank
    then dispatches, runs and combines only its rows, in ``min(C, rows)``
    slots an expert (no rank keeps more of an expert's pairs).  The
    weights are gathered whole (ZeRO-3's all-gather), their gradients
    partial over the data axes; ``y`` keeps ``x``'s rows, and ``aux`` is
    the whole batch's, replicated."""
    mesh = x.device_mesh
    e, k = cfg.moe_experts, cfg.moe_top_k
    b, s, d = x.shape
    t = b * s
    by_batch, _ = annotate.plan(mesh, b)
    rows = annotate.local_placements(mesh, by_batch, False, 0)
    whole = annotate.local_placements(mesh, False, False)
    summed = annotate.local_placements(mesh, by_batch, False,
                                       partial_batch=True)
    xl = x.redistribute(mesh, rows).to_local()
    lp = {name: annotate.to_mesh(w, mesh).redistribute(mesh, whole)
          .to_local(grad_placements=summed) for name, w in params.items()}

    xt = xl.reshape(-1, d)
    t_loc = xt.shape[0]
    gates, eidx, probs, counts = _router(lp, xt, cfg)
    every = DTensor.from_local(counts[None], mesh, rows,
                               run_check=False).full_tensor()
    before = every[:_data_rank(mesh) if by_batch else 0].sum(0)
    pos = _positions_in_expert(eidx.reshape(t_loc * k), e)
    c = capacity(cfg, t)
    c_loc = min(c, t_loc)
    keep = before[eidx.reshape(-1)] + pos < c
    buf, dst = _dispatch(xt, eidx, pos, keep, e, c_loc)
    out_buf = _expert_ffn(lp, buf.reshape(e, c_loc, d), cfg)
    y = _undispatch(out_buf.reshape(e * c_loc, d), dst, keep, gates)
    y = DTensor.from_local(y.reshape(xl.shape), mesh, rows, run_check=False)
    # the aux loss is linear in the router's probabilities: each rank's
    # share of the batch mean, summed over the data ranks
    aux = DTensor.from_local(_aux(probs.sum(0) / t, every.sum(0), t * k),
                             mesh, summed, run_check=False)
    return y, aux.redistribute(mesh, whole)


def _combine(contrib: torch.Tensor, t: int, k: int, d: int) -> torch.Tensor:
    """Each token's k weighted expert outputs, added in slot order."""
    contrib = contrib.reshape(t, k, d)
    y = torch.zeros((t, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):   # JAX's scatter-add order: a token's slots in turn
        y = y + contrib[:, j]
    return y


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal splits over a group (JAX's tiled
    ``all_to_all`` on dim 0); the backward is the reverse exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _GatherTokens(torch.autograd.Function):
    """All-gather of the token slices over a group, whose backward hands
    each rank its own slice of the (replicated) gradient: JAX's tiled
    ``all_gather`` under ``shard_map``, whose replicated output's
    cotangent is divided over the axis before the reduce-scatter."""

    @staticmethod
    def forward(ctx, y, group, n, i):
        ctx.slice = (i * y.shape[0], y.shape[0])
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(0, *ctx.slice), None, None, None


class _GradScale(torch.autograd.Function):
    """The identity, with its gradient scaled by ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _moe_ffn_ep(params: dict, x, cfg: ModelConfig):
    """Explicit expert parallelism over the active mesh (JAX's
    ``shard_map`` body, on each rank's local shards).

    Every model rank owns ``e_pad / tp`` experts.  Tokens are replicated
    across the model axis; when they split evenly, each model rank routes
    a disjoint ``1/tp`` slice of its data shard's tokens (sequence-parallel
    MoE) and the outputs are all-gathered, else every model rank routes
    them all.  The aux loss is the mean over the data axes (and over the
    model axis with the split).  ``params`` and ``x`` are DTensors on the
    mesh, or plain tensors taken as replicated; ``y`` comes back
    replicated over "model" and sharded over the data axes as ``x`` is,
    ``aux`` replicated.  Each input's gradient placements are written out:
    partial over the data axes for the weights, partial over "model" for
    ``x`` and the router."""
    mesh = annotate._ctx()["mesh"]
    tp = annotate.axis_size("tp")
    e, k = cfg.moe_experts, cfg.moe_top_k
    e_pad = -(-e // tp) * tp
    e_loc = e_pad // tp
    b, s, d = x.shape
    by_batch, _ = annotate.plan(mesh, b)
    dp = annotate.axis_size("dp") if by_batch else 1
    t_loc = (b // dp) * s
    seq_split = t_loc % tp == 0 and t_loc >= tp
    t_eff = t_loc // tp if seq_split else t_loc
    c_loc = max(8, -(-int(t_eff * k / e_pad * cfg.capacity_factor)) //
                8 * 8)
    group = mesh.get_group("model")
    m_rank = mesh.get_local_rank("model")

    def pl(*dims, **kw):   # rows over the data axes, experts over "model"
        return annotate.local_placements(mesh, by_batch, True, *dims, **kw)

    rows, whole = annotate.local_placements(mesh, by_batch, False, 0), \
        annotate.local_placements(mesh, False, False)
    xl = annotate.to_mesh(x, mesh).redistribute(mesh, rows).to_local(
        grad_placements=pl(0, partial_chan=True))
    router = annotate.to_mesh(params["router"], mesh).redistribute(
        mesh, whole).to_local(grad_placements=pl(
            partial_batch=True, partial_chan=True))

    def expert_w(w):   # [E, ...] -> this rank's [e_loc, ...], padded
        w = annotate.to_mesh(w, mesh)
        if e_pad != e:   # phantom experts: zero weights, never routed to
            w = torch.cat([w, annotate.to_mesh(torch.zeros(
                (e_pad - e, *w.shape[1:]), dtype=w.dtype,
                device=w.device), mesh)], dim=0)
        return w.redistribute(mesh, annotate.local_placements(
            mesh, False, True, None, 0)).to_local(
                grad_placements=pl(None, 0, partial_batch=True))

    lp = {name: expert_w(params[name]) for name in MLP_EXPERT_LEAVES
          if name in params}

    xt = xl.reshape(-1, d)
    if seq_split:
        xt = xt.narrow(0, m_rank * t_eff, t_eff)
    gates, eidx, aux = _route({"router": router}, xt, cfg)
    pos = _positions_in_expert(eidx.reshape(t_eff * k), e_pad)
    keep = pos < c_loc
    send, dst = _dispatch(xt, eidx, pos, keep, e_pad, c_loc)
    send = send.reshape(tp, e_loc, c_loc, d)   # dim0 = dest rank
    recv = _AllToAll.apply(send, group)
    # recv [tp(source), e_loc, c_loc, d]; run local experts
    out = _expert_ffn(lp, recv, cfg)
    back = _AllToAll.apply(out, group)
    y = _undispatch(back.reshape(e_pad * c_loc, d), dst, keep, gates)
    if seq_split:
        y = _GatherTokens.apply(y, group, tp, m_rank)
    else:
        y = _GradScale.apply(y, 1.0 / tp)
    y = DTensor.from_local(y.reshape(xl.shape), mesh, rows,
                           run_check=False)
    aux = DTensor.from_local(aux / (dp * tp), mesh, pl(
        partial_batch=True, partial_chan=True), run_check=False)
    return y, aux.redistribute(mesh, whole)
