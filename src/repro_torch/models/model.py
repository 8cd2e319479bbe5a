"""The language model: init / forward / prefill / decode over any zoo
config (the JAX package's ``repro.models.model``).

Params and caches keep the JAX package's tree layout: ``{"blocks": {"p0":
<tree with a leading n_periods dim>, ...}, "tail": [...]}`` plus the
embedding, final norm and head (and, for the encoder-decoder arch,
``enc_blocks``, ``enc_tail``, ``enc_norm``; for the frontend archs,
``frontend.proj``).  JAX's ``lax.scan`` over periods is a Python loop over
the leading dim here.  ``lm_loss`` is the training loss; with ``cfg.remat``
each layer of ``forward_hidden`` is recomputed in the backward, as JAX's
``jax.checkpoint`` does.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor import full as dtensor_full
from torch.utils import checkpoint as remat

from repro_torch.device import resolve_device
from repro_torch.distributed import annotate, partition
from repro_torch.distributed.annotate import constrain
from repro_torch.models import attention, blocks, layers, mamba
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (tree_leaves, tree_map,
                                        tree_map_with_path)

VOCAB_PAD = 2048


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(seed: int, cfg: ModelConfig, *, device=None) -> dict:
    """fp32 params from a ``torch.Generator`` seeded with ``seed``, with the
    JAX package's scales (dense ``1/sqrt(d_in)``, embeddings 0.02,
    ``A_log = log(1..ds)``, ``D = 1``, norms 1).  ``device`` None means
    ``cuda``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vp = padded_vocab(cfg)
    params = {"embed": layers.embed_init(gen, vp, cfg.d_model),
              "final_norm": layers.rmsnorm_init(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        params["head"] = layers.embed_init(gen, vp, cfg.d_model)["table"]
    cross = cfg.enc_dec
    params["blocks"] = _stack_init(gen, cfg, cfg.n_periods, cross=cross)
    params["tail"] = [blocks.block_init(gen, cfg, cfg.n_periods * cfg.period
                                        + i, cross=cross)
                      for i in range(cfg.n_tail)]
    if cfg.enc_dec:
        n_enc_p = cfg.n_enc_layers // cfg.period
        n_enc_tail = cfg.n_enc_layers - n_enc_p * cfg.period
        params["enc_blocks"] = _stack_init(gen, cfg, n_enc_p, cross=False)
        params["enc_tail"] = [blocks.block_init(gen, cfg, n_enc_p *
                                                cfg.period + i)
                              for i in range(n_enc_tail)]
        params["enc_norm"] = layers.rmsnorm_init(cfg.d_model, dev)
    if cfg.frontend is not None:
        params["frontend"] = {"proj": layers.dense_init(gen, cfg.d_model,
                                                        cfg.d_model)}
    return params


def _stack_init(gen: torch.Generator, cfg: ModelConfig, n: int, *,
                cross: bool = False) -> dict:
    """``{"p0": stacked block tree, "p1": ...}`` with leading dim ``n``,
    filled one layer at a time (a full copy of the stack is never held
    twice)."""
    out = {}
    for pos in range(cfg.period):
        if n == 0:
            out[f"p{pos}"] = None
            continue
        first = blocks.block_init(gen, cfg, pos, cross=cross)
        stack = tree_map(lambda a: torch.empty((n, *a.shape), dtype=a.dtype,
                                               device=a.device), first)
        tree_map(lambda s, a: s[0].copy_(a), stack, first)
        for j in range(1, n):
            tree_map(lambda s, a, j=j: s[j].copy_(a), stack,
                     blocks.block_init(gen, cfg, pos, cross=cross))
        out[f"p{pos}"] = stack
    return out


#: Per block part, the leaves that every use casts to the compute dtype.
#: The rest are used in fp32: the norms' scales (the q/k norms' too), the
#: router, and mamba's ``A_log``, ``D`` and ``dt_b``.
_COMPUTE_DTYPE_LEAVES = {
    "mixer": attention.COMPUTE_DTYPE_LEAVES + mamba.COMPUTE_DTYPE_LEAVES,
    "cross": attention.COMPUTE_DTYPE_LEAVES,
    "ffn": layers.MLP_LEAVES,
}


def cast_params(params: dict, cfg: ModelConfig) -> dict:
    """``params`` with the leaves that every use casts to the compute dtype
    (the mixers', cross attention's, the FFNs' and the experts' matrices,
    the frontend projection and the embedding table) cast once; the leaves
    used in fp32 (norms, the router, ``A_log``, ``D``, ``dt_b``, the lm
    head) stay.  The model gives the same results with either tree."""
    dt = layers.cdtype(cfg)

    def block_cast(block):
        out = dict(block)
        for part, names in _COMPUTE_DTYPE_LEAVES.items():
            if part in block:
                out[part] = {k: (v.to(dt) if k in names else v)
                             for k, v in block[part].items()}
        return out

    def stack_cast(stack):
        return {k: None if v is None else block_cast(v)
                for k, v in stack.items()}

    out = dict(params)
    if not cfg.tie_embeddings:   # a tied table is also the fp32 head
        out["embed"] = {"table": params["embed"]["table"].to(dt)}
    out["blocks"] = stack_cast(params["blocks"])
    out["tail"] = [block_cast(b) for b in params["tail"]]
    if "enc_blocks" in params:
        out["enc_blocks"] = stack_cast(params["enc_blocks"])
        out["enc_tail"] = [block_cast(b) for b in params["enc_tail"]]
    if "frontend" in params:
        out["frontend"] = {"proj": params["frontend"]["proj"].to(dt)}
    return out


def _layer(stack: dict, j: int) -> dict:
    return tree_map(lambda a: a[j], stack)


def _layers(stack: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree, one ``unbind`` a leaf: the
    backward of ``n`` separate indexings would write ``n`` stack-sized
    gradients (``_layer`` is kept for the cached paths, which run without
    gradients)."""
    parts = [a.unbind(0) for a in tree_leaves(stack)]
    out = []
    for j in range(n):
        it = iter([p[j] for p in parts])
        out.append(tree_map(lambda _: next(it), stack))
    return out


def _stack(*leaves):
    """``torch.stack`` of the leaves; DTensors of one placement are
    stacked shard by shard (each shard dim one further), where DTensor's
    own rule may gather them whole."""
    first = leaves[0]
    if not (isinstance(first, DTensor) and all(
            isinstance(t, DTensor) and t.placements == first.placements
            for t in leaves)):
        return torch.stack(leaves)
    pl = [Shard(p.dim + 1) if p.is_shard() else p for p in first.placements]
    shape = (len(leaves), *first.shape)
    return DTensor.from_local(
        torch.stack([t.to_local() for t in leaves]), first.device_mesh, pl,
        run_check=False, shape=torch.Size(shape),
        stride=(first.numel(), *first.stride()))


def _stacked(trees: list) -> dict:
    return tree_map(_stack, trees[0], *trees[1:])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _run_stack(stack: dict, tail: list, x: torch.Tensor, cfg: ModelConfig,
               positions, *, causal: bool = True, enc_kv=None):
    """The stacked periods, then the tail.  Returns ``(x, aux)``.  With
    ``cfg.remat`` and gradients on, each period (and each tail block) is
    recomputed in the backward (``torch.utils.checkpoint``, non-reentrant),
    as JAX's ``jax.checkpoint`` of its scan body and tail blocks."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    first = stack.get("p0") if stack else None
    n = 0 if first is None else first["norm1"]["scale"].shape[0]
    recompute = cfg.remat and torch.is_grad_enabled()

    def run(fn, *args):
        if recompute:
            return remat.checkpoint(
                fn, *args, use_reentrant=False,
                context_fn=annotate.checkpoint_contexts)
        return fn(*args)

    def period(x, lps):
        a = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos in range(cfg.period):
            x, a_pos = blocks.block_forward(lps[pos], x, cfg, pos,
                                            positions, causal=causal,
                                            enc_kv=enc_kv)
            a = a + a_pos
        return x, a

    per_pos = [_layers(stack[f"p{pos}"], n) for pos in range(cfg.period)] \
        if n else []
    for j in range(n):
        x, a = run(period, x, [layers_[j] for layers_ in per_pos])
        aux = aux + a
    for i, lp in enumerate(tail):
        x, a = run(lambda x, lp=lp, i=i: blocks.block_forward(
            lp, x, cfg, i, positions, causal=causal, enc_kv=enc_kv), x)
        aux = aux + a
    return x, aux


def _encode(params: dict, enc_input: torch.Tensor, cfg: ModelConfig):
    """Encoder over the stub frontend's embeddings ``[B, S_enc, d]``.
    Returns ``(enc_out, aux)``."""
    x = enc_input.to(layers.cdtype(cfg))
    x = torch.matmul(x, params["frontend"]["proj"].to(x.dtype))
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None] \
        .expand(b, s)
    x, aux = _run_stack(params["enc_blocks"], params["enc_tail"], x, cfg,
                        pos, causal=False)
    return layers.rmsnorm(params["enc_norm"], x, cfg.norm_eps), aux


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    """Token (+ vision prefix) embedding.  Returns ``(x, positions)``."""
    x = layers.embed(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "vision":
        patches = batch["patches"].to(x.dtype)             # [B, P, d]
        patches = torch.matmul(patches,
                               params["frontend"]["proj"].to(x.dtype))
        x = torch.cat([patches, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    return x, positions


def _head(params: dict) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"]["table"]


def forward_hidden(params: dict, batch: dict, cfg: ModelConfig):
    """Backbone forward to the final normed hidden states.  Returns
    ``(x [B, S, d], aux_loss)``."""
    x, positions = _embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    enc_out = None
    if cfg.enc_dec:
        enc_out, aux_e = _encode(params, batch["frames"], cfg)
        aux = aux + aux_e
    x, aux_d = _run_stack(params["blocks"], params["tail"], x, cfg,
                          positions, causal=True, enc_kv=enc_out)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux + aux_d


def forward(params: dict, batch: dict, cfg: ModelConfig):
    """Full forward.  ``batch``: ``{"tokens": [B, S] int}`` plus
    ``"frames"`` ``[B, S, d]`` (audio enc-dec) or ``"patches"``
    ``[B, P, d]`` (vision).  Returns ``(logits [B, S, vocab_padded],
    aux_loss)``."""
    x, aux = forward_hidden(params, batch, cfg)
    return layers.logits(_head(params), x, cfg), aux


def _ce_chunk(head: torch.Tensor, xc: torch.Tensor, lc: torch.Tensor,
              cfg: ModelConfig):
    """One chunk's summed next-token NLL and its count of labels >= 0."""
    lg = layers.logits(head, xc, cfg)
    mask = (lc >= 0).to(torch.float32)
    if isinstance(lg, DTensor):
        nll = _nll_sharded(lg, lc)
    else:
        lse = torch.logsumexp(lg, dim=-1)
        picked = torch.gather(lg, -1,
                              lc.clamp(min=0).long()[..., None])[..., 0]
        nll = lse - picked
    return (nll * mask).sum(), mask.sum()


def _nll_sharded(lg: DTensor, labels) -> DTensor:
    """``logsumexp(lg) - lg[label]`` of vocab-sharded logits, on local
    shards (DTensor's gather rule fails on the indexed result, and its
    reductions would gather the logits): each "model" rank takes the max,
    the sum of exponentials and the label's logit over its vocab columns
    (zero where the label is another rank's), and the three combine over
    "model" -- the max by an all-reduce, the sums as partial sums.  Each
    data rank takes its own batch rows.  With the whole vocab on each
    rank, ``torch.logsumexp`` and the gather as on one device."""
    mesh = lg.device_mesh
    by_batch, by_vocab = annotate.plan(mesh, lg.shape[0], lg.shape[-1])
    by_vocab = by_vocab and partition.mesh_axes(mesh)["model"] > 1
    rows = annotate.local_placements(mesh, by_batch, False, 0)
    local = lg.redistribute(mesh, annotate.local_placements(
        mesh, by_batch, by_vocab, 0, lg.dim() - 1)).to_local()
    idx = annotate.to_mesh(labels, mesh).redistribute(
        mesh, rows).to_local().clamp(min=0).long()
    if not by_vocab:
        nll = torch.logsumexp(local, dim=-1) - \
            torch.gather(local, -1, idx[..., None])[..., 0]
        return DTensor.from_local(nll, mesh, rows, run_check=False)

    def combine(t, op):   # this rank's part, reduced over "model"
        part = annotate.local_placements(mesh, by_batch, True, 0,
                                         partial_chan=True)
        if op != "sum":
            part = tuple(Partial(op) if p.is_partial() else p
                         for p in part)
        return DTensor.from_local(t, mesh, part, run_check=False) \
            .redistribute(mesh, rows)

    cols = local.shape[-1]
    idx = idx - mesh.get_local_rank("model") * cols
    hit = (idx >= 0) & (idx < cols)
    got = torch.gather(local, -1, idx.clamp(0, cols - 1)[..., None])[..., 0]
    picked = combine(torch.where(hit, got, got.new_zeros(())), "sum")
    with torch.no_grad():   # any shift gives the same lse
        m = combine(local.amax(-1), "max").to_local()
    sumexp = combine(torch.exp(local - m[..., None]).sum(-1), "sum")
    return DTensor.from_local(m, mesh, rows, run_check=False) + \
        torch.log(sumexp) - picked


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, *,
            aux_weight: float = 0.01, loss_chunk: int = 1024):
    """Next-token cross entropy (+ MoE aux).  Returns ``(loss, {"ce",
    "aux"})``.

    The CE is computed in sequence chunks of ``loss_chunk`` (the largest
    divisor of the length at most that), each recomputed in the backward
    (``torch.utils.checkpoint``, as JAX's ``jax.checkpoint``), so only one
    chunk of fp32 logits is held.  A vision arch's labels align right
    (the hidden states cover the patch prefix too)."""
    x, aux = forward_hidden(params, batch, cfg)
    x = constrain(x, "dp", None, None)            # the sequence whole
    labels = batch["labels"]                      # [B, S_lab]
    x = x[:, -labels.shape[1]:]
    hx = x[:, :-1]
    hl = labels[:, 1:]
    head = _head(params)
    s = hx.shape[1]
    chunk = min(loss_chunk, s)
    while s % chunk:
        chunk -= 1
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for k in range(0, s, chunk):
        xc, lc = hx[:, k:k + chunk], hl[:, k:k + chunk]
        if torch.is_grad_enabled():
            part, n = remat.checkpoint(
                _ce_chunk, head, xc, lc, cfg, use_reentrant=False,
                context_fn=annotate.checkpoint_contexts)
        else:
            part, n = _ce_chunk(head, xc, lc, cfg)
        nll_sum = nll_sum + part
        cnt = cnt + n
    loss = nll_sum / torch.clamp(cnt, min=1.0)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None, *, device=None,
               mesh=None) -> dict:
    """Cache tree mirroring the stacked block layout.  ``device`` None
    means ``cuda``.  With ``mesh``, a tree of DTensors placed by
    ``partition.cache_specs``, each rank making only its own shard, filled
    as ``block_cache_init`` fills it (``blocks.CACHE_FILL``)."""
    dev = resolve_device(device)
    dtype = dtype or layers.cdtype(cfg)
    n = cfg.n_periods

    def tree(dev):
        def stacked(pos):
            one = blocks.block_cache_init(cfg, pos, batch, max_len, dtype,
                                          dev)
            return tree_map(lambda a: a[None].repeat(n, *(1,) * a.dim()),
                            one)
        return {"blocks": {f"p{pos}": stacked(pos)
                           for pos in range(cfg.period)},
                "tail": [blocks.block_cache_init(
                    cfg, cfg.n_periods * cfg.period + i, batch, max_len,
                    dtype, dev) for i in range(cfg.n_tail)]}

    if mesh is None:
        return tree(dev)
    shapes = tree(torch.device("meta"))     # the shapes and dtypes only
    specs = partition.cache_specs(shapes, mesh, batch)

    def sharded(path, a, spec):
        fill = blocks.CACHE_FILL[path.rsplit("/", 1)[-1]]
        return dtensor_full(tuple(a.shape), fill, dtype=a.dtype,
                            device_mesh=mesh,
                            placements=partition.placements(spec, mesh))
    return tree_map_with_path(sharded, shapes, specs)


def _run_cached(params: dict, cache: dict, x: torch.Tensor, positions,
                cfg: ModelConfig, enc_out=None):
    """Every block's cached path, in order.  Returns ``(x, new_cache)``.
    The new stacked cache is restacked from the layers' new caches: a
    step copies the whole cache once more (JAX's scan writes it as the
    scan output)."""
    new_stack = cache["blocks"]
    if cfg.n_periods > 0:
        per_layer = []
        for j in range(cfg.n_periods):
            new_caches = {}
            for pos in range(cfg.period):
                x, c = blocks.block_step(
                    _layer(params["blocks"][f"p{pos}"], j), x, cfg, pos,
                    positions, _layer(cache["blocks"][f"p{pos}"], j),
                    enc_kv=enc_out)
                new_caches[f"p{pos}"] = c
            per_layer.append(new_caches)
        new_stack = _stacked(per_layer)
    new_tail = []
    for i, lp in enumerate(params["tail"]):
        x, c = blocks.block_step(lp, x, cfg, i, positions, cache["tail"][i],
                                 enc_kv=enc_out)
        new_tail.append(c)
    return x, {"blocks": new_stack, "tail": new_tail}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig, *, enc_out=None):
    """One decode step.  ``tokens`` ``[B, 1]``; ``pos`` ``[B, 1]`` int32
    absolute; ``enc_out`` the encoder output (``_encode``) for the
    encoder-decoder arch.  Returns ``(logits [B, 1, vocab], new_cache)``;
    ``cache`` itself is not written."""
    x = layers.embed(params["embed"], tokens, cfg)
    x, new_cache = _run_cached(params, cache, x, pos, cfg, enc_out)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.logits(_head(params), x, cfg), new_cache


def prefill(params: dict, batch: dict, cfg: ModelConfig, max_len: int):
    """Run the prompt (``batch`` as ``forward`` takes it) through the
    stack, building the cache.  Returns ``(last_logits [B, vocab], cache,
    next_pos [B, 1])``.  Raises ``ValueError`` when the prompt (with a
    vision prefix) is longer than a windowed layer's ring buffer or than
    ``max_len`` (``attention.cache_insert``)."""
    x, positions = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    enc_out = None
    if cfg.enc_dec:
        enc_out, _ = _encode(params, batch["frames"], cfg)
    cache = init_cache(cfg, b, max_len, dtype=x.dtype, device=x.device,
                       mesh=x.device_mesh if isinstance(x, DTensor)
                       else None)
    x, cache = _run_cached(params, cache, x, positions, cfg, enc_out)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logit = layers.logits(_head(params), x[:, -1:], cfg)
    next_pos = torch.full((b, 1), s, dtype=torch.int32, device=x.device)
    return logit[:, 0], cache, next_pos
