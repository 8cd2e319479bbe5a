"""Attention: GQA/MQA, RoPE, qk-norm, sliding windows, the chunked
online softmax, KV caches with ring buffers for windowed layers (the JAX
package's ``repro.models.attention``).

Masking is position-based everywhere: a KV slot carries its absolute
position (or -1 when empty), and visibility is
``0 <= kv_pos <= q_pos`` (+ ``kv_pos > q_pos - window`` for local layers).
This makes full caches, ring buffers and prefill share one code path.
The mask is additive with ``NEG = -1e30``, as in JAX, so a fully masked
row softmaxes to a uniform row, not to NaN.  Query head ``h`` belongs to
KV head ``h // (H // Hkv)`` (kv-major).

Plain PyTorch products and softmax, as JAX's ``jnp`` code: no finished
attention kernel, so the masking and the fp32 accumulation are JAX's.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed import annotate, partition
from repro_torch.distributed.annotate import constrain
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG = -1e30

#: Leaves that every use casts to the compute dtype (the norms' scales are
#: used in fp32).
COMPUTE_DTYPE_LEAVES = ("wq", "wk", "wv", "wo")


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": layers.dense_init(gen, d, cfg.n_heads * hd),
        "wk": layers.dense_init(gen, d, cfg.kv_heads * hd),
        "wv": layers.dense_init(gen, d, cfg.kv_heads * hd),
        "wo": layers.dense_init(gen, cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.rmsnorm_init(hd, gen.device)
        p["k_norm"] = layers.rmsnorm_init(hd, gen.device)
    return p


def _heads(t: torch.Tensor, n: int, hd: int, *spec):
    """``t`` ``[B, S, n * hd]`` as ``[B, S, n, hd]`` constrained to the
    logical ``spec``.  Over a mesh the flat dim is placed first as the
    head dim will be: sharded over "tp" only where ``n`` divides it (as
    ``constrain`` rules), since DTensor does not split a sharded dim into
    a head count its shards do not divide (JAX's partitioner regathers it
    by itself)."""
    b, s, _ = t.shape
    heads = spec[2] if n % max(annotate.axis_size("tp"), 1) == 0 else None
    t = constrain(t, spec[0], spec[1], heads)
    return constrain(t.reshape(b, s, n, hd), *spec)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """``o`` ``[B, S, H, Dh]`` as ``[B, S, H * Dh]``, constrained over a
    mesh to the heads' sharding ("tp" where ``H`` divides it, else whole)
    with the sequence whole: the output product cannot flatten a
    sequence-sharded activation (``_mha_sharded``'s query route gives
    one), and the gradient comes back so placed, which DTensor can split
    back into the heads (it cannot split a sharded dim into a head count
    its shards do not divide)."""
    b, s, h, hd = o.shape
    tp = "tp" if h % max(annotate.axis_size("tp"), 1) == 0 else None
    return constrain(o.reshape(b, s, h * hd), "dp", None, tp)


def project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    """``x``: ``[B, S, d]`` -> q ``[B, S, H, Dh]``, k/v ``[B, S, Hkv, Dh]``
    (normed per head, then roped)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = torch.matmul(x, params["wq"].to(dt))
    k = torch.matmul(x, params["wk"].to(dt))
    v = torch.matmul(x, params["wv"].to(dt))
    if cfg.n_heads % max(annotate.axis_size("tp"), 1) == 0:
        hspec = ("dp", None, "tp", None)    # tensor-parallel heads
    else:
        # context parallelism fallback (e.g. gemma3: 8 heads, tp=16):
        # shard query positions over the model axis instead
        hspec = ("dp", "tp", None, None)
    q = _heads(q, cfg.n_heads, hd, *hspec)
    k = _heads(k, cfg.kv_heads, hd, "dp", None, "tp", None)
    v = _heads(v, cfg.kv_heads, hd, "dp", None, "tp", None)
    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos, kv_pos, *, causal: bool, window: int | None):
    """``[B, Sq, Skv]`` fp32 additive bias from absolute positions."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, NEG).to(torch.float32)


def mha(q, k, v, q_pos, kv_pos, *, causal: bool = True, window=None,
        chunk_kv: int | None = None) -> torch.Tensor:
    """Grouped-query attention.  q ``[B, Sq, H, Dh]``; k/v
    ``[B, Skv, Hkv, Dh]``.  Returns ``[B, Sq, H, Dh]``.  With ``chunk_kv``
    below ``Skv``, JAX's flash-style route: an online softmax over KV
    chunks (a Python loop here, a ``lax.scan`` there), in fp32."""
    if isinstance(q, DTensor):
        return _mha_sharded(q, k, v, q_pos, kv_pos, causal=causal,
                            window=window, chunk_kv=chunk_kv)
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    scale = hd ** -0.5

    if chunk_kv is None or k.shape[1] <= chunk_kv:
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
        s = s * scale + _mask_bias(q_pos, kv_pos, causal=causal,
                                   window=window)[:, None, None]
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
        return o.reshape(b, sq, h, hd)

    skv = k.shape[1]
    if skv % chunk_kv:
        raise ValueError(f"{skv} keys do not split into chunks of "
                         f"{chunk_kv}")
    m = torch.full((b, hkv, g, sq), NEG, dtype=torch.float32,
                   device=q.device)
    l_ = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32,
                    device=q.device)
    for c0 in range(0, skv, chunk_kv):
        kc, vc = k[:, c0:c0 + chunk_kv], v[:, c0:c0 + chunk_kv]
        pc = kv_pos[:, c0:c0 + chunk_kv]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc).to(torch.float32)
        s = s * scale + _mask_bias(q_pos, pc, causal=causal,
                                   window=window)[:, None, None]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_ = l_ * corr + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype), vc)
        o = o * corr[..., None] + pv.to(torch.float32)
        m = m_new
    o = o / torch.clamp_min(l_, 1e-30)[..., None]
    # [b,hkv,g,sq,hd] -> [b,sq,hkv,g,hd] -> [b,sq,h,hd] (kv-major heads, as
    # the q reshape has them)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def _mha_sharded(q, k, v, q_pos, kv_pos, **kw):
    """``mha`` of DTensors, on local shards: batch rows over the data axes
    and, over "model", the heads when the query and the KV heads both
    divide it (a rank's query heads are then the groups of its KV heads,
    kv-major), else the query positions when they divide it (JAX's
    context-parallel fallback, ``project_qkv``'s: each rank attends its
    queries to every key, so the keys' and values' gradients are partial
    sums over "model"), else every head and position on each model rank.
    Attention is independent across rows, heads and queries."""
    mesh = q.device_mesh
    tp = partition.mesh_axes(mesh).get("model", 1)
    by_batch, _ = annotate.plan(mesh, q.shape[0])
    by_head = q.shape[2] % tp == 0 and k.shape[2] % tp == 0
    by_query = not by_head and q.shape[1] % tp == 0
    rows = annotate.local_placements(mesh, by_batch, False, 0)
    if by_query:
        qs = annotate.local_placements(mesh, by_batch, True, 0, 1)
        kvs = rows
        kv_grad = annotate.local_placements(mesh, by_batch, True, 0,
                                            partial_chan=True)
        qps = qs
    else:
        qs = kvs = kv_grad = annotate.local_placements(
            mesh, by_batch, by_head, 0, 2)
        qps = rows
    ql = annotate.to_mesh(q, mesh).redistribute(mesh, qs).to_local()
    kl, vl = (annotate.to_mesh(t, mesh).redistribute(mesh, kvs)
              .to_local(grad_placements=kv_grad) for t in (k, v))
    qp = annotate.to_mesh(q_pos, mesh).redistribute(mesh, qps).to_local()
    kp = annotate.to_mesh(kv_pos, mesh).redistribute(mesh, rows).to_local()
    return DTensor.from_local(mha(ql, kl, vl, qp, kp, **kw), mesh, qs,
                              run_check=False)


def self_attention(params: dict, x: torch.Tensor, cfg: ModelConfig,
                   positions, *, causal: bool = True, window=None):
    """Full-sequence path (no cache)."""
    q, k, v = project_qkv(params, x, cfg, positions)
    chunk = cfg.attn_chunk_kv if x.shape[1] >= cfg.attn_chunk_min_seq \
        else None
    o = mha(q, k, v, positions, positions, causal=causal, window=window,
            chunk_kv=chunk)
    b, s, _ = x.shape
    return torch.matmul(_merge_heads(o), params["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# KV cache (full or ring buffer)
# ---------------------------------------------------------------------------


# each leaf's value in an empty cache: an empty slot's position is -1
CACHE_FILL = {"k": 0, "v": 0, "pos": -1}


def cache_init(cfg: ModelConfig, batch: int, max_len: int,
               window: int | None, dtype: torch.dtype, device) -> dict:
    slots = min(max_len, window) if window else max_len
    kv = ((batch, slots, cfg.kv_heads, cfg.resolved_head_dim), dtype)
    leaves = {"k": kv, "v": kv, "pos": ((batch, slots), torch.int32)}
    return {name: torch.full(shape, CACHE_FILL[name], dtype=dt,
                             device=device)
            for name, (shape, dt) in leaves.items()}


def cache_insert(cache: dict, k, v, positions) -> dict:
    """A new cache with the S rows written at ``positions % slots`` (ring
    semantics; for a full cache slots == max_len, so the modulo is the
    identity).  ``cache`` itself is not written.

    Raises ``ValueError`` when S exceeds the slots: the prompt's later
    rows would overwrite keys that its own earlier queries need.  (JAX
    inserts them all before it attends, and returns wrong logits there.)"""
    slots = cache["k"].shape[1]
    if positions.shape[1] > slots:
        raise ValueError(
            f"{positions.shape[1]} positions inserted at once into a cache "
            f"of {slots} slots: a prefill may not be longer than a windowed "
            "layer's ring buffer (or than max_len)")
    if isinstance(cache["k"], DTensor):
        return _cache_insert_sharded(cache, k, v, positions)
    idx = (positions % slots).to(torch.int64)          # [B, S]
    rows = idx[:, :, None, None].expand(-1, -1, *k.shape[2:])
    return {"k": cache["k"].scatter(1, rows, k),
            "v": cache["v"].scatter(1, rows, v),
            "pos": cache["pos"].scatter(1, idx,
                                        positions.to(torch.int32))}


def _cache_insert_sharded(cache: dict, k, v, positions) -> dict:
    """``cache_insert`` of a cache of DTensors, on local shards: each rank
    writes the rows whose slots fall in its own range of the slot dim
    (sharded as ``partition.cache_specs`` places it) into its shard, and
    the cache stays placed as it was.  DTensor's rule for a scatter into a
    sharded dim gathers the whole cache onto every rank."""
    mesh = cache["k"].device_mesh
    pl = tuple(cache["k"].placements)
    slots = cache["k"].shape[1]
    # the rank's first slot: the mesh dims sharding dim 1 split it in
    # turn, each into chunks of the size rounded up (as DTensor does)
    coord, size, lo = mesh.get_coordinate(), slots, 0
    for i, p in enumerate(pl):
        if p.is_shard(1):
            chunk = -(-size // mesh.size(i))
            lo += coord[i] * chunk
            size = max(min(chunk, size - coord[i] * chunk), 0)
    n_local = cache["k"].to_local().shape[1]
    # the new rows: the cache's batch placement, every row on every rank
    rows_pl = [p if p.is_shard(0) else Replicate() for p in pl]
    kl, vl, pos = (annotate.to_mesh(t, mesh).redistribute(mesh, rows_pl)
                   .to_local() for t in (k, v, positions))
    idx = (pos % slots).to(torch.int64) - lo           # [B, S] local slots
    # rows of other ranks go to a spare slot past the end, then dropped
    idx = torch.where((idx >= 0) & (idx < n_local), idx, n_local)

    def put(t, new, index):
        spare = torch.cat([t, t[:, :1]], dim=1)
        return spare.scatter(1, index, new)[:, :t.shape[1]]

    rows = idx[:, :, None, None].expand(-1, -1, *kl.shape[2:])
    out = {"k": put(cache["k"].to_local(), kl, rows),
           "v": put(cache["v"].to_local(), vl, rows),
           "pos": put(cache["pos"].to_local(), pos.to(torch.int32), idx)}
    return {name: DTensor.from_local(t, mesh, cache[name].placements,
                                     run_check=False, shape=cache[name].shape,
                                     stride=cache[name].stride())
            for name, t in out.items()}


def attend_cache(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 cache: dict, positions, *, window=None):
    """Self-attention against a cache, after inserting ``x``'s K/V.  ``x``:
    ``[B, S, d]`` (S = 1 decode, S = the prompt in prefill).  Returns
    ``(out, cache)``; raises as ``cache_insert`` does."""
    q, k, v = project_qkv(params, x, cfg, positions)
    cache = cache_insert(cache, k, v, positions)
    chunk = cfg.attn_chunk_kv \
        if cache["k"].shape[1] >= cfg.attn_chunk_min_seq else None
    o = mha(q, cache["k"], cache["v"], positions, cache["pos"],
            causal=True, window=window, chunk_kv=chunk)
    b, s, _ = x.shape
    out = torch.matmul(_merge_heads(o), params["wo"].to(x.dtype))
    return out, cache


# ---------------------------------------------------------------------------
# Cross attention (enc-dec)
# ---------------------------------------------------------------------------


def cross_attention(params: dict, x: torch.Tensor, enc_kv,
                    cfg: ModelConfig) -> torch.Tensor:
    """``x``: ``[B, Sq, d]``; ``enc_kv``: a dict with precomputed k/v
    ``[B, Senc, Hkv, Dh]`` and pos ``[B, Senc]``, or the raw encoder
    output ``[B, Senc, d]`` (projected here with this layer's wk/wv).  The
    queries sit at position 0 and see every encoder position (no mask, no
    rope)."""
    if not isinstance(enc_kv, dict):
        enc_kv = encoder_kv(params, enc_kv, cfg)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = torch.matmul(x, params["wq"].to(dt)).reshape(b, s, cfg.n_heads, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, cfg.norm_eps)
    qpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    o = mha(q, enc_kv["k"], enc_kv["v"], qpos, enc_kv["pos"], causal=False)
    return torch.matmul(_merge_heads(o), params["wo"].to(dt))


def encoder_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig
               ) -> dict:
    """Cross-attention K/V from the encoder output (its sequence gathered
    over a mesh first, as each block gathers its sublayers' input: DTensor
    cannot flatten a sequence-sharded activation into a matmul)."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    dt = enc_out.dtype
    enc_out = constrain(enc_out, "dp", None, None)
    k = torch.matmul(enc_out, params["wk"].to(dt)).reshape(
        b, s, cfg.kv_heads, hd)
    v = torch.matmul(enc_out, params["wv"].to(dt)).reshape(
        b, s, cfg.kv_heads, hd)
    if cfg.qk_norm:
        k = layers.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    pos = torch.arange(s, dtype=torch.int32, device=enc_out.device)
    return {"k": k, "v": v, "pos": pos[None].expand(b, s)}
