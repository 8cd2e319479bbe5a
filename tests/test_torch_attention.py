"""The port's attention and dense layers (``repro_torch.models.attention``,
``layers.mlp``, ``layers.rope``) against the JAX package's, and the ring
buffer's guard.

The same params go through both: JAX's init makes them, ``np.asarray``
and ``convert.params_from_numpy`` carry them across; inputs are numpy
from a seed.  Tolerances (as ``tests/test_torch_models.py``): fp32 within
1e-4 absolute and relative; bf16 within 5e-2 of the largest reference
magnitude (the two frameworks round bf16 products at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, convert, layers, model

FP32 = dict(dtype="float32", ssm_scan_dtype="float32")


def near(got, want, mode="fp32"):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if mode == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = float(np.abs(got - want).max())
        assert err <= 5e-2 * float(np.abs(want).max()), err


def configs(arch, mode="fp32", **kw):
    extra = dict(FP32 if mode == "fp32" else {}, **kw)
    return jax_smoke(arch).with_(**extra), get_smoke_config(arch).with_(
        **extra)


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def both(a, dtype):
    """numpy ``a`` as a JAX array and a tensor of ``dtype``, the same
    values."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    return j, convert.tensor_from_numpy(np.asarray(j), "cpu")


def positions(b, s, start=0):
    p = np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None],
                        (b, s))
    return jnp.asarray(p), torch.from_numpy(p.copy())


# ---------------------------------------------------------------------------
# dense layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mode", [
    ("qwen3-14b", "fp32"), ("qwen3-14b", "bf16"),      # gated silu
    ("granite-20b", "fp32"), ("granite-20b", "bf16"),  # plain gelu (tanh)
    ("whisper-medium", "fp32")])
def test_mlp_matches_jax(arch, mode):
    jcfg, tcfg = configs(arch, mode)
    p = jax.tree.map(np.asarray, jlayers.mlp_init(
        jax.random.key(0), jcfg.d_model, jcfg.d_ff, jcfg.gated_mlp))
    jx, tx = both(normal(np.random.default_rng(1), 2, 7, jcfg.d_model),
                  jcfg.dtype)
    want = jlayers.mlp(jax.tree.map(jnp.asarray, p), jx, jcfg)
    got = layers.mlp(convert.params_from_numpy(p, "cpu"), tx, tcfg)
    assert got.dtype == getattr(torch, jcfg.dtype)
    near(got, want, mode)


def test_gelu_is_jax_tanh_form():
    x = np.linspace(-3, 3, 601, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = layers._act("gelu")(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < 1e-6
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert float(np.abs(erf - want).max()) > 1e-4   # the form matters


@pytest.mark.parametrize("theta,start,mode", [
    (10_000.0, 0, "fp32"), (1_000_000.0, 900, "fp32"), (10_000.0, 0, "bf16")])
def test_rope_matches_jax(theta, start, mode):
    rng = np.random.default_rng(2)
    jx, tx = both(normal(rng, 2, 9, 3, 16), "float32" if mode == "fp32"
                  else "bfloat16")
    jp, tp = positions(2, 9, start)
    near(layers.rope(tx, tp, theta), jlayers.rope(jx, jp, theta), mode)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def qkv(rng, b, sq, skv, h, hkv, hd, dtype):
    return (both(normal(rng, b, sq, h, hd), dtype),
            both(normal(rng, b, skv, hkv, hd), dtype),
            both(normal(rng, b, skv, hkv, hd), dtype))


@pytest.mark.parametrize("h,hkv,window,chunk,causal,dtype", [
    (8, 4, None, None, True, "float32"),     # GQA, whole softmax
    (8, 4, None, 16, True, "float32"),       # the chunked online softmax
    (8, 1, None, None, True, "float32"),     # MQA
    (8, 1, 8, 16, True, "float32"),          # MQA, windowed, chunked
    (4, 4, 8, None, True, "float32"),        # MHA, windowed
    (4, 2, None, 32, False, "float32"),      # non-causal, chunked
    (8, 4, 8, 16, True, "bfloat16"),
    (8, 4, None, None, True, "bfloat16")])
def test_mha_matches_jax(h, hkv, window, chunk, causal, dtype):
    rng = np.random.default_rng(h * 10 + hkv)
    b, s, hd = 2, 64, 16
    (jq, tq), (jk, tk), (jv, tv) = qkv(rng, b, s, s, h, hkv, hd, dtype)
    jp, tp = positions(b, s)
    want = jattn.mha(jq, jk, jv, jp, jp, causal=causal, window=window,
                     chunk_kv=chunk)
    got = attention.mha(tq, tk, tv, tp, tp, causal=causal, window=window,
                        chunk_kv=chunk)
    assert got.dtype == tq.dtype
    near(got, want, "fp32" if dtype == "float32" else "bf16")


def test_mha_fully_masked_rows_are_uniform_not_nan():
    """NEG = -1e30 is additive: a query that sees no key (every slot
    empty) averages all of them, in both packages."""
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = qkv(rng, 1, 2, 8, 4, 2, 8, "float32")
    jqp, tqp = positions(1, 2)
    empty = np.full((1, 8), -1, np.int32)
    for chunk in (None, 4):
        want = jattn.mha(jq, jk, jv, jqp, jnp.asarray(empty),
                         chunk_kv=chunk)
        got = attention.mha(tq, tk, tv, tqp, torch.from_numpy(empty),
                            chunk_kv=chunk)
        assert bool(torch.isfinite(got).all())
        near(got, want)
        mean_v = tv.mean(1, keepdim=True)   # [1, 1, 2, 8]
        near(got[:, :, :2], mean_v[:, :, :1].expand(1, 2, 2, 8))


@pytest.mark.parametrize("arch,mode", [
    ("gemma3-4b", "fp32"),       # qk-norm, GQA, theta 1e6
    ("qwen3-14b", "bf16"),
    ("granite-20b", "fp32"),     # MQA, no qk-norm
    ("yi-34b", "fp32")])
def test_self_attention_matches_jax(arch, mode):
    jcfg, tcfg = configs(arch, mode)
    p = jax.tree.map(np.asarray, jattn.attn_init(jax.random.key(0), jcfg))
    tp = convert.params_from_numpy(p, "cpu")
    for s in (24, 64):   # 64 takes the chunked route (min seq 64, chunk 32)
        jx, tx = both(normal(np.random.default_rng(s), 2, s, jcfg.d_model),
                      jcfg.dtype)
        jpos, tpos = positions(2, s)
        for window in (None, 16):
            want = jattn.self_attention(jax.tree.map(jnp.asarray, p), jx,
                                        jcfg, jpos, window=window)
            got = attention.self_attention(tp, tx, tcfg, tpos,
                                           window=window)
            near(got, want, mode)
        jq, jk, jv = jattn.project_qkv(jax.tree.map(jnp.asarray, p), jx,
                                       jcfg, jpos)
        tq, tk, tv = attention.project_qkv(tp, tx, tcfg, tpos)
        for t, j in ((tq, jq), (tk, jk), (tv, jv)):
            near(t, j, mode)


@pytest.mark.parametrize("arch,mode", [("whisper-medium", "fp32"),
                                       ("whisper-medium", "bf16"),
                                       ("qwen3-14b", "fp32")])
def test_cross_attention_and_encoder_kv_match_jax(arch, mode):
    """Queries at position 0, every encoder position visible; the K/V
    projected lazily or given as a dict (qwen3's qk-norm exercises the
    norms' per-head use)."""
    jcfg, tcfg = configs(arch, mode)
    p = jax.tree.map(np.asarray, jattn.cross_attn_init(jax.random.key(4),
                                                       jcfg))
    jp_, tp_ = jax.tree.map(jnp.asarray, p), convert.params_from_numpy(
        p, "cpu")
    rng = np.random.default_rng(5)
    jx, tx = both(normal(rng, 2, 3, jcfg.d_model), jcfg.dtype)
    je, te = both(normal(rng, 2, 20, jcfg.d_model), jcfg.dtype)
    jkv, tkv = jattn.encoder_kv(jp_, je, jcfg), attention.encoder_kv(
        tp_, te, tcfg)
    for key in ("k", "v", "pos"):
        near(tkv[key], jkv[key], mode)
    want = jattn.cross_attention(jp_, jx, je, jcfg)
    near(attention.cross_attention(tp_, tx, te, tcfg), want, mode)
    near(attention.cross_attention(tp_, tx, tkv, tcfg), want, mode)


# ---------------------------------------------------------------------------
# caches: full and ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,max_len,prompt", [
    (None, 32, 12),    # a full cache, whole softmax
    (16, 32, 12),      # a ring of 16 slots; decode wraps past 16
    (16, 32, 16),      # the prompt fills the ring exactly
    (None, 64, 10)])   # 64 slots take the chunked route
def test_attend_cache_and_ring_wrap_match_jax(window, max_len, prompt):
    jcfg, tcfg = configs("gemma3-4b")
    p = jax.tree.map(np.asarray, jattn.attn_init(jax.random.key(6), jcfg))
    jp_, tp_ = jax.tree.map(jnp.asarray, p), convert.params_from_numpy(
        p, "cpu")
    rng = np.random.default_rng(7)
    b, d = 2, jcfg.d_model
    jc = jattn.cache_init(jcfg, b, max_len, window, jnp.float32)
    tc = attention.cache_init(tcfg, b, max_len, window, torch.float32, "cpu")
    assert tc["k"].shape == jc["k"].shape
    jx, tx = both(normal(rng, b, prompt, d), "float32")
    jpos, tpos = positions(b, prompt)
    steps = [(jx, tx, jpos, tpos)]
    for t in range(prompt, prompt + 14):   # decode past the ring's end
        jx1, tx1 = both(normal(rng, b, 1, d), "float32")
        jp1, tp1 = positions(b, 1, t)
        steps.append((jx1, tx1, jp1, tp1))
    for jx_, tx_, jp, tp in steps:
        before = {k: v.clone() for k, v in tc.items()}
        jo, jc = jattn.attend_cache(jp_, jx_, jcfg, jc, jp, window=window)
        to, tc2 = attention.attend_cache(tp_, tx_, tcfg, tc, tp,
                                         window=window)
        assert all(torch.equal(before[k], tc[k]) for k in tc)   # functional
        tc = tc2
        near(to, jo)
        for k in ("k", "v"):
            near(tc[k], jc[k])
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------------------------------------
# the ring buffer's guard: a prefill longer than a windowed layer's slots
# ---------------------------------------------------------------------------


def gemma_prefill_gap(params, jcfg, toks) -> float:
    """JAX's prefill last logits against its own forward's, max abs."""
    want, _ = jmodel.forward(params, {"tokens": toks}, jcfg)
    got, _, _ = jmodel.prefill(params, {"tokens": toks}, jcfg, max_len=32)
    return float(jnp.abs(got - want[:, -1]).max())


@pytest.fixture(scope="module")
def gemma_fp32():
    jcfg, tcfg = configs("gemma3-4b")
    assert jcfg.windows[0] == 16 and jcfg.windows[-1] is None
    p = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), jcfg))
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 24)) \
        .astype(np.int32)
    return jcfg, tcfg, p, toks


def test_jax_prefill_past_the_ring_is_wrong(gemma_fp32):
    """Pins the reference's divergence (ROADMAP, caveats in the reference):
    JAX inserts a prompt's K/V at ``positions % slots`` before it attends,
    so a prompt longer than a windowed layer's 16 slots overwrites keys
    its own queries need.  12 and 16 tokens agree with ``forward``; 24 do
    not."""
    jcfg, _, p, toks = gemma_fp32
    jp = jax.tree.map(jnp.asarray, p)
    for s in (12, 16):
        assert gemma_prefill_gap(jp, jcfg, jnp.asarray(toks[:, :s])) < 1e-5
    gap = gemma_prefill_gap(jp, jcfg, jnp.asarray(toks))
    logits, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    assert gap > 0.5 * float(jnp.abs(logits[:, -1]).max()), gap


def test_port_raises_past_the_ring_and_matches_jax_up_to_it(gemma_fp32):
    jcfg, tcfg, p, toks = gemma_fp32
    jp, tp = jax.tree.map(jnp.asarray, p), convert.params_from_numpy(
        p, "cpu")
    with pytest.raises(ValueError, match="16 slots"):
        model.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 32)
    for s in (12, 16):
        want, _, _ = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                                    jcfg, max_len=32)
        got, _, _ = model.prefill(tp, {"tokens": torch.from_numpy(
            toks[:, :s].copy())}, tcfg, 32)
        near(got, want)
        fwd, _ = model.forward(tp, {"tokens": torch.from_numpy(
            toks[:, :s].copy())}, tcfg)
        near(got, fwd[:, -1])
    # a full cache is held to max_len the same way
    with pytest.raises(ValueError, match="8 slots"):
        attention.cache_insert(
            attention.cache_init(tcfg, 1, 8, None, torch.float32, "cpu"),
            torch.zeros(1, 9, 2, 16), torch.zeros(1, 9, 2, 16),
            torch.arange(9, dtype=torch.int32)[None])
