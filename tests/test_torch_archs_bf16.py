"""Every arch of the zoo at the smoke configs' own dtypes (bf16 compute)
through the port's model against the JAX package's: ``forward`` (logits
and ``aux``) and ``prefill`` (last logits and every cache leaf), whisper
with its ``frames``, internvl2 with its ``patches``; and the engine's
cast-once params (``model.cast_params``) against the fp32 tree.  Params
are JAX's, carried across with ``convert.params_from_numpy``; inputs are
numpy from a seed (``tests/test_torch_archs.py`` holds the same archs in
fp32, with decode).

Tolerance (as ``tests/test_torch_models.py``): within 5e-2 of the largest
reference magnitude; the two frameworks round bf16 products and sums at
other places.  jamba is the exception, on two counts:

- Its MoE routings are not equal in bf16: a near-tie of two experts'
  probabilities is decided by a bf16 ulp of the hidden state, and the two
  frameworks round it differently.  Against JAX run eagerly
  (``jax.disable_jit``), of the 8 MoE layers x 48 tokens of a 2 x 24
  forward, the port routes 9 tokens otherwise at seed 1, 20 at seed 2, 24
  at seed 3, 18 at seed 4 and 6 at seed 5 (in the first MoE layer 0, 1,
  0, 2, 0), and the last logits then move by 0.33-0.84 of the largest.
  (JAX jitted against JAX eager moves them by 0.31-0.36.)  So its check
  puts JAX's expert choices into both routers (``forced_route``,
  ``jax_forced_route``): the gates, the dispatch and every other layer
  stay each framework's own.
- On the same routing, bf16 rounding through its 16 layers moves JAX's
  own logits from its fp32 logits by 0.17, 0.13 and 0.10 of the largest
  at seeds 1-3, more than 5e-2, and the port's bf16 logits lie 0.084,
  0.080 and 0.077 from JAX's bf16 ones (0.046-0.074 at one period of 8
  layers; in fp32 the two agree to 1e-4).  So jamba's bf16 logits are held
  to JAX's own bf16 error on the same routing: ``forward``'s no farther
  from JAX's bf16 logits than those are from the fp32 ones, and the
  port's bf16 error against the fp32 logits within twice JAX's (at seeds
  1-3: ``forward`` 0.16, 0.10, 0.10 against JAX's 0.17, 0.13, 0.10; the
  last logits of a 12-token ``prefill`` 0.035, 0.049, 0.065 against
  0.037, 0.042, 0.035).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, model, moe

ARCHS = sorted(JAX_ARCHS)
PROMPT, FWD = 12, 24          # prefill within the smoke windows (16)
MAX_LEN = 32


def near(got, want):
    got = np.asarray(got.float(), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= 5e-2 * float(np.abs(want).max()), err


def batch_for(cfg, s, seed=1, b=2):
    """numpy inputs: tokens, plus frames (enc-dec) or patches (vision)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal((b, 20, cfg.d_model)).astype(
            np.float32)
    return out


def on_both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.copy()) for k, v in batch.items()})


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "jamba-1.5-large-398b"])
def test_forward_and_prefill_match_jax_bf16(arch):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    assert tcfg.dtype == "bfloat16"
    p = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), jcfg))
    tp = convert.params_from_numpy(p, "cpu")
    jp = jax.tree.map(jnp.asarray, p)
    jb, tb = on_both(batch_for(jcfg, FWD))
    want, jaux = jmodel.forward(jp, jb, jcfg)
    got, taux = model.forward(tp, tb, tcfg)
    near(got, want)
    assert abs(float(taux) - float(jaux)) <= 1e-3 * max(1.0, abs(float(jaux)))
    jb, tb = on_both(batch_for(jcfg, PROMPT, seed=2))
    ml = MAX_LEN + (jcfg.frontend_len if jcfg.frontend == "vision" else 0)
    jlog, jcache, _ = jmodel.prefill(jp, jb, jcfg, ml)
    tlog, tcache, _ = model.prefill(tp, tb, tcfg, ml)
    near(tlog, jlog)
    for t, j in zip(jax.tree.leaves(tcache), jax.tree.leaves(jcache)):
        assert t.dtype == convert.tensor_from_numpy(np.asarray(j),
                                                    "cpu").dtype
        near(t, j)


def forced_route(eidxs: list):
    """``moe._route`` with the expert choices taken in turn from
    ``eidxs`` (numpy ``[t, k]``, one a MoE call): the gates are the
    port's fp32 probabilities at those experts, renormalised, and ``aux``
    is counted from them, as ``moe._route`` counts it."""
    queue = list(eidxs)

    def route(params, xt, cfg):
        e = cfg.moe_experts
        probs = torch.softmax(torch.matmul(
            xt.to(torch.float32), params["router"].to(torch.float32)), -1)
        eidx = torch.from_numpy(queue.pop(0).copy()).to(torch.int64)
        gates = probs.gather(-1, eidx)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        hits = eidx.reshape(-1, 1) == torch.arange(e)
        ce = hits.sum(0).to(torch.float32) / eidx.numel()
        return gates, eidx, e * torch.sum(probs.mean(0) * ce)

    return route, queue


def jax_forced_route(eidxs: list):
    """``forced_route`` for JAX's ``moe._route``."""
    queue = list(eidxs)

    def route(params, xt, cfg):
        e = cfg.moe_experts
        probs = jax.nn.softmax(xt.astype(jnp.float32)
                               @ params["router"].astype(jnp.float32), -1)
        eidx = jnp.asarray(queue.pop(0))
        gates = jnp.take_along_axis(probs, eidx, -1)
        gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
        ce = jnp.zeros((e,), jnp.float32).at[eidx.reshape(-1)].add(
            1.0) / eidx.size
        return gates, eidx, e * jnp.sum(probs.mean(0) * ce)

    return route, queue


def jax_routed(fn, *args):
    """``fn(*args)`` run eagerly, with each MoE call's expert choices."""
    eidxs = []
    route = jmoe._route

    def watch(params, xt, cfg):
        out = route(params, xt, cfg)
        eidxs.append(np.asarray(out[1]))
        return out

    with jax.disable_jit(), mock.patch.object(jmoe, "_route", watch):
        return fn(*args), eidxs


def gap(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_jamba_matches_jax_bf16_on_jax_routing(seed):
    """jamba in bf16, whole, on JAX's expert choices (module docstring):
    ``forward``'s logits no farther from JAX's bf16 ones than those are
    from JAX's fp32 ones on the same routing; the port's bf16 logits of
    ``forward`` and ``prefill`` no more than twice as far from JAX's fp32
    ones as JAX's bf16 logits are; ``aux`` within 1e-3; the port's own
    routing agrees with JAX's at >= 90 % of the tokens."""
    arch = "jamba-1.5-large-398b"
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    assert tcfg.dtype == "bfloat16"
    j32 = jcfg.with_(dtype="float32", ssm_scan_dtype="float32")
    p = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), jcfg))
    tp = convert.params_from_numpy(p, "cpu")
    jp = jax.tree.map(jnp.asarray, p)

    def held(fn, tfn, batch, *rest):
        """JAX's bf16 run of ``fn(params, batch, cfg, *rest)``, its fp32
        run on the same routing, and the port's bf16 run of ``tfn`` on
        it; returns the three outputs and the routing."""
        jb, tb = on_both(batch)
        want, eidxs = jax_routed(fn, jp, jb, jcfg, *rest)
        route, left = jax_forced_route(eidxs)
        with jax.disable_jit(), mock.patch.object(jmoe, "_route", route):
            exact = fn(jp, jb, j32, *rest)
        assert not left
        route, left = forced_route(eidxs)
        with mock.patch.object(moe, "_route", route):
            got = tfn(tp, tb, tcfg, *rest)
        assert not left
        return want, exact, got, eidxs

    batch = batch_for(jcfg, FWD, seed=seed)
    (want, jaux), (exact, _), (got, taux), eidxs = held(
        jmodel.forward, model.forward, batch)
    assert len(eidxs) == tcfg.n_layers // 2   # every other layer is MoE
    assert gap(got, want) <= gap(want, exact)
    assert gap(got, exact) <= 2 * gap(want, exact)
    assert abs(float(taux) - float(jaux)) <= 1e-3 * max(1.0, abs(float(jaux)))
    own = []
    route = moe._route

    def watch(params, xt, cfg):
        out = route(params, xt, cfg)
        own.append(out[1].numpy())
        return out

    with mock.patch.object(moe, "_route", watch):
        model.forward(tp, on_both(batch)[1], tcfg)
    agree = np.mean([(np.sort(a, -1) == np.sort(b, -1)).all(-1).mean()
                     for a, b in zip(own, eidxs)])
    assert agree >= 0.9, agree
    (jlog, _, _), (elog, _, _), (tlog, _, _), _ = held(
        jmodel.prefill, model.prefill, batch_for(jcfg, PROMPT, seed=seed + 1),
        MAX_LEN)
    assert gap(tlog, elog) <= 2 * gap(jlog, elog)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b",
                                  "jamba-1.5-large-398b",
                                  "granite-moe-3b-a800m", "gemma3-4b"])
def test_cast_params_gives_the_same_bits(arch):
    """The engine's cast-once copy: matrices in bf16, the router, the
    norms (the q/k norms too) and the head in fp32; forward, prefill and
    a decode step give the bits of the fp32 tree's per-use casts."""
    tcfg = get_smoke_config(arch)
    p = model.init(0, tcfg, device="cpu")
    cp = model.cast_params(p, tcfg)
    bf16, f32 = torch.bfloat16, torch.float32
    blk = cp["blocks"]["p0"] if tcfg.n_periods else cp["tail"][0]
    for part, leaves in blk.items():
        for name, leaf in leaves.items():
            if isinstance(leaf, dict):    # the q/k norms
                leaf = leaf["scale"]
            cast = name in ("wq", "wk", "wv", "wo", "wi", "wg", "in_proj",
                            "conv_w", "x_proj", "dt_w", "out_proj")
            assert leaf.dtype == (bf16 if cast else f32), (part, name)
    assert cp["final_norm"]["scale"].dtype == f32
    if "frontend" in cp:
        assert cp["frontend"]["proj"].dtype == bf16
    if tcfg.enc_dec:
        assert cp["enc_blocks"]["p0"]["mixer"]["wq"].dtype == bf16
        assert cp["enc_norm"]["scale"].dtype == f32
    assert model._head(cp).dtype == f32
    tb = {k: torch.from_numpy(v) for k, v in
          batch_for(tcfg, PROMPT, seed=3).items()}
    assert torch.equal(model.forward(p, tb, tcfg)[0],
                       model.forward(cp, tb, tcfg)[0])
    ml = MAX_LEN + (tcfg.frontend_len if tcfg.frontend == "vision" else 0)
    la, ca, pa = model.prefill(p, tb, tcfg, ml)
    lb, cb, pb = model.prefill(cp, tb, tcfg, ml)
    assert torch.equal(la, lb)
    enc = model._encode(p, tb["frames"], tcfg)[0] if tcfg.enc_dec else None
    tok = la.argmax(-1)[:, None].to(torch.int32)
    assert torch.equal(
        model.decode_step(p, ca, tok, pa, tcfg, enc_out=enc)[0],
        model.decode_step(cp, cb, tok, pb, tcfg, enc_out=enc)[0])
