"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's dense-global path (``repro.models.moe``).

Routing (the expert indices) must be equal, with capacity drops (the
smoke configs' default ``capacity_factor``, cut to 0.5 to force more of
them) and without (``capacity_factor=16``); the output and ``aux`` within
1e-4 in fp32, within 5e-2 of the largest magnitude in bf16 (the router
runs in fp32 on both sides, on the same bf16 input).  The combine must
give the same bits on every run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, moe

MOE_ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b",
             "jamba-1.5-large-398b")


def near(got, want, mode):
    got = np.asarray(got.float(), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if mode == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = float(np.abs(got - want).max())
        assert err <= 5e-2 * float(np.abs(want).max()), err


def setup(arch, mode, seed=0, **kw):
    dtype = dict(dtype="float32") if mode == "fp32" else {}
    jcfg = jax_smoke(arch).with_(**dtype, **kw)
    tcfg = get_smoke_config(arch).with_(**dtype, **kw)
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(seed), jcfg))
    return jcfg, tcfg, p


def inputs(jcfg, b=2, s=24, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(jcfg.dtype))
    return jx, convert.tensor_from_numpy(np.asarray(jx), "cpu")


@pytest.mark.parametrize("cf", [0.5, 1.25, 16.0],
                         ids=["many-drops", "default", "no-drops"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_and_dispatch_match_jax(arch, cf):
    jcfg, tcfg, p = setup(arch, "fp32", capacity_factor=cf)
    jx, tx = inputs(jcfg)
    xt_j, xt_t = jx.reshape(-1, jcfg.d_model), tx.reshape(-1, jcfg.d_model)
    jg, je, jaux = jmoe._route(jax.tree.map(jnp.asarray, p), xt_j, jcfg)
    tp = convert.params_from_numpy(p, "cpu")
    tg, te, taux = moe._route(tp, xt_t, tcfg)
    assert np.array_equal(te.numpy(), np.asarray(je))
    near(tg, jg, "fp32")
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    flat = np.asarray(je).reshape(-1)
    jpos = jmoe._positions_in_expert(jnp.asarray(flat), jcfg.moe_experts)
    tpos = moe._positions_in_expert(torch.from_numpy(flat.copy()).long(),
                                    tcfg.moe_experts)
    assert tpos.dtype == torch.int32
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    c = moe.capacity(tcfg, xt_t.shape[0])
    assert c == jmoe.capacity(jcfg, xt_j.shape[0])
    dropped = int((tpos >= c).sum())
    if cf == 16.0:
        assert dropped == 0
    if cf == 0.5:
        assert dropped > 0
    jy, jaux2 = jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jx, jcfg)
    ty, taux2 = moe.moe_ffn(tp, tx, tcfg)
    near(ty, jy, "fp32")
    assert abs(float(taux2) - float(jaux2)) <= 1e-5 * abs(float(jaux2))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax_in_bf16(arch):
    jcfg, tcfg, p = setup(arch, "bf16")
    jx, tx = inputs(jcfg, seed=2)
    jy, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jx, jcfg)
    tp = convert.params_from_numpy(p, "cpu")
    ty, taux = moe.moe_ffn(tp, tx, tcfg)
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    # the router is fp32 on the same bf16 input: the same experts
    _, je, _ = jmoe._route(jax.tree.map(jnp.asarray, p),
                           jx.reshape(-1, jcfg.d_model), jcfg)
    _, te, _ = moe._route(tp, tx.reshape(-1, jcfg.d_model), tcfg)
    assert np.array_equal(te.numpy(), np.asarray(je))
    near(ty, jy, "bf16")
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_dropped_tokens_contribute_nothing():
    """A capacity of 8 slots an expert for 96 routed slots: the tokens
    past it get zero from that expert, in both packages."""
    jcfg, tcfg, p = setup("phi3.5-moe-42b-a6.6b", "fp32",
                          capacity_factor=0.01)
    assert moe.capacity(tcfg, 48) == 8
    jx, tx = inputs(jcfg, seed=3)
    jy, _ = jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jx, jcfg)
    ty, _ = moe.moe_ffn(convert.params_from_numpy(p, "cpu"), tx, tcfg)
    near(ty, jy, "fp32")
    rows = ty.reshape(-1, tcfg.d_model).abs().sum(-1)
    assert int((rows == 0).sum()) > 0


def test_combine_is_deterministic():
    """The combine adds a token's k outputs one after another in the
    compute dtype (no atomics): the same bits on every call."""
    _, tcfg, p = setup("granite-moe-3b-a800m", "bf16")
    jcfg = jax_smoke("granite-moe-3b-a800m")
    _, tx = inputs(jcfg, seed=4)
    tp = convert.params_from_numpy(p, "cpu")
    ys = [moe.moe_ffn(tp, tx, tcfg)[0] for _ in range(3)]
    assert all(torch.equal(ys[0].view(torch.int16), y.view(torch.int16))
               for y in ys[1:])
