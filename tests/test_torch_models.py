"""The port's configs and Mamba model against the JAX package's.

The same params go through both: the JAX package's ``model.init`` makes
them, ``jax.tree.map(np.asarray, ...)`` and the port's
``convert.params_from_numpy`` carry them across.  Inputs are made with
numpy from a seed.

Tolerances (max abs error over the output, against the JAX value):

- fp32 (``dtype="float32"``, ``ssm_scan_dtype="float32"``): 1e-4 absolute
  and relative.  Both sides compute in fp32; JAX's chunked associative scan
  and the port's sequential scan sum in another order.
- falcon's dtypes (bf16 compute, ``ssm_scan_dtype="bfloat16"``) and the
  smoke config's (bf16 compute, fp32 scan): 5e-2 of the largest reference
  magnitude.  The port scans in fp32 where JAX keeps the scan in bf16, and
  the two frameworks round bf16 products and sums at other places, so a
  value may differ by a few bf16 ulps (2**-8 relative each).

The products run in full fp32 on both sides (the port never turns
``torch.backends.cuda.matmul.allow_tf32`` on; on the CPU there is no TF32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import skip_reason as jax_skip_reason
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.models import convert, mamba, model

ARCH_NAMES = sorted(JAX_ARCHS)
FALCON = "falcon-mamba-7b"
FP32 = dict(dtype="float32", ssm_scan_dtype="float32")
DTYPES = {"fp32": FP32, "smoke": {}, "falcon": dict(ssm_scan_dtype="bfloat16")}


def assert_near(got, want, mode):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if mode == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = float(np.abs(got - want).max())
        assert err <= 5e-2 * float(np.abs(want).max()), err


def configs(mode):
    return (jax_smoke(FALCON).with_(**DTYPES[mode]),
            tconfigs.get_smoke_config(FALCON).with_(**DTYPES[mode]))


def jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed), jcfg))


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_equal_jax_field_by_field(arch, smoke):
    want = jax_smoke(arch) if smoke else jax_get_config(arch)
    got = tconfigs.get_smoke_config(arch) if smoke \
        else tconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert (got.d_inner, got.dt_rank, got.n_periods, got.n_tail) == \
        (want.d_inner, want.dt_rank, want.n_periods, want.n_tail)
    assert model.padded_vocab(got) == jmodel.padded_vocab(want)
    assert set(tconfigs.SHAPES) == set(JAX_SHAPES)
    for shape in JAX_SHAPES:
        assert tconfigs.skip_reason(arch, shape) == \
            jax_skip_reason(arch, shape)
        assert dataclasses.asdict(tconfigs.SHAPES[shape]) == \
            dataclasses.asdict(JAX_SHAPES[shape])


def test_falcon_is_served_at_full_width():
    cfg = tconfigs.get_config(FALCON)
    assert (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
            cfg.n_layers) == (4096, 8192, 16, 256, 64)
    assert model.padded_vocab(cfg) == 65_536
    assert cfg.param_count() == JAX_ARCHS[FALCON].param_count()
    assert 6.9e9 < cfg.param_count() < 7.4e9


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_arch_builds_with_the_jax_tree_layout(arch):
    """Every arch of the zoo builds in the port (attention, MoE, dense
    FFNs, cross attention, the encoder and the frontends): the JAX
    package's tree, leaf for leaf in shape, in fp32."""
    jcfg, tcfg = jax_smoke(arch), tconfigs.get_smoke_config(arch)
    want = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jcfg))
    got = model.init(0, tcfg, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, want)) == \
        jax.tree.structure(convert.tree_map(lambda a: 0, got))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    assert sum(a.numel() for a in jax.tree.leaves(got)) == \
        sum(int(np.prod(w.shape)) for w in jax.tree.leaves(want))


# ---------------------------------------------------------------------------
# init: the JAX tree layout, the JAX scales
# ---------------------------------------------------------------------------


def test_init_has_the_jax_tree_layout_and_scales():
    jcfg, tcfg = configs("smoke")
    want = jax_params(jcfg)
    got = model.init(0, tcfg, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, want)) == \
        jax.tree.structure(convert.tree_map(lambda a: 0, got))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    mixer = got["blocks"]["p0"]["mixer"]
    ds = tcfg.ssm_state
    assert torch.equal(mixer["A_log"][0, 3],
                       torch.log(torch.arange(1, ds + 1.0)))
    assert torch.equal(mixer["D"], torch.ones_like(mixer["D"]))
    d = tcfg.d_model
    assert abs(float(mixer["in_proj"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(got["embed"]["table"].std()) - 0.02) < 0.002
    # the layers differ (one generator, consumed layer by layer)
    assert not torch.equal(mixer["in_proj"][0], mixer["in_proj"][1])
    again = model.init(0, tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves(again)))


def test_params_from_numpy_carries_bf16_and_casts():
    import ml_dtypes
    a = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    tree = {"x": [a.astype(ml_dtypes.bfloat16), None], "i": np.arange(3)}
    got = convert.params_from_numpy(tree, "cpu")
    assert got["x"][0].dtype == torch.bfloat16 and got["x"][1] is None
    assert torch.equal(got["x"][0].float(),
                       torch.from_numpy(a.astype(ml_dtypes.bfloat16)
                                        .astype(np.float32)))
    cast = convert.params_from_numpy(tree, "cpu", torch.float32)
    assert cast["x"][0].dtype == torch.float32
    assert cast["i"].dtype == torch.int64


# ---------------------------------------------------------------------------
# the mamba layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fp32", "falcon"])
def test_mamba_forward_matches_jax(mode):
    jcfg, tcfg = configs(mode)
    p = jax.tree.map(np.asarray, jmamba.mamba_init(jax.random.key(0), jcfg))
    x = np.random.default_rng(2).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    dt = jnp.dtype(jcfg.dtype)
    want, wst = jmamba.mamba_forward(to_jax(p), jnp.asarray(x, dt), jcfg,
                                     return_state=True)
    tp = convert.params_from_numpy(p, "cpu")
    got, st = mamba.mamba_forward(
        tp, convert.tensor_from_numpy(np.asarray(jnp.asarray(x, dt)), "cpu"),
        tcfg, return_state=True)
    assert got.dtype == getattr(torch, jcfg.dtype)
    assert_near(got, want, mode)
    assert_near(st["ssm"], wst["ssm"], mode)
    assert_near(st["conv"], wst["conv"], mode)


@pytest.mark.parametrize("mode", ["fp32", "falcon"])
def test_mamba_step_matches_jax(mode):
    jcfg, tcfg = configs(mode)
    p = jax.tree.map(np.asarray, jmamba.mamba_init(jax.random.key(0), jcfg))
    tp = convert.params_from_numpy(p, "cpu")
    rng = np.random.default_rng(3)
    dt = jnp.dtype(jcfg.dtype)
    jst = jmamba.mamba_state_init(jcfg, 2, dt)
    tst = mamba.mamba_state_init(tcfg, 2, getattr(torch, jcfg.dtype), "cpu")
    for _ in range(5):
        x = jnp.asarray(rng.standard_normal((2, 1, jcfg.d_model)), dt)
        want, jst = jmamba.mamba_step(to_jax(p), x, jcfg, jst)
        got, tst = mamba.mamba_step(
            tp, convert.tensor_from_numpy(np.asarray(x), "cpu"), tcfg, tst)
        assert_near(got, want, mode)
        assert_near(tst["ssm"], jst["ssm"], mode)
        assert_near(tst["conv"], jst["conv"], mode)


def test_mamba_forward_equals_its_steps():
    """The kernel route (prefill) and the decode route agree in fp32."""
    _, tcfg = configs("fp32")
    p = mamba.mamba_init(torch.Generator().manual_seed(0), tcfg)
    x = torch.randn((2, 12, tcfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    full, st = mamba.mamba_forward(p, x, tcfg, return_state=True)
    state = mamba.mamba_state_init(tcfg, 2, torch.float32, "cpu")
    steps = []
    for t in range(12):
        y, state = mamba.mamba_step(p, x[:, t:t + 1], tcfg, state)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, 1), full, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(state["ssm"], st["ssm"], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(state["conv"], st["conv"], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fp32", "smoke", "falcon"])
def test_forward_matches_jax(mode):
    jcfg, tcfg = configs(mode)
    p = jax_params(jcfg)
    toks = tokens(jcfg)
    want, _ = jmodel.forward(to_jax(p), {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = model.forward(convert.params_from_numpy(p, "cpu"),
                             {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape[-1] == model.padded_vocab(tcfg)
    assert_near(got, want, mode)


@pytest.mark.parametrize("mode", ["fp32", "falcon"])
def test_prefill_and_decode_step_match_jax(mode):
    jcfg, tcfg = configs(mode)
    p = jax_params(jcfg)
    tp = convert.params_from_numpy(p, "cpu")
    toks = tokens(jcfg)
    jlog, jcache, jpos = jmodel.prefill(to_jax(p),
                                        {"tokens": jnp.asarray(toks)}, jcfg,
                                        max_len=64)
    tlog, tcache, tpos = model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                       tcfg, max_len=64)
    assert_near(tlog, jlog, mode)
    assert torch.equal(tpos, torch.from_numpy(np.array(jpos)))
    jleaves = jax.tree.leaves(jcache)
    tleaves = jax.tree.leaves(tcache)
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        assert t.dtype == convert.tensor_from_numpy(np.asarray(j), "cpu").dtype
        assert_near(t, j, mode)
    # decode from JAX's own cache, so the step alone is compared
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for _ in range(3):
        jd, jcache2 = jmodel.decode_step(to_jax(p), jcache, jnp.asarray(tok),
                                         jpos, jcfg)
        td, tcache2 = model.decode_step(
            tp, convert.params_from_numpy(jax.tree.map(np.asarray, jcache),
                                          "cpu"),
            torch.from_numpy(tok), torch.from_numpy(np.array(jpos)), tcfg)
        assert td.shape == (2, 1, model.padded_vocab(tcfg))
        assert_near(td, jd, mode)
        for t, j in zip(jax.tree.leaves(tcache2),
                        jax.tree.leaves(jcache2)):
            assert_near(t, j, mode)
        jcache, jpos = jcache2, jpos + 1
        tok = np.argmax(np.asarray(jd[:, 0]), -1)[:, None].astype(np.int32)


def test_cast_params_gives_the_same_results():
    """The engine's cast-once copy gives the bits of JAX-style per-use
    casts."""
    _, tcfg = configs("smoke")
    p = model.init(0, tcfg, device="cpu")
    cp = model.cast_params(p, tcfg)
    assert cp["blocks"]["p0"]["mixer"]["in_proj"].dtype == torch.bfloat16
    assert cp["blocks"]["p0"]["mixer"]["A_log"].dtype == torch.float32
    assert cp["head"].dtype == torch.float32
    assert cp["embed"]["table"].dtype == torch.bfloat16
    batch = {"tokens": torch.from_numpy(tokens(tcfg))}
    assert torch.equal(model.forward(p, batch, tcfg)[0],
                       model.forward(cp, batch, tcfg)[0])
    la, ca, pa = model.prefill(p, batch, tcfg, 64)
    lb, cb, pb = model.prefill(cp, batch, tcfg, 64)
    assert torch.equal(la, lb)
    tok = la.argmax(-1)[:, None]
    assert torch.equal(model.decode_step(p, ca, tok, pa, tcfg)[0],
                       model.decode_step(cp, cb, tok, pb, tcfg)[0])
