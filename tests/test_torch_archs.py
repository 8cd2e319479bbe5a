"""Every arch of the zoo through the port's model against the JAX
package's, at the smoke configs: ``forward`` (logits and ``aux``),
``prefill`` (last logits and every cache leaf) and 4 decode steps, each
from JAX's own cache so that the step alone is compared; whisper with its
``frames`` and the encoder output (``_encode``) as ``enc_out``, internvl2
with its ``patches``.  Params are JAX's, carried across with
``convert.params_from_numpy``; inputs are numpy from a seed.

Tolerance (as ``tests/test_torch_models.py``): fp32 within 1e-4
absolute and relative.  The smoke dtypes (bf16) are held in
``tests/test_torch_archs_bf16.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as jmodel
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, model

ARCHS = sorted(JAX_ARCHS)
FP32 = dict(dtype="float32", ssm_scan_dtype="float32")
PROMPT, FWD = 12, 24          # prefill within the smoke windows (16)
MAX_LEN = 32


def near(got, want):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


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


def setup(arch):
    jcfg = jax_smoke(arch).with_(**FP32)
    tcfg = get_smoke_config(arch).with_(**FP32)
    p = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), jcfg))
    return jcfg, tcfg, p, convert.params_from_numpy(p, "cpu")


def on_both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.copy()) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def jax_decode(jcfg):
    return jax.jit(functools.partial(jmodel.decode_step, cfg=jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax_fp32(arch):
    jcfg, tcfg, p, tp = setup(arch)
    jp = jax.tree.map(jnp.asarray, p)
    jb, tb = on_both(batch_for(jcfg, FWD))
    want, jaux = jmodel.forward(jp, jb, jcfg)
    got, taux = model.forward(tp, tb, tcfg)
    assert got.dtype == torch.float32
    assert got.shape[-1] == model.padded_vocab(tcfg)
    near(got, want)
    assert abs(float(taux) - float(jaux)) <= 1e-5 * max(1.0, abs(float(jaux)))
    if tcfg.moe_experts:
        assert float(taux) > 0

    jb, tb = on_both(batch_for(jcfg, PROMPT, seed=2))
    ml = MAX_LEN + (jcfg.frontend_len if jcfg.frontend == "vision" else 0)
    jlog, jcache, jpos = jmodel.prefill(jp, jb, jcfg, ml)
    tlog, tcache, tpos = model.prefill(tp, tb, tcfg, ml)
    near(tlog, jlog)
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    jl, tl = jax.tree.leaves(jcache), jax.tree.leaves(tcache)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert t.dtype == convert.tensor_from_numpy(np.asarray(j),
                                                    "cpu").dtype
        near(t, j)

    jenc = tenc = None
    if jcfg.enc_dec:
        jenc, _ = jmodel._encode(jp, jb["frames"], jcfg)
        tenc, _ = model._encode(tp, tb["frames"], tcfg)
        near(tenc, jenc)
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for _ in range(4):
        jd, jcache2 = jax_decode(jcfg)(jp, jcache, jnp.asarray(tok), jpos,
                                       enc_out=jenc)
        td, tcache2 = model.decode_step(
            tp, convert.params_from_numpy(jax.tree.map(np.asarray, jcache),
                                          "cpu"),
            torch.from_numpy(tok), torch.from_numpy(np.array(jpos)), tcfg,
            enc_out=tenc)
        assert td.shape == (2, 1, model.padded_vocab(tcfg))
        near(td, jd)
        for t, j in zip(jax.tree.leaves(tcache2), jax.tree.leaves(jcache2)):
            near(t, j)
        jcache, jpos = jcache2, jpos + 1
        tok = np.argmax(np.asarray(jd[:, 0]), -1)[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ["gemma3-4b", "jamba-1.5-large-398b",
                                  "whisper-medium"])
def test_decode_continues_the_forward(arch):
    """The port alone, fp32 and drop-free MoE: prefill then teacher-forced
    decode steps give the forward's logits at every position, the
    windowed layers' ring wrapping past its 16 slots on the way (the JAX
    package's own ``test_decode_matches_forward``, held at 1e-4)."""
    tcfg = get_smoke_config(arch).with_(capacity_factor=16.0, **FP32)
    p = model.init(0, tcfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batch_for(tcfg, 28,
                                                      seed=4).items()}
    full, _ = model.forward(p, b, tcfg)
    prefix = 8
    pb = dict(b, tokens=b["tokens"][:, :prefix])
    logit, cache, pos = model.prefill(p, pb, tcfg, max_len=MAX_LEN)
    torch.testing.assert_close(logit, full[:, prefix - 1], rtol=1e-4,
                               atol=1e-4)
    enc = model._encode(p, b["frames"], tcfg)[0] if tcfg.enc_dec else None
    for i in range(prefix, 28):
        logit, cache = model.decode_step(p, cache, b["tokens"][:, i:i + 1],
                                         pos, tcfg, enc_out=enc)
        torch.testing.assert_close(logit[:, 0], full[:, i], rtol=1e-4,
                                   atol=1e-4)
        pos = pos + 1
