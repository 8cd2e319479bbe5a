"""The port's serving engine and launcher against the JAX package's, at
falcon-mamba-7b's smoke config (4 layers, d_model 64) in fp32.

Greedy tokens must be identical; the resumable ``(cache, pos)`` must agree
within 1e-4 (absolute and relative; fp32 on both sides, sums in another
order).  The params are JAX's, carried across with
``convert.params_from_numpy``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as jmodel
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import convert, model
from repro_torch.serving.engine import ServeEngine

FALCON = "falcon-mamba-7b"
FP32 = dict(dtype="float32", ssm_scan_dtype="float32")


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_smoke(FALCON).with_(**FP32)
    tcfg = get_smoke_config(FALCON).with_(**FP32)
    jparams = jmodel.init(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return (JaxServeEngine(jcfg, jparams, max_len=64),
            ServeEngine(tcfg, tparams, max_len=64, device="cpu"))


def prompts(b=3, s=10, seed=4):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("b,s,max_new", [(3, 10, 8), (1, 1, 4), (2, 17, 1)])
def test_generate_equals_jax(engines, b, s, max_new):
    jeng, teng = engines
    p = prompts(b, s)
    want, jcache, jpos = jeng.generate(p, max_new=max_new)
    got, tcache, tpos = teng.generate(p, max_new=max_new)
    assert got.dtype == np.int32 and got.shape == (b, max_new)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for t, j in zip(jax.tree.leaves(tcache), jax.tree.leaves(jcache)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def test_generate_accepts_eos_and_ignores_it(engines):
    """ROADMAP C3: ``generate(..., eos=...)`` runs, as JAX's does, and
    gives the tokens of a call without it (both packages decode
    ``max_new`` tokens whatever ``eos`` is)."""
    jeng, teng = engines
    p = prompts(2, 7, seed=11)
    plain = teng.generate(p, max_new=5)[0]
    eos = int(plain[0, 1])   # a token the run emits
    got = teng.generate(p, max_new=5, eos=eos)[0]
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jeng.generate(p, max_new=5,
                                                     eos=eos)[0])


def test_returned_state_is_resumable(engines):
    """4 tokens, then 4 more decoded from the returned ``(cache, pos)``,
    equal 8 uninterrupted tokens."""
    _, teng = engines
    p = prompts(2, 6)
    full, _, _ = teng.generate(p, max_new=8)
    part, cache, pos = teng.generate(p, max_new=4)
    np.testing.assert_array_equal(part, full[:, :4])
    tok = torch.from_numpy(part[:, -1:])
    outs = []
    for _ in range(4):
        logits, cache = model.decode_step(teng.params, cache, tok, pos,
                                          teng.cfg)
        tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
        outs.append(tok[:, 0].numpy())
        pos = pos + 1
    np.testing.assert_array_equal(np.stack(outs, 1), full[:, 4:])


@pytest.mark.parametrize("arg", ["page_store", "session_store", "metrics",
                                 "tracer"])
def test_session_paging_and_metrics_wait(engines, arg):
    _, teng = engines
    with pytest.raises(NotImplementedError, match="ROADMAP A1[01]"):
        ServeEngine(teng.cfg, teng.params, device="cpu", **{arg: object()})


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    serve.main(["--arch", FALCON, "--smoke", "--batch", "2",
                "--prompt-len", "5", "--max-new", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["req0", "req1"]
    assert len(json.loads(lines[0].split(": ")[1])) == 3
    assert "not ported yet (ROADMAP A11)" in lines[2]
    # the same tokens as the engine built by hand
    cfg = get_smoke_config(FALCON)
    eng = ServeEngine(cfg, model.init(0, cfg, device="cpu"), max_len=128,
                      device="cpu")
    p = np.random.default_rng(0).integers(0, cfg.vocab, (2, 5)).astype(
        np.int32)
    want = eng.generate(p, max_new=3)[0]
    assert lines[0] == f"req0: {want[0].tolist()}"


def test_launcher_refuses_archs_the_port_cannot_run():
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu"])


def test_prompts_may_come_as_lists_or_tensors(engines):
    _, teng = engines
    p = prompts(2, 4)
    a = teng.generate(p.tolist(), max_new=2)[0]
    b = teng.generate(torch.from_numpy(p), max_new=2)[0]
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32
