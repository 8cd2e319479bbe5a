"""The port's serving engine and launcher over the attention, MoE and
hybrid archs, against the JAX package's, at the smoke configs in fp32.

``ServeEngine.generate`` must give JAX's greedy tokens, and a resumable
``(cache, pos)`` within 1e-4 (absolute and relative; fp32 on both sides,
sums in another order), for qwen3 (qk-norm, GQA), gemma3 (windowed
layers whose ring buffers wrap while decoding), granite-moe (MoE) and
jamba (mamba, attention and MoE).  A gemma3 session pages through the
port's store and resumes as an uninterrupted run; its bytes are JAX's.
whisper (``frames``) and internvl2 (``patches``) are refused by
``generate`` and by the launcher, where JAX's fail for want of the same
input.  The params are JAX's, carried across with
``convert.params_from_numpy``.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.models import model as jmodel
from repro.serving import session_store as jss
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.formats import SSTGeometry
from repro_torch.launch import serve
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.models import convert
from repro_torch.serving import session_store as tss
from repro_torch.serving.engine import ServeEngine

FP32 = dict(dtype="float32", ssm_scan_dtype="float32")
SERVED = ("qwen3-14b", "gemma3-4b", "granite-moe-3b-a800m",
          "jamba-1.5-large-398b")
REFUSED = ("whisper-medium", "internvl2-26b")


def engines(arch, max_len=64):
    jcfg = jax_smoke(arch).with_(**FP32)
    tcfg = get_smoke_config(arch).with_(**FP32)
    jparams = jmodel.init(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return (JaxServeEngine(jcfg, jparams, max_len=max_len),
            ServeEngine(tcfg, tparams, max_len=max_len, device="cpu"))


def prompts(cfg, b=3, s=10, seed=4):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


@pytest.mark.parametrize("arch", SERVED)
def test_generate_equals_jax(arch):
    jeng, teng = engines(arch)
    p = prompts(teng.cfg)
    want, jcache, jpos = jeng.generate(p, max_new=12)   # past the 16 slots
    got, tcache, tpos = teng.generate(p, max_new=12)
    assert got.dtype == np.int32 and got.shape == (3, 12)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jl, tl = jax.tree.leaves(jcache), jax.tree.leaves(tcache)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   rtol=1e-4, atol=1e-4)


def test_gemma3_session_pages_resumes_and_is_jax_bytes(tmp_path):
    """A windowed-attention session: its ``(cache, pos)`` (k, v and the
    int32 slot positions of every layer) saved into the port's store
    loads back bit for bit, resumes as an uninterrupted generate, and
    encodes to the bytes JAX's encoder gives for JAX's own state."""
    jeng, teng = engines("gemma3-4b")
    p = prompts(teng.cfg, b=2, s=9)
    db = LsmDB(str(tmp_path / "pages"), DBConfig(geom=SSTGeometry(
        key_bytes=16, value_bytes=4096, block_bytes=32 * 1024,
        sst_bytes=512 * 1024), memtable_bytes=256 * 1024), device="cpu")
    try:
        eng = ServeEngine(teng.cfg, teng.params, max_len=teng.max_len,
                          device="cpu", page_store=db)
        out, cache, pos = eng.generate(p, max_new=6)
        n = eng.save_session("s", cache, pos)
        assert n > 1
        c, q = eng.load_session("s")
        assert all(torch.equal(a, b) for a, b in zip(
            convert.tree_leaves((c, q)), convert.tree_leaves((cache, pos))))
        tok = torch.from_numpy(out[:, -1:])
        resumed = []
        for _ in range(8):   # the windowed layers wrap past 16 positions
            logits, c = eng._decode(eng.params, c, tok, q)
            tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
            resumed.append(tok[:, 0].numpy())
            q = q + 1
        full = eng.generate(p, max_new=14)[0]
        np.testing.assert_array_equal(np.stack(resumed, 1), full[:, 6:])
    finally:
        db.close()
    jout, jcache, jpos = jeng.generate(p, max_new=6)
    np.testing.assert_array_equal(out, jout)
    port = convert.params_from_numpy(
        jax.tree.map(np.asarray, (jcache, jpos)), "cpu")
    assert tss.encode_state(port) == jss.encode_state((jcache, jpos))


@pytest.mark.parametrize("arch", REFUSED)
def test_generate_refuses_what_jax_cannot_serve(arch):
    jeng, teng = engines(arch)
    p = prompts(teng.cfg, b=1, s=4)
    with pytest.raises(KeyError):
        jeng.generate(p, max_new=2)
    with pytest.raises(ValueError, match="token prompts only"):
        teng.generate(p, max_new=2)


@pytest.mark.parametrize("arch", REFUSED)
def test_launcher_refuses_archs_jax_cannot_serve(arch, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--smoke", "--batch", "1",
        "--prompt-len", "4", "--max-new", "2",
        "--page-dir", str(tmp_path / "jax")])
    with pytest.raises(KeyError):
        jax_serve.main()
    with pytest.raises(ValueError, match="token prompts only"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--page-dir", str(tmp_path / "port")])
    assert not (tmp_path / "port").exists()   # refused before building


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m"])
def test_launcher_serves_attention_archs(arch, tmp_path, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "5", "--max-new", "3",
                "--page-dir", str(tmp_path / "pages")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("req0: [") and lines[1].startswith("req1: [")
    assert lines[-1].startswith("session paged to LSM store (")
