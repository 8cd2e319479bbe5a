"""The port's serving engine and launcher against the JAX package's, at
falcon-mamba-7b's smoke config (4 layers, d_model 64) in fp32.

Greedy tokens must be identical; the resumable ``(cache, pos)`` must agree
within 1e-4 (absolute and relative; fp32 on both sides, sums in another
order).  The params are JAX's, carried across with
``convert.params_from_numpy``.  Sessions page through the port's store on
the CPU at the serving launcher's 4 KiB values; a session JAX paged into
its own store loads in the port bit for bit.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.formats import SSTGeometry as JaxGeometry
from repro.launch import serve as jax_serve
from repro.lsm.db import DBConfig as JaxDBConfig
from repro.lsm.db import LsmDB as JaxDB
from repro.models import model as jmodel
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import Tracer as JaxTracer
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.formats import SSTGeometry
from repro_torch.launch import serve
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.models import convert, model
from repro_torch.models.convert import tree_map
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving import session_store
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.session_store import (LsmSessionStore,
                                               MemorySessionStore)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)   # same_state

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


# ServeEngine's two observability arguments, the port's and JAX's kinds
OBS = {"metrics": (MetricsRegistry, JaxRegistry),
       "tracer": (Tracer, JaxTracer)}


def serve_records(arg, obj) -> list:
    """What a registry or a tracer holds of the ``serve.*`` names: the
    histograms' (labels, count), or the spans' (name, args)."""
    if arg == "metrics":
        return sorted((tuple(sorted(h["labels"].items())), h["count"])
                      for h in obj.snapshot()["histograms"]
                      if h["name"] == "serve.op.latency_us")
    return [(e["name"], e["args"]) for e in obj.to_chrome()["traceEvents"]
            if e["ph"] == "X" and e["name"].startswith("serve.")]


@pytest.mark.parametrize("arg", ["metrics", "tracer"])
def test_serving_metrics_and_tracer(engines, tmp_path, arg):
    """ROADMAP A10: ``ServeEngine`` takes a registry and a tracer, records
    ``serve.op.latency_us{op=generate}`` and the ``serve.generate`` span
    into them, and defaults to its page store's; a generate, a page-out
    and two page-ins record what JAX's engine records."""
    jeng, teng = engines
    port_kind, jax_kind = OBS[arg]
    given = port_kind()
    eng = ServeEngine(teng.cfg, teng.params, max_len=64, device="cpu",
                      **{arg: given})
    assert getattr(eng, arg) is given
    eng.generate(prompts(2, 5), max_new=3)
    assert serve_records(arg, given) == (
        [((("op", op),), int(op == "generate")) for op in
         ("generate", "page_in", "page_in_many", "page_out")]
        if arg == "metrics" else
        [("serve.generate", {"batch": 2, "max_new": 3})])

    stores = (LsmDB(str(tmp_path / "port"), DBConfig(
                  geom=SSTGeometry(**KV), memtable_bytes=128 * 1024),
                  device="cpu", **{arg: port_kind()}),
              JaxDB(str(tmp_path / "jax"), JaxDBConfig(
                  geom=JaxGeometry(**KV), engine="cpu",
                  memtable_bytes=128 * 1024), **{arg: jax_kind()}))
    served = (paged(teng, stores[0]),
              JaxServeEngine(jeng.cfg, jeng.params, max_len=64,
                             page_store=stores[1]))
    seen = []
    for e, db in zip(served, stores):
        assert getattr(e, arg) is getattr(db, arg)   # the store's
        _, cache, pos = e.generate(prompts(1, 4), max_new=2)
        e.save_session("s", cache, pos)
        e.load_session("s")
        e.load_sessions(["s", "absent"], missing_ok=True)
        seen.append(serve_records(arg, getattr(db, arg)))
        db.close()
    assert seen[0] == seen[1]
    assert len(seen[0]) == 4 and (arg == "tracer" or
                                  all(n == 1 for _, n in seen[0]))


# the serving launcher's store, with tests/test_serving.py's smaller SSTs
# and memtable
KV = dict(key_bytes=16, value_bytes=4096, block_bytes=32 * 1024,
          sst_bytes=256 * 1024)


def port_pages(path):
    return LsmDB(str(path), DBConfig(geom=SSTGeometry(**KV),
                                     memtable_bytes=128 * 1024), device="cpu")


def jax_pages(path):
    return JaxDB(str(path), JaxDBConfig(geom=JaxGeometry(**KV), engine="cpu",
                                       memtable_bytes=128 * 1024))


def paged(teng, store=None, **kw):
    """The fixture's port engine again (the same params), with a store."""
    return ServeEngine(teng.cfg, teng.params, max_len=64, device="cpu",
                       page_store=store, **kw)


def decode_from(eng, state, last_tok, n):
    """``n`` greedy tokens from a resumable state, through ``_decode``."""
    cache, pos = state
    tok = torch.as_tensor(last_tok, dtype=torch.int32)
    outs = []
    for _ in range(n):
        logits, cache = eng._decode(eng.params, cache, tok, pos)
        tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
        outs.append(tok[:, 0].numpy())
        pos = pos + 1
    return np.stack(outs, 1)


def test_page_out_resume_equals_uninterrupted_and_jax(engines, tmp_path):
    """4 tokens, page out, reload, 4 more through ``_decode``: the 8 equal
    an uninterrupted run's, and JAX's."""
    jeng, teng = engines
    eng = paged(teng, port_pages(tmp_path / "pages"))
    p = prompts(2, 6)
    full, _, _ = eng.generate(p, max_new=8)
    np.testing.assert_array_equal(full, jeng.generate(p, max_new=8)[0])
    part, cache, pos = eng.generate(p, max_new=4)
    n = eng.save_session("sess-a", cache, pos)
    head = eng.store.get(eng.sessions._key("sess-a", 0))
    assert n == 1 + int.from_bytes(head[:4], "big")
    back = eng.load_session("sess-a")
    assert chip_smoke.same_state(back, (cache, pos))
    resumed = decode_from(eng, back, part[:, -1:], 4)
    np.testing.assert_array_equal(np.concatenate([part, resumed], 1), full)
    assert eng.drop_session("sess-a") is True
    assert not eng.sessions.exists("sess-a")
    eng.store.close()


def test_load_sessions_equals_the_load_session_loop(engines, tmp_path):
    _, teng = engines
    eng = paged(teng, port_pages(tmp_path / "pages"))
    _, cache, pos = eng.generate(prompts(1, 4), max_new=3)
    names = [f"sess-{i}" for i in range(3)]
    for i, s in enumerate(names):
        eng.save_session(s, tree_map(lambda x, i=i: x + i, cache), pos)
    for s, got in zip(names, eng.load_sessions(names)):
        assert chip_smoke.same_state(got, eng.load_session(s))
    assert eng.load_sessions(["sess-0", "nope"], missing_ok=True)[1] is None
    with pytest.raises(KeyError, match="nope"):
        eng.load_session("nope")
    assert eng.drop_session("sess-1") is True
    assert eng.drop_session("sess-1") is False
    eng.store.close()


def test_session_churn_is_reclaimed_by_compaction(engines, tmp_path):
    """Repeated saves of one session supersede its pages; the compactions
    drop them, and the session still loads as saved."""
    _, teng = engines
    eng = paged(teng, port_pages(tmp_path / "pages"))
    _, cache, pos = eng.generate(prompts(2, 4), max_new=2)
    for _ in range(4):   # an L0 file a save: the compaction trigger
        eng.save_session("hot-session", cache, pos)
        eng.store.flush()
    eng.store.maybe_compact()
    assert chip_smoke.same_state(eng.load_session("hot-session"),
                                 (cache, pos))
    s = eng.store.stats
    assert s.flushes >= 1 and s.compactions >= 1
    assert s.compact_entries_dropped > 0   # superseded pages reclaimed
    eng.store.close()


def test_session_store_arguments(engines, tmp_path):
    _, teng = engines
    db = port_pages(tmp_path / "pages")
    mem = MemorySessionStore(teng._state_template, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        paged(teng, db, session_store=mem)
    eng = paged(teng, session_store=mem)
    assert eng.sessions is mem and eng.store is None
    _, cache, pos = eng.generate(prompts(1, 3), max_new=2)
    assert eng.save_session("m", cache, pos) == 1
    assert chip_smoke.same_state(eng.load_session("m"), (cache, pos))
    bare = paged(teng)
    assert bare.sessions is None and bare.store is None
    for call in (lambda: bare.save_session("s", cache, pos),
                 lambda: bare.load_session("s"),
                 lambda: bare.load_sessions(["s"]),
                 lambda: bare.drop_session("s")):
        with pytest.raises(AssertionError, match="no session store"):
            call()
    db.close()


def test_port_resumes_a_session_jax_paged(engines, tmp_path):
    """JAX's engine pages a session into a JAX store directory; the port's
    store opens the directory, and the port's engine loads JAX's cache bit
    for bit and decodes JAX's tokens from it."""
    jeng, teng = engines
    path = tmp_path / "pages"
    jdb = jax_pages(path)
    jpaged = JaxServeEngine(jeng.cfg, jeng.params, max_len=64,
                            page_store=jdb)
    p = prompts(2, 5, seed=8)
    full = jpaged.generate(p, max_new=8)[0]
    part, jcache, jpos = jpaged.generate(p, max_new=4)
    jpaged.save_session("from-jax", jcache, jpos)
    jdb.flush()
    jdb.close()
    eng = paged(teng, port_pages(path))
    cache, pos = eng.load_session("from-jax")
    got = session_store._leaves((cache, pos))
    want = jax.tree.leaves((jcache, jpos))
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
    np.testing.assert_array_equal(
        decode_from(eng, (cache, pos), part[:, -1:], 4), full[:, 4:])
    eng.store.close()


def test_launcher_serves_on_the_cpu_when_asked(capsys, tmp_path,
                                              monkeypatch):
    args = ["--arch", FALCON, "--smoke", "--batch", "2", "--prompt-len",
            "5", "--max-new", "3"]
    monkeypatch.setattr(sys, "argv", ["serve", *args, "--page-dir",
                                      str(tmp_path / "jax")])
    jax_serve.main()
    jline = capsys.readouterr().out.splitlines()[2]
    records = int(jline.split("(")[1].split()[0])
    serve.main(args + ["--device", "cpu", "--page-dir",
                       str(tmp_path / "port")])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["req0", "req1"]
    assert len(json.loads(lines[0].split(": ")[1])) == 3
    # the same page-out as JAX's launcher: the state's shapes are the same
    assert records > 1
    assert lines[2] == (f"session paged to LSM store ({records} records, "
                        f"dir={tmp_path / 'port'})")
    db = LsmDB(str(tmp_path / "port"), DBConfig(geom=SSTGeometry(
        key_bytes=16, value_bytes=4096, block_bytes=32 * 1024,
        sst_bytes=512 * 1024)), device="cpu")
    store = LsmSessionStore(db, lambda: (model.init_cache(
        get_smoke_config(FALCON), 1, 8, device="cpu"), torch.zeros(1, 1)))
    assert store.exists("serve-cli")
    db.close()
    # the same tokens as the engine built by hand
    cfg = get_smoke_config(FALCON)
    eng = ServeEngine(cfg, model.init(0, cfg, device="cpu"), max_len=128,
                      device="cpu")
    p = np.random.default_rng(0).integers(0, cfg.vocab, (2, 5)).astype(
        np.int32)
    want = eng.generate(p, max_new=3)[0]
    assert lines[0] == f"req0: {want[0].tolist()}"


def test_prompts_may_come_as_lists_or_tensors(engines):
    _, teng = engines
    p = prompts(2, 4)
    a = teng.generate(p.tolist(), max_new=2)[0]
    b = teng.generate(torch.from_numpy(p), max_new=2)[0]
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32
