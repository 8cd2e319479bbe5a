"""The port's session store against the JAX package's, on the CPU.

The same seeded states (numpy, then each package's arrays) go through
``repro.serving.session_store`` and ``repro_torch.serving.session_store``:
``encode_state`` must give the same ``(meta, raw)`` bytes, and the same
save / shrinking overwrite / drop sequence through JAX's
``LsmSessionStore`` over ``LsmDB(engine="cpu")`` and the port's over
``LsmDB(device="cpu")`` must return the same counts, write byte-identical
SST files and read back the same values.  The port's WAL batch record must
be JAX's bytes, and linear in the batch.
"""

import importlib.util
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import SchedulerConfig as JScheduler
from repro.lsm import wal as jwal
from repro.lsm.db import DBConfig as JConfig
from repro.lsm.db import LsmDB as JDB
from repro.lsm.sharded import ShardedDB as JSharded
from repro.lsm.sharded import uniform_boundaries as jax_uniform
from repro.models import model as jmodel
from repro.serving import session_store as jss
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.lsm import wal
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.lsm.sharded import ShardedDB, uniform_boundaries
from repro_torch.models import convert
from repro_torch.serving import session_store as tss

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)   # same_state

# tests/test_session_store.py's geometry and scheduler
GEOM = dict(key_bytes=16, value_bytes=256, block_bytes=4096,
            sst_bytes=32 * 1024)


def jax_db(path):
    return JDB(str(path), JConfig(
        geom=JGeometry(**GEOM), engine="cpu", memtable_bytes=4096,
        scheduler=JScheduler(l0_trigger=3, base_bytes=400_000)))


def port_db(path, geom=None):
    return LsmDB(str(path), DBConfig(
        geom=geom or SSTGeometry(**GEOM), memtable_bytes=4096,
        scheduler=SchedulerConfig(l0_trigger=3, base_bytes=400_000)),
        device="cpu")


def falcon_state(seed=0, batch=2):
    """falcon-mamba-7b's smoke ``(cache, pos)`` (bf16 conv, fp32 SSM state)
    filled from a seed, as numpy arrays."""
    rng = np.random.default_rng(seed)
    cfg = jax_smoke("falcon-mamba-7b")
    cache = jmodel.init_cache(cfg, batch, 16)

    def fill(a):
        return rng.standard_normal(a.shape).astype(np.asarray(a).dtype)

    pos = np.full((batch, 1), 11 + seed, np.int32)
    return (jax.tree.map(fill, cache), pos)


def unsorted_state(seed=1):
    rng = np.random.default_rng(seed)
    return {"z": rng.standard_normal((3, 5)).astype(np.float32),
            "a": {"y": rng.integers(0, 9, (4,)).astype(np.int32),
                  "b": rng.standard_normal((2, 2)).astype(jnp.bfloat16)},
            "m": [rng.standard_normal(7).astype(np.float32), None]}


def periods_state(seed=2):
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.standard_normal((i + 1, 3)).astype(np.float32)
            for i in (2, 10, 1)}


def small_state(rng, i, big=False):
    shape = (8, 97) if big else (3, 17)
    return {"kv": rng.standard_normal(shape).astype(np.float32),
            "pos": np.asarray([i], np.int32)}


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def as_port(tree):
    return convert.params_from_numpy(tree, "cpu")


def as_numpy(tree):
    """A port state as numpy arrays in JAX's leaf order (bf16 leaves as
    their bit patterns)."""
    out = []
    for t in tss._leaves(tree):
        if t.dtype == torch.bfloat16:
            out.append(("bfloat16", t.view(torch.int16).numpy()))
        else:
            out.append((str(t.dtype), t.numpy()))
    return out


def jax_numpy(tree):
    out = []
    for a in jax.tree.leaves(tree):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            out.append(("bfloat16", a.view(np.int16)))
        else:
            out.append((str(a.dtype), a))
    return out


def assert_same(port_state, jax_state):
    """The two states hold the same leaves, bit for bit, in JAX's order."""
    p, j = as_numpy(port_state), jax_numpy(jax_state)
    assert len(p) == len(j)
    for (pd, pa), (jd, ja) in zip(p, j):
        assert pd.removeprefix("torch.") == jd
        assert pa.shape == ja.shape and pa.tobytes() == ja.tobytes()


def sst_files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".sst")}


STATES = {"falcon": falcon_state, "unsorted": unsorted_state,
          "periods": periods_state}


@pytest.mark.parametrize("name", sorted(STATES))
def test_encode_state_is_jax_bytes(name):
    state = STATES[name]()
    want = jss.encode_state(as_jax(state))
    got = tss.encode_state(as_port(state))
    assert got[0] == want[0]          # the JSON metadata, to the byte
    assert got[1] == want[1]          # the leaves' bytes
    assert b"torch" not in got[0]


@pytest.mark.parametrize("name", sorted(STATES))
def test_decode_state_round_trips(name):
    state = as_port(STATES[name]())
    meta, raw = tss.encode_state(state)
    back = tss.decode_state(meta, raw, state, "cpu")
    assert chip_smoke.same_state(back, state)
    # the template's structure, keys in its own order
    if isinstance(state, dict):
        assert list(back) == list(state)
    # JAX's decode of the port's bytes is the same state
    assert_same(back, jss.decode_state(meta, raw, as_jax(STATES[name]())))
    with pytest.raises(IOError, match="leaves"):
        tss.decode_state(meta, raw, {"only": torch.zeros(1)}, "cpu")


def test_decode_state_puts_leaves_on_the_card_unless_asked(monkeypatch):
    meta, raw = tss.encode_state(as_port(periods_state()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tss.decode_state(meta, raw, as_port(periods_state()))


def run_sequence(store, states):
    """Saves, a shrinking overwrite, drops, and the counts they return."""
    out = [store.save("a", states["a_big"]), store.save("b", states["b"]),
           store.save("c", states["c_big"]),
           store.save("a", states["a_small"]),   # shrinks: stale tail
           store.drop("b"), store.drop("b"), store.save("b", states["b2"]),
           store.drop("c"), store.exists("a"), store.exists("c")]
    # overwrites enough for flushes and compactions that drop old pages
    out += [store.save(f"d{i % 2}", states["c_big" if i % 3 else "b2"])
            for i in range(6)]
    return out


def sequence_states():
    rng = np.random.default_rng(5)
    return {"a_big": small_state(rng, 0, big=True), "b": small_state(rng, 1),
            "c_big": small_state(rng, 2, big=True),
            "a_small": small_state(rng, 3), "b2": small_state(rng, 4, True)}


def template():
    return {"kv": torch.zeros((1, 1)),
            "pos": torch.zeros(1, dtype=torch.int32)}


def jax_template():
    return {"kv": jnp.zeros((1, 1), jnp.float32),
            "pos": jnp.zeros((1,), jnp.int32)}


def test_same_sequence_same_files_as_jax(tmp_path):
    states = sequence_states()
    jdb, tdb = jax_db(tmp_path / "jax"), port_db(tmp_path / "port")
    jstore = jss.LsmSessionStore(jdb, jax_template)
    tstore = tss.LsmSessionStore(tdb, template)
    want = run_sequence(jstore, {k: as_jax(v) for k, v in states.items()})
    got = run_sequence(tstore, {k: as_port(v) for k, v in states.items()})
    assert got == want
    assert tdb.stats.flushes > 2 and tdb.stats.compactions > 0
    assert tdb.stats.compact_entries_dropped > 0
    assert tdb.level_sizes() == jdb.level_sizes()
    assert sst_files(tdb.path) == sst_files(jdb.path)
    for s in ("a", "b", "c", "d0", "d1"):
        for i in range(200):
            k = tss.LsmSessionStore._key(s, i)
            assert k == jss.LsmSessionStore._key(s, i)
            assert tdb.get(k) == jdb.get(k)
    assert chip_smoke.same_state(tstore.load("a"), as_port(states["a_small"]))
    assert_same(tstore.load("b"), jstore.load("b"))
    jdb.close()
    tdb.close()


def test_load_many_equals_the_load_loop_and_jax(tmp_path):
    rng = np.random.default_rng(7)
    states = {f"s{i:02d}": small_state(rng, i, big=(i % 3 == 0))
              for i in range(8)}
    names = sorted(states)
    jdb, tdb = jax_db(tmp_path / "jax"), port_db(tmp_path / "port")
    jstore = jss.LsmSessionStore(jdb, jax_template)
    tstore = tss.LsmSessionStore(tdb, template)
    for s, st in states.items():
        jstore.save(s, as_jax(st))
        tstore.save(s, as_port(st))
    batched = tstore.load_many(names)
    jbatched = jstore.load_many(names)
    for s, b, jb in zip(names, batched, jbatched):
        assert chip_smoke.same_state(b, tstore.load(s))
        assert chip_smoke.same_state(b, as_port(states[s]))
        assert_same(b, jb)
    jdb.close()
    tdb.close()


def test_missing_and_truncated_sessions(tmp_path):
    db = port_db(tmp_path / "db")
    store = tss.LsmSessionStore(db, template)
    rng = np.random.default_rng(0)
    store.save("have", as_port(small_state(rng, 0, big=True)))
    with pytest.raises(KeyError, match="nope"):
        store.load("nope")
    with pytest.raises(KeyError, match="nope"):
        store.load_many(["have", "nope"])
    out = store.load_many(["nope", "have"], missing_ok=True)
    assert out[0] is None
    assert chip_smoke.same_state(out[1], store.load("have"))
    assert store.exists("have") and not store.exists("nope")
    assert store.drop("nope") is False
    # a head whose chunks are gone: loud, not garbage
    db.delete(tss.LsmSessionStore._key("have", 2))
    with pytest.raises(IOError, match="truncated"):
        store.load("have")
    with pytest.raises(IOError, match="truncated"):
        store.load_many(["have"])
    db.close()


def test_sessions_page_through_sharded_stores_as_jax(tmp_path):
    """The smoke config's sessions through both packages' ``ShardedDB``
    (4 shards, ``uniform_boundaries``; a session's keys share its hash
    prefix, so each session lives in one shard): the same counts, the
    same SST files in every shard, and the states load back bit for bit,
    equal to JAX's loads.  The queue compacts at fixed points
    (``auto_compact=False``): a background round's timing would decide
    the file numbers."""
    cuts = uniform_boundaries(4)
    assert cuts == jax_uniform(4)
    sched = dict(l0_trigger=3, base_bytes=400_000)
    jdb = JSharded(str(tmp_path / "jax"), JConfig(
        geom=JGeometry(**GEOM), engine="cpu", memtable_bytes=4096,
        scheduler=JScheduler(**sched), auto_compact=False), boundaries=cuts)
    tdb = ShardedDB(str(tmp_path / "port"), DBConfig(
        geom=SSTGeometry(**GEOM), memtable_bytes=4096,
        scheduler=SchedulerConfig(**sched), auto_compact=False),
        boundaries=cuts, device="cpu")
    states = {f"s{i}": falcon_state(i) for i in range(6)}
    jstore = jss.LsmSessionStore(jdb, as_jax(states["s0"]))
    tstore = tss.LsmSessionStore(tdb, as_port(states["s0"]))
    got, want = [], []
    for s, st in states.items():
        got.append(tstore.save(s, as_port(st)))
        want.append(jstore.save(s, as_jax(st)))
        tdb.maybe_compact()
        jdb.maybe_compact()
    assert got == want
    got += [tstore.drop("s2"), tstore.save("s1", as_port(states["s4"]))]
    want += [jstore.drop("s2"), jstore.save("s1", as_jax(states["s4"]))]
    assert got == want
    tdb.flush()
    jdb.flush()
    tdb.maybe_compact()
    jdb.maybe_compact()
    shards_used = {tdb.shard_of(tss.LsmSessionStore._key(s, 0))
                   for s in states}
    assert len(shards_used) > 1 and tdb.stats.compactions > 0
    assert tdb.level_sizes() == jdb.level_sizes()
    for i in range(4):
        assert sst_files(tmp_path / "port" / f"shard-{i:04d}") == \
            sst_files(tmp_path / "jax" / f"shard-{i:04d}")
    names = ["s0", "s1", "s3", "s5"]
    for s, b, jb in zip(names, tstore.load_many(names),
                        jstore.load_many(names)):
        want_state = states["s4" if s == "s1" else s]
        assert chip_smoke.same_state(b, as_port(want_state))
        assert chip_smoke.same_state(tstore.load(s), b)
        assert_same(b, jb)
    assert not tstore.exists("s2") and not jstore.exists("s2")
    jdb.close()
    tdb.close()


def test_short_keys_are_refused(tmp_path):
    db = port_db(tmp_path / "db", SSTGeometry(
        key_bytes=12, value_bytes=256, block_bytes=4096, sst_bytes=32768))
    with pytest.raises(ValueError, match="key_bytes >= 16"):
        tss.LsmSessionStore(db, template)
    db.close()


def test_memory_store_decodes_as_the_lsm_store(tmp_path):
    state = as_port(falcon_state(3))
    mem = tss.MemorySessionStore(lambda: state, device="cpu")
    db = port_db(tmp_path / "db")
    lsm = tss.LsmSessionStore(db, state)
    assert isinstance(mem, tss.SessionStore)
    assert isinstance(lsm, tss.SessionStore)
    assert mem.save("x", state) == 1
    lsm.save("x", state)
    assert chip_smoke.same_state(mem.load("x"), lsm.load("x"))
    assert chip_smoke.same_state(mem.load_many(["x"])[0], state)
    assert mem.load_many(["y", "x"], missing_ok=True)[0] is None
    with pytest.raises(KeyError, match="y"):
        mem.load("y")
    with pytest.raises(KeyError, match="y"):
        mem.load_many(["y"])
    assert mem.exists("x") and mem.drop("x") and not mem.exists("x")
    db.close()


def wal_ops(n, value_bytes, seed=0):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        key = b"k%015d" % i
        if i % 7 == 3:
            ops.append((wal.DELETE, key, b""))
        else:
            ops.append((wal.PUT, key, rng.bytes(value_bytes)))
    return ops


def test_wal_batch_record_is_jax_bytes(tmp_path):
    ops = wal_ops(300, 40)
    for i, w in enumerate((jwal.WALWriter(str(tmp_path / "j.log")),
                           wal.WALWriter(str(tmp_path / "t.log")))):
        assert w.append_batch(ops, 17) == 300
        w.append(wal.PUT, 400, b"key", b"value")
        w.append_batch(ops[:3], 401)
        w.close()
    assert (tmp_path / "t.log").read_bytes() == \
        (tmp_path / "j.log").read_bytes()
    got = list(wal.replay(str(tmp_path / "t.log")))
    assert got[:300] == [(k, 17 + i, key, v)
                         for i, (k, key, v) in enumerate(ops)]


def test_wal_batch_append_is_linear(tmp_path):
    """20,000 ops of 4,088-byte values (a 4 KiB-value store's session
    chunks) frame in seconds; growing the body op by op took minutes."""
    ops = wal_ops(20_000, 4088)
    w = wal.WALWriter(str(tmp_path / "w.log"))
    t0 = time.perf_counter()
    w.append_batch(ops, 1)
    w.close()
    assert time.perf_counter() - t0 < 10.0
    assert sum(1 for _ in wal.replay(str(tmp_path / "w.log"))) == 20_000
