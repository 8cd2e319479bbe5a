"""The async cases of the JAX package's other suites, against the port on
the CPU (ROADMAP A8): ``multi_get`` racing background work
(``tests/test_multi_get.py``), async ``ShardedDB`` with ``wait_idle``,
``resume`` and a reopen (``tests/test_sharded.py``), ``LsmSessionStore``
on async ``LsmDB`` and ``ShardedDB`` backends
(``tests/test_session_store.py``), a crash with rotated but unflushed WAL
segments reopened by the other package (``tests/test_recovery.py``), and a
background error surfacing to writers (``tests/test_races.py``).  The JAX
stores run ``engine="cpu"`` (no jit compile); the port runs the torch
engine on its plain versions.  Every wait is bounded.
"""

import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import SchedulerConfig as JScheduler
from repro.lsm.db import DBConfig as JConfig
from repro.lsm.db import LsmDB as JDB
from repro.lsm.sharded import ShardedDB as JSharded
from repro.serving import session_store as jss
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.lsm.faults import BackgroundError
from repro_torch.lsm.sharded import ShardedDB, uniform_boundaries
from repro_torch.serving import session_store as tss

GEOM = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)
WAIT = 60.0   # seconds any barrier, join or gate may take here


def port_cfg(**kw):
    return DBConfig(geom=SSTGeometry(**GEOM),
                    memtable_bytes=kw.pop("memtable_bytes", 600),
                    scheduler=SchedulerConfig(l0_trigger=3,
                                              base_bytes=40_000), **kw)


def jax_cfg(**kw):
    return JConfig(geom=JGeometry(**GEOM), engine="cpu",
                   memtable_bytes=kw.pop("memtable_bytes", 600),
                   scheduler=JScheduler(l0_trigger=3, base_bytes=40_000),
                   **kw)


def fill(db, rng, n_ops=700, key_space=200):
    """Random puts, overwrites and deletes; the expected values."""
    kv = {}
    for i in range(n_ops):
        k = b"k%05d" % int(rng.integers(0, key_space))
        if rng.random() < 0.15:
            db.delete(k)
            kv[k] = None
        else:
            v = b"v%06d" % i
            db.put(k, v)
            kv[k] = v
    return kv


def rand_key(rng):
    # the first byte spreads keys across the uniform boundary table
    return bytes([int(rng.integers(1, 255))]) + \
        b"k%04d" % rng.integers(0, 300)


# ---------------------------------------------------------------------------
# multi_get on an async store (tests/test_multi_get.py)
# ---------------------------------------------------------------------------


def test_multi_get_async_store(tmp_path):
    """``multi_get`` racing the background flushes and compactions (no
    drain), then after ``wait_idle``: the acknowledged values, as JAX's
    async store answers."""
    tdb = LsmDB(str(tmp_path / "port"), port_cfg(
        async_compaction=True, flush_workers=2), device="cpu")
    jdb = JDB(str(tmp_path / "jax"), jax_cfg(async_compaction=True,
                                             flush_workers=2))
    kv = fill(tdb, np.random.default_rng(11), n_ops=500)
    assert fill(jdb, np.random.default_rng(11), n_ops=500) == kv
    keys = list(kv)
    want = [kv[k] for k in keys]
    assert tdb.multi_get(keys) == want   # reads race the workers
    tdb.wait_idle(timeout=WAIT)
    jdb.wait_idle()
    assert tdb.multi_get(keys) == jdb.multi_get(keys) == want
    assert tdb.stats.flushes == jdb.stats.flushes > 5
    tdb.close()
    jdb.close()


# ---------------------------------------------------------------------------
# async ShardedDB (tests/test_sharded.py)
# ---------------------------------------------------------------------------


def test_sharded_async_mode_wait_idle_resume_and_reopen(tmp_path):
    """Four async shards over one queue: after ``wait_idle`` every
    acknowledged write reads back as from JAX's async ``ShardedDB``; one
    shard's failed flush halts that shard only, ``resume()`` restarts it,
    and a reopen reads everything back."""
    path = str(tmp_path / "sh")
    cfg = port_cfg(async_compaction=True, flush_workers=2)
    db = ShardedDB(path, cfg, shards=4, device="cpu")
    jdb = JSharded(str(tmp_path / "jax"),
                   jax_cfg(async_compaction=True, flush_workers=2), shards=4)
    assert db.boundaries == jdb.boundaries
    model = {}
    for d in (db, jdb):
        rng = np.random.default_rng(19)
        for i in range(1200):
            k, v = rand_key(rng), b"v%06d" % i
            d.put(k, v)
            model[k] = v
    db.maybe_compact()          # publishes only: async shards drain alone
    db.wait_idle(timeout=WAIT)
    jdb.wait_idle()
    keys = sorted(model)
    assert [db.get(k) for k in keys] == [model[k] for k in keys]
    assert db.multi_get(keys) == jdb.multi_get(keys) == \
        [model[k] for k in keys]
    everything = (b"\x00", b"\xff" * 17)
    assert db.scan(*everything) == jdb.scan(*everything) == \
        sorted(model.items())
    st = db.stats
    assert st.flushes == jdb.stats.flushes >= 4
    assert st.compactions >= 1 and db.queue.jobs_run >= 1
    assert db.resume() is False

    # one shard's flush fails: that shard halts, its siblings go on.  The
    # engine is shared, so only a build on the bad shard's worker fails
    bad = db.shards[2]
    real_build = db.engine.build_image
    on_bad = threading.local()
    armed = [True]

    def build(*a, **kw):
        if getattr(on_bad, "flag", False) and armed[0]:
            armed[0] = False
            raise RuntimeError("injected shard flush failure")
        return real_build(*a, **kw)

    real_flush = bad._background_flush

    def bad_flush(entry):
        on_bad.flag = True
        try:
            return real_flush(entry)
        finally:
            on_bad.flag = False
    bad._background_flush = bad_flush
    db.engine.build_image = build
    lo, hi = db.boundaries[1], db.boundaries[2]
    more = {}
    with pytest.raises(BackgroundError, match="injected shard flush"):
        for i in range(400):
            k = lo + b"m%05d" % i          # all in shard 2
            assert db.shard_of(k) == 2 and k < hi
            more[k] = b"w%06d" % i          # in the store even if it raises
            db.put(k, more[k])
        db.wait_idle(timeout=WAIT)
    assert bad.imm                        # the failed table stays queued
    for k, v in more.items():             # and readable
        assert db.get(k) == v
    other = b"\x05zz"
    db.put(other, b"ok")                  # a sibling shard takes writes
    assert db.get(other) == b"ok"
    assert db.resume() is True
    db.engine.build_image = real_build
    db.flush()
    db.wait_idle(timeout=WAIT)
    assert not bad.imm
    model.update(more)
    model[other] = b"ok"
    keys = sorted(model)
    assert db.multi_get(keys) == [model[k] for k in keys]
    db.close()
    jdb.close()

    db = ShardedDB(path, cfg, device="cpu")
    assert db.multi_get(keys) == [model[k] for k in keys]
    assert db.scan(*everything) == sorted(model.items())
    db.close()


# ---------------------------------------------------------------------------
# sessions on async backends (tests/test_session_store.py)
# ---------------------------------------------------------------------------


def small_state(rng, i, big=False):
    shape = (8, 97) if big else (3, 17)
    return {"kv": rng.standard_normal(shape).astype(np.float32),
            "pos": np.asarray([i], np.int32)}


def template():
    return {"kv": torch.zeros((1, 1)),
            "pos": torch.zeros(1, dtype=torch.int32)}


def jax_template():
    return {"kv": jnp.zeros((1, 1), jnp.float32),
            "pos": jnp.zeros((1,), jnp.int32)}


SESSION_GEOM = dict(key_bytes=16, value_bytes=256, block_bytes=4096,
                    sst_bytes=32 * 1024)


def session_backends(tmp_path):
    """(name, port store, JAX store, closers) for each async backend."""
    tcfg = DBConfig(geom=SSTGeometry(**SESSION_GEOM), memtable_bytes=4096,
                    scheduler=SchedulerConfig(l0_trigger=3,
                                              base_bytes=400_000),
                    async_compaction=True, flush_workers=2)
    jcfg = JConfig(geom=JGeometry(**SESSION_GEOM), engine="cpu",
                   memtable_bytes=4096,
                   scheduler=JScheduler(l0_trigger=3, base_bytes=400_000),
                   async_compaction=True, flush_workers=2)
    tdb = LsmDB(str(tmp_path / "lsm"), tcfg, device="cpu")
    jdb = JDB(str(tmp_path / "jlsm"), jcfg)
    tsh = ShardedDB(str(tmp_path / "sharded"), tcfg,
                    boundaries=uniform_boundaries(4), device="cpu")
    jsh = JSharded(str(tmp_path / "jsharded"), jcfg,
                   boundaries=uniform_boundaries(4))
    return [("lsm-async", tdb, jdb), ("sharded-async", tsh, jsh)]


def test_sessions_on_async_backends(tmp_path):
    """Sessions saved into async ``LsmDB`` and ``ShardedDB`` backends load
    back bit for bit while the workers flush and compact, ``load_many``
    equals the ``load`` loop, and every page equals JAX's after the
    drain; a drop removes the session in both."""
    rng = np.random.default_rng(7)
    states = {f"s{i:02d}": small_state(rng, i, big=(i % 3 == 0))
              for i in range(8)}
    names = sorted(states)
    for name, tdb, jdb in session_backends(tmp_path):
        tstore = tss.LsmSessionStore(tdb, template)
        jstore = jss.LsmSessionStore(jdb, jax_template)
        for rnd in range(3):        # overwrites: flushes and compactions
            for s, st in states.items():
                st = dict(st, pos=st["pos"] + rnd)
                tstore.save(s, {k: torch.from_numpy(v)
                                for k, v in st.items()})
                jstore.save(s, {k: jnp.asarray(v) for k, v in st.items()})
        want = {s: dict(st, pos=st["pos"] + 2) for s, st in states.items()}
        batched = tstore.load_many(names)   # races the workers
        for s, b in zip(names, batched):
            one = tstore.load(s)
            for k in ("kv", "pos"):
                assert b[k].numpy().tobytes() == one[k].numpy().tobytes() \
                    == want[s][k].tobytes(), (name, s, k)
        tdb.wait_idle(timeout=WAIT)
        jdb.wait_idle()
        assert tdb.stats.flushes > 0, name
        for s in names:
            for i in range(12):
                k = tss.LsmSessionStore._key(s, i)
                assert tdb.get(k) == jdb.get(k), (name, s, i)
        assert tstore.drop("s03") and jstore.drop("s03")
        assert not tstore.exists("s03") and not jstore.exists("s03")
        tdb.close()
        jdb.close()


# ---------------------------------------------------------------------------
# a crash with rotated, unflushed WAL segments (tests/test_recovery.py)
# ---------------------------------------------------------------------------


def park_flushes(db):
    """Park ``db``'s flush workers so rotated WAL segments pile up."""
    gate = threading.Event()
    real = db.engine.build_image

    def build(*a, **kw):
        gate.wait(timeout=WAIT)
        return real(*a, **kw)
    db.engine.build_image = build
    return gate


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_crash_with_rotated_wal_segments_reopens_in_the_other(tmp_path,
                                                              writer):
    """An async store whose flush worker is parked rotates its memtables
    into ``wal-NNNNNN.log`` segments and writes no SST; a copy of its
    directory taken without ``close()`` (a crash image) opens in the
    other package with every acknowledged write, and takes new writes."""
    path = str(tmp_path / "db")
    if writer == "jax":
        db = JDB(path, jax_cfg(async_compaction=True, memtable_bytes=300))
    else:
        db = LsmDB(path, port_cfg(async_compaction=True, memtable_bytes=300),
                   device="cpu")
    gate = park_flushes(db)
    model = {}
    for i in range(120):
        k, v = b"c%04d" % i, b"v%04d" % i
        db.put(k, v)
        model[k] = v
    db._wal.flush()
    names = os.listdir(path)
    assert not any(f.endswith(".sst") for f in names)
    assert sum(f.startswith("wal-") for f in names) >= 3
    crash = str(tmp_path / "crash")
    shutil.copytree(path, crash)
    gate.set()
    db.close()
    if writer == "jax":
        other = LsmDB(crash, port_cfg(async_compaction=True), device="cpu")
    else:
        other = JDB(crash, jax_cfg(async_compaction=True))
    keys = sorted(model)
    assert [other.get(k) for k in keys] == [model[k] for k in keys]
    other.put(b"post", b"crash")
    other.flush()
    assert other.get(b"post") == b"crash"
    assert not any(f.startswith("wal-") for f in os.listdir(crash))
    other.close()


# ---------------------------------------------------------------------------
# a background error surfaces to writers (tests/test_races.py)
# ---------------------------------------------------------------------------


class _BoomEngine:
    def build_image(self, keys, meta, vals):
        raise RuntimeError("boom: injected flush failure")

    def close(self):
        pass


def test_bg_error_surfaces_to_writers(tmp_path):
    cfg = DBConfig(async_compaction=True, auto_compact=False,
                   memtable_bytes=2048)
    db = LsmDB(str(tmp_path / "db"), cfg, device="cpu",
               engine=_BoomEngine())
    # the first rotation to see the dead flush raises its classified error
    with pytest.raises(BackgroundError, match="boom"):
        # bounded, so a regression fails the test instead of hanging it
        for i in range(50_000):
            db.put(f"k{i:06d}".encode(), b"x" * 64)
    # queued data stays readable from the immutable memtable
    assert db.get(b"k000000") == b"x" * 64
    with pytest.raises(IOError):
        db.close()   # close re-raises the background error
    assert db.get(b"k000000") == b"x" * 64


# ---------------------------------------------------------------------------
# the launcher's sync / async comparison (benchmarks/ycsb_bench.py --async)
# ---------------------------------------------------------------------------


def test_ycsb_async_runs_both_modes_on_the_same_streams(capsys):
    """``launch.ycsb --async`` runs one op stream on a sync store and on an
    async one: a row each, and the async / sync p99 put; each run checks
    its reads, its full scan and a post-drain ``get`` of every key against
    the acknowledged writes."""
    import json
    from repro_torch.launch import ycsb
    cfg = ycsb.store_config(64, async_mode=True)
    assert (cfg.async_compaction, cfg.flush_workers) == (
        True, ycsb.FLUSH_WORKERS)
    assert not ycsb.store_config(64).async_compaction
    ycsb.main(["--records", "1200", "--operations", "1200", "--value-size",
               "64", "--device", "cpu", "--async"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[device sync ]")
    assert lines[1].startswith("[device async]")
    assert "both runs read back every acknowledged write" in lines[2]
    r = json.loads(lines[-1])
    assert r["sync"]["mode"] == "sync"
    assert r["async"]["mode"] == "async"
    for mode in ("sync", "async"):
        m = r[mode]
        assert m["gets_after_drain"] == m["scan_rows"] >= 1200
        assert m["flushes"] >= 1 and len(m["latency_us"]["put"]) == 3
        assert m["put_max_us"] >= m["latency_us"]["put"][2]
        assert m["compact_device_s"] is m["compact_span_s"] is None
