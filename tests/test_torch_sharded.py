"""The port's sharded store against the JAX package's, on the CPU (ROADMAP
A7).

``repro.lsm.sharded.ShardedDB(engine="device")`` and
``repro_torch.lsm.sharded.ShardedDB(device="cpu")`` take the same boundary
tables, route the same keys, write the same ``SHARDS.json`` and refuse the
same conflicting reopens.  One seeded put / delete / ``write_batch``
sequence with ``auto_compact=False`` and ``maybe_compact()`` at fixed
points must give byte-identical SST files in every shard, the same
``DBStats``, the same queue rounds and the same stacked launches.  With
``auto_compact=True`` the queue drains on its worker while the caller
writes, so only reads are compared, against a single store.
"""

import dataclasses
import importlib.util
import os
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import SchedulerConfig as JScheduler
from repro.lsm.db import DBConfig as JConfig
from repro.lsm.sharded import ShardedDB as JSharded
from repro.lsm.sharded import boundaries_from_sample as jax_from_sample
from repro.lsm.sharded import uniform_boundaries as jax_uniform
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.ycsb import key_of
from repro_torch.lsm import ReadOptions, ShardedDB, ShardedSnapshot
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.lsm.sharded import (boundaries_from_sample,
                                     uniform_boundaries)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)   # one_round_per_notify

# tests/test_sharded.py's geometry; an L1 of 6,000 B, so L1 -> L2 jobs and
# trivial moves happen within a few hundred writes a shard
GEOM = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)


def port_cfg(**kw):
    return DBConfig(geom=SSTGeometry(**GEOM), memtable_bytes=600,
                    scheduler=SchedulerConfig(
                        l0_trigger=3, base_bytes=kw.pop("base_bytes", 6000)),
                    **kw)


def jax_cfg(**kw):
    return JConfig(geom=JGeometry(**GEOM), engine="device",
                   memtable_bytes=600,
                   scheduler=JScheduler(
                       l0_trigger=3, base_bytes=kw.pop("base_bytes", 6000)),
                   **kw)


def rand_key(rng):
    # the first byte spreads keys across the uniform boundary table
    return bytes([int(rng.integers(1, 255))]) + \
        b"k%04d" % rng.integers(0, 300)


def sst_files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".sst")}


# ---------------------------------------------------------------------------
# boundary tables, routing, SHARDS.json
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 256])
def test_uniform_boundaries_are_jax(n):
    assert uniform_boundaries(n) == jax_uniform(n)


def test_uniform_boundaries_refuse_as_jax():
    for fn in (uniform_boundaries, jax_uniform):
        with pytest.raises(ValueError, match="at most 256"):
            fn(1000)


@pytest.mark.parametrize("n", [1, 2, 4, 5, 16])
def test_boundaries_from_sample_are_jax(n):
    keys = [key_of(int(i))
            for i in np.random.default_rng(n).permutation(1000)]
    cuts = boundaries_from_sample(keys, n)
    assert cuts == jax_from_sample(keys, n)
    assert len(cuts) == n - 1 and cuts == sorted(cuts)


@pytest.mark.parametrize("sample,n", [([b"same"] * 10, 4), ([b"a", b"b"], 3),
                                      ([b"a", b"b"], 0), ([], 2),
                                      ([b"a"] * 50 + [b"b", b"c"], 4)])
def test_boundaries_from_sample_refuse_as_jax(sample, n):
    msgs = []
    for fn in (boundaries_from_sample, jax_from_sample):
        with pytest.raises(ValueError) as info:
            fn(sample, n)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_routing_and_shards_json_are_jax(tmp_path):
    keys = [key_of(i) for i in range(200)]
    j = JSharded(str(tmp_path / "j"), jax_cfg(), shards=4, sample_keys=keys)
    t = ShardedDB(str(tmp_path / "t"), port_cfg(), shards=4,
                  sample_keys=keys, device="cpu")
    assert t.boundaries == j.boundaries and t.n_shards == j.n_shards == 4
    rng = np.random.default_rng(2)
    probes = keys + [rand_key(rng) for _ in range(200)] + \
        [b"\x01", b"\xff", b"user", t.boundaries[1]]
    assert [t.shard_of(k) for k in probes] == [j.shard_of(k) for k in probes]
    for i in range(50):
        j.put(keys[i], b"v%d" % i)
        t.put(keys[i], b"v%d" % i)
    assert [s.stats.puts for s in t.shards] == \
        [s.stats.puts for s in j.shards]
    j.close()
    t.close()
    assert (tmp_path / "t" / "SHARDS.json").read_bytes() == \
        (tmp_path / "j" / "SHARDS.json").read_bytes()
    t2 = ShardedDB(str(tmp_path / "t"), port_cfg(), device="cpu")
    assert t2.boundaries == j.boundaries and t2.get(keys[7]) == b"v7"
    t2.close()


@pytest.mark.parametrize("kw", [dict(boundaries=[b"zzz"]), dict(shards=3),
                                dict(sample_keys=[b"a", b"b", b"c"])],
                         ids=["boundaries", "shards", "sample_keys"])
def test_conflicting_reopen_refuses_as_jax(tmp_path, kw):
    msgs = []
    for name, make in (
            ("j", lambda p, **k: JSharded(p, jax_cfg(), **k)),
            ("t", lambda p, **k: ShardedDB(p, port_cfg(), device="cpu",
                                           **k))):
        path = str(tmp_path / name)
        make(path, shards=4).close()
        with pytest.raises(ValueError) as info:
            make(path, **kw)
        msgs.append(str(info.value).replace(path, "<path>"))
    assert msgs[0] == msgs[1]


def test_unsorted_boundaries_refuse(tmp_path):
    with pytest.raises(ValueError, match="sorted and distinct"):
        ShardedDB(str(tmp_path / "t"), port_cfg(), device="cpu",
                  boundaries=[b"b", b"a"])


# ---------------------------------------------------------------------------
# deterministic rounds: the same files, stats and launches as JAX
# ---------------------------------------------------------------------------


def drive(db, ops, compact_every: int):
    for i, op in enumerate(ops):
        if op[0] == "put":
            db.put(op[1], op[2])
        elif op[0] == "delete":
            db.delete(op[1])
        else:
            db.write_batch(op[1])
        if i % compact_every == compact_every - 1:
            with chip_smoke.one_round_per_notify():
                db.maybe_compact()


def sharded_ops(seed: int, n: int):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        k = rand_key(rng)
        r = rng.random()
        if r < 0.1:
            ops.append(("delete", k))
        elif r < 0.16:
            ops.append(("batch", [("put", k, b"b%06d" % i),
                                  ("put", rand_key(rng), b"c%06d" % i),
                                  ("delete", rand_key(rng))]))
        else:
            ops.append(("put", k, b"v%06d" % i))
    return ops


def test_same_files_stats_and_launches_as_jax(tmp_path):
    j = JSharded(str(tmp_path / "j"), jax_cfg(auto_compact=False), shards=4)
    t = ShardedDB(str(tmp_path / "t"), port_cfg(auto_compact=False),
                  shards=4, device="cpu")
    ops = sharded_ops(7, 1000)
    drive(j, ops, 250)
    drive(t, ops, 250)
    for db in (j, t):
        db.flush()
        with chip_smoke.one_round_per_notify():
            db.maybe_compact()
    for i in range(4):
        assert sst_files(tmp_path / "t" / f"shard-{i:04d}") == \
            sst_files(tmp_path / "j" / f"shard-{i:04d}"), i
    assert t.level_sizes() == j.level_sizes()
    js, ts = j.stats, t.stats
    shared = [f.name for f in dataclasses.fields(ts)
              if hasattr(js, f.name) and "seconds" not in f.name]
    assert "batched_compactions" in shared
    assert {f: getattr(ts, f) for f in shared} == \
        {f: getattr(js, f) for f in shared}
    for a, b in zip(t.shard_stats(), j.shard_stats()):
        assert (a.compactions, a.batched_compactions, a.trivial_moves) == \
            (b.compactions, b.batched_compactions, b.trivial_moves)
    counts = ("rounds", "jobs_run", "trivial_moves")
    assert [getattr(t.queue, c) for c in counts] == \
        [getattr(j.queue, c) for c in counts]
    launches = ("batch_launches", "batch_jobs", "max_batch_jobs")
    assert [getattr(t.engine, c) for c in launches] == \
        [getattr(j.engine, c) for c in launches]
    # a stacked launch of >= 2 jobs, trivial moves, deeper levels
    assert t.engine.max_batch_jobs >= 2 and ts.batched_compactions >= 2
    assert t.queue.trivial_moves > 0 and ts.compactions > \
        ts.batched_compactions
    # reads: get, multi_get, scan, and through a snapshot
    rng = np.random.default_rng(1)
    keys = [op[1] for op in ops if op[0] != "batch"][:300] + \
        [rand_key(rng) for _ in range(50)]
    assert [t.get(k) for k in keys] == [j.get(k) for k in keys]
    assert t.multi_get(keys) == j.multi_get(keys) == [t.get(k) for k in keys]
    for start, end in ((b"\x00", b"\xff\xff"), (b"\x30", b"\x90"),
                       (b"\x41", b"\x42")):
        assert t.scan(start, end) == j.scan(start, end)
    snap = t.snapshot()
    assert isinstance(snap, ShardedSnapshot) and len(snap.shards) == 4
    jsnap = ReadOptions(snapshot=snap)
    before = t.scan(b"\x00", b"\xff\xff")
    for k in keys[:20]:
        t.put(k, b"after")
    assert t.scan(b"\x00", b"\xff\xff", jsnap) != before   # memtable live
    assert t.multi_get(keys[20:60], jsnap) == j.multi_get(keys[20:60])
    assert t.get(keys[30], jsnap) == j.get(keys[30])
    j.close()
    t.close()


# ---------------------------------------------------------------------------
# background rounds: reads against a single store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 4])
def test_auto_compact_reads_match_single_store(tmp_path, shards):
    db = ShardedDB(str(tmp_path / "sh"), port_cfg(base_bytes=40_000),
                   shards=shards, device="cpu")
    oracle = LsmDB(str(tmp_path / "oracle"), port_cfg(base_bytes=40_000),
                   device="cpu")
    rng = np.random.default_rng(7)
    keys = []
    for i in range(900):
        k = rand_key(rng)
        keys.append(k)
        if rng.random() < 0.12:
            db.delete(k)
            oracle.delete(k)
        else:
            db.put(k, b"v%06d" % i)
            oracle.put(k, b"v%06d" % i)
    db.flush()
    oracle.flush()
    db.maybe_compact()
    oracle.maybe_compact()
    assert [db.get(k) for k in keys[:200]] == [oracle.get(k)
                                              for k in keys[:200]]
    assert db.multi_get(keys) == oracle.multi_get(keys)
    for _ in range(25):
        a, b = sorted(int(x) for x in rng.integers(0, 256, 2))
        start, end = bytes([a]), bytes([min(b + 1, 255)]) + b"\xff"
        assert db.scan(start, end) == oracle.scan(start, end)
    assert db.stats.puts == oracle.stats.puts
    assert db.stats.compactions > 0
    db.close()
    reopened = ShardedDB(str(tmp_path / "sh"), port_cfg(), device="cpu")
    assert reopened.scan(b"\x00", b"\xff\xff") == \
        oracle.scan(b"\x00", b"\xff\xff")
    reopened.close()
    oracle.close()


def test_flush_while_the_queue_compacts(tmp_path, monkeypatch):
    """A shard's flush builds its image on the caller's thread while the
    queue's worker compacts through the same engine: the engine's lock
    lets one of them at a time reach the pipeline, and every
    acknowledged write reads back."""
    from repro_torch.core import offload
    db = ShardedDB(str(tmp_path / "sh"), port_cfg(base_bytes=40_000),
                   shards=4, device="cpu")
    calls, inside = [], [0]
    lock = threading.Lock()

    def watch(name, fn):
        def call(*a, **kw):
            with lock:
                inside[0] += 1
                calls.append((name, threading.current_thread().name,
                              inside[0]))
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    inside[0] -= 1
        return call

    ex = db.engine.executor
    monkeypatch.setattr(ex, "compact", watch("compact", ex.compact))
    monkeypatch.setattr(ex, "compact_many",
                        watch("compact_many", ex.compact_many))
    monkeypatch.setattr(offload, "build_image",
                        watch("build_image", offload.build_image))
    rng = np.random.default_rng(3)
    model = {}
    for i in range(1500):
        k = rand_key(rng)
        db.put(k, b"v%06d" % i)
        model[k] = b"v%06d" % i
    db.wait_idle()
    worker = "shard-compact-0"
    assert {th for n, th, _ in calls if n != "build_image"} == {worker}
    assert worker not in {th for n, th, _ in calls if n == "build_image"}
    names = {n for n, _, _ in calls}
    assert "build_image" in names and names & {"compact", "compact_many"}
    assert max(depth for _, _, depth in calls) == 1   # never two at once
    keys = sorted(model)
    assert db.multi_get(keys) == [model[k] for k in keys]
    assert db.scan(b"\x00", b"\xff\xff") == sorted(model.items())
    db.close()
