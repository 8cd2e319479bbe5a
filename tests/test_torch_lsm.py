"""The port's store against the JAX package's, on the CPU.

One seeded sequence of puts, overwrites, deletes and ``write_batch``es
goes through ``repro.lsm.db.LsmDB(engine="cpu")`` and through
``repro_torch.lsm.db.LsmDB(device="cpu")`` on either engine: every SST
file must be byte-identical by file number, the level layout must match,
and ``get`` and ``scan`` must agree before and after a reopen.  A
directory written by either store must open in the other.
"""

import os

import numpy as np
import pytest

from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import SchedulerConfig as JScheduler
from repro.lsm.db import DBConfig as JConfig
from repro.lsm.db import LsmDB as JDB
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.lsm import sstable, wal
from repro_torch.lsm.db import DBConfig, LsmDB

KW = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)


def port_cfg(**kw):
    return DBConfig(geom=SSTGeometry(**KW), memtable_bytes=600,
                    scheduler=SchedulerConfig(l0_trigger=3,
                                              base_bytes=40_000), **kw)


def jax_cfg():
    return JConfig(geom=JGeometry(**KW), engine="cpu", memtable_bytes=600,
                   scheduler=JScheduler(l0_trigger=3, base_bytes=40_000))


def workload(seed: int, n_ops: int, keyspace: int):
    """Seeded ops: puts (many overwrites), deletes and write_batches."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        k = b"key%05d" % rng.integers(0, keyspace)
        r = rng.random()
        if r < 0.12:
            ops.append(("delete", k))
        elif r < 0.2:
            batch = [("put", b"key%05d" % rng.integers(0, keyspace),
                      b"b%06d" % (i * 10 + j)) for j in range(5)]
            batch.append(("delete", b"key%05d" % rng.integers(0, keyspace)))
            ops.append(("batch", batch))
        else:
            ops.append(("put", k, b"v%06d" % i))
    return ops


def apply(db, ops, model):
    for op in ops:
        if op[0] == "put":
            db.put(op[1], op[2])
            model[op[1]] = op[2]
        elif op[0] == "delete":
            db.delete(op[1])
            model.pop(op[1], None)
        else:
            db.write_batch(op[1])
            for b in op[1]:
                if b[0] == "put":
                    model[b[1]] = b[2]
                else:
                    model.pop(b[1], None)


def sst_files(path):
    return {int(f[:-4]): open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".sst")}


def keyset(keyspace):
    return [b"key%05d" % i for i in range(keyspace)]


@pytest.mark.parametrize("seed,n_ops,keyspace", [(0, 1500, 400),
                                                 (1, 2500, 150)])
@pytest.mark.parametrize("engine", ["device", "cpu"])
def test_same_files_and_reads_as_jax_store(tmp_path, engine, seed, n_ops,
                                           keyspace):
    """The port's store on either engine (``"device"``: the torch engine
    on the CPU; ``"cpu"``: the numpy baseline) against JAX's
    ``engine="cpu"`` store."""
    ops = workload(seed, n_ops, keyspace)
    jdb = JDB(str(tmp_path / "jax"), jax_cfg())
    tdb = LsmDB(str(tmp_path / "port"), port_cfg(engine=engine),
                device="cpu")
    assert tdb.engine.name == {"device": "torch", "cpu": "cpu"}[engine]
    model: dict = {}
    apply(jdb, ops, model)
    apply(tdb, ops, {})
    assert tdb.stats.flushes > 10 and tdb.stats.compactions > 2
    assert tdb.level_sizes() == jdb.level_sizes()
    jfiles, tfiles = sst_files(jdb.path), sst_files(tdb.path)
    assert sorted(tfiles) == sorted(jfiles)
    for no in jfiles:
        assert tfiles[no] == jfiles[no], f"SST {no} differs"
    for k in keyset(keyspace):
        assert tdb.get(k) == jdb.get(k) == model.get(k), k
    lo, hi = b"key%05d" % (keyspace // 4), b"key%05d" % (3 * keyspace // 4)
    want = sorted((k, v) for k, v in model.items() if lo <= k < hi)
    assert tdb.scan(lo, hi) == jdb.scan(lo, hi) == want
    jdb.close()
    tdb.close()

    # reopen: the memtable comes back from the WAL, levels from the manifest
    tdb = LsmDB(str(tmp_path / "port"), port_cfg(engine=engine),
                device="cpu")
    for k in keyset(keyspace):
        assert tdb.get(k) == model.get(k), k
    assert tdb.scan(lo, hi) == want
    tdb.close()


def test_port_opens_a_jax_store_and_back(tmp_path):
    ops = workload(3, 1200, 300)
    model: dict = {}
    path = str(tmp_path / "db")
    jdb = JDB(path, jax_cfg())
    apply(jdb, ops[:800], model)
    jdb.close()   # leaves an unflushed WAL tail
    tdb = LsmDB(path, port_cfg(), device="cpu")
    for k in keyset(300):
        assert tdb.get(k) == model.get(k), k
    apply(tdb, ops[800:], model)
    tdb.flush()
    tdb.maybe_compact()
    tdb.close()
    jdb = JDB(path, jax_cfg())
    for k in keyset(300):
        assert jdb.get(k) == model.get(k), k
    assert jdb.scan(b"key", b"kez") == sorted(model.items())
    jdb.close()


def test_write_batch_is_one_wal_record(tmp_path):
    db = LsmDB(str(tmp_path / "db"), port_cfg(), device="cpu")
    n = db.write_batch([("put", b"a", b"1"), ("delete", b"b"),
                        ("put", b"c", b"3")])
    assert n == 3 and db.get(b"a") == b"1" and db.get(b"c") == b"3"
    db.close()
    records = list(wal.replay(str(tmp_path / "db" / "wal.log")))
    assert [(r[0], r[2]) for r in records] == [
        (wal.PUT, b"a"), (wal.DELETE, b"b"), (wal.PUT, b"c")]
    with open(os.path.join(str(tmp_path / "db"), "wal.log"), "rb") as f:
        data = f.read()
    assert data[8] == wal.BATCH   # kind byte of the single record
    with pytest.raises(ValueError):
        LsmDB(str(tmp_path / "db2"), port_cfg(),
              device="cpu").write_batch([("merge", b"k", b"v")])


def test_bad_input_and_closed_store(tmp_path):
    db = LsmDB(str(tmp_path / "db"), port_cfg(), device="cpu")
    with pytest.raises(ValueError):
        db.put(b"x" * 17, b"v")
    with pytest.raises(ValueError):
        db.put(b"ends-with-nul\x00", b"v")
    with pytest.raises(ValueError):
        db.put(b"k", b"v" * 29)
    db.close()
    db.close()
    with pytest.raises(IOError):
        db.put(b"k", b"v")


def test_corrupt_input_keeps_the_store_unchanged(tmp_path):
    db = LsmDB(str(tmp_path / "db"), port_cfg(auto_compact=False),
               device="cpu")
    for i in range(200):
        db.put(b"key%04d" % i, b"v%d" % i)
    db.flush()
    assert len(db.versions.current.levels[0]) >= 3
    fm = db.versions.current.levels[0][0]
    img = sstable.read_sst(fm.path)
    bad = img._replace(vals=img.vals.copy())
    bad.vals[0, 0, 1] ^= 1
    sstable.write_sst(fm.path, bad, fm.file_no)   # valid file, stale CRC
    before = db.level_sizes()
    with pytest.raises(IOError, match="CRC"):
        db.compact_once()
    assert db.level_sizes() == before and os.path.exists(fm.path)
    db.close()


def test_reader_probe_bloom_and_block_crc(tmp_path):
    db = LsmDB(str(tmp_path / "db"), port_cfg(), device="cpu")
    for i in range(0, 60, 2):
        db.put(b"key%04d" % i, b"v%d" % i)
    db.flush()
    fm = db.versions.current.levels[0][0]
    from repro_torch.lsm import ReadOptions
    rdr = db.cache.reader(fm)
    assert rdr.get(b"key0002", ReadOptions(verify_crc=True)) == b"v2"
    pruned = sum(rdr.probe(b"key%04d" % i)[2] for i in range(1, 60, 2))
    assert pruned > 0   # the filter spares block decodes for absent keys
    assert db.get(b"key0003") is None
    # an in-memory flip after load is caught by the per-block CRC
    img = rdr._load()
    vals = img.vals.copy()
    vals[0, 0, 2] ^= 4
    rdr._img = img._replace(vals=vals)
    with pytest.raises(IOError, match="block 0"):
        rdr.decode_block(0, verify_crc=True)
    db.close()


def test_stats_is_a_snapshot(tmp_path):
    """``LsmDB.stats`` is a point-in-time copy in both stores (ROADMAP C4):
    two reads give two objects, and a put and a get between them show as
    the same deltas in the port as in the JAX store."""
    deltas = []
    for db in (JDB(str(tmp_path / "jax"), jax_cfg()),
               LsmDB(str(tmp_path / "port"), port_cfg(), device="cpu")):
        s0 = db.stats
        db.put(b"k1", b"v1")
        assert db.get(b"k1") == b"v1"
        s1 = db.stats
        assert s0 is not s1
        assert db.stats is not db.stats
        deltas.append((s1.puts - s0.puts, s1.gets - s0.gets))
        db.close()
    assert deltas == [(1, 1), (1, 1)]
