"""The port's batched read path and device sort mode against the JAX
package, on the CPU.

* The plain versions of the four slice-2 kernels (``bloom_multi_probe``,
  ``bloom_query``, ``lookup_blocks``, ``bitonic_sort``) are held bit for
  bit against the Pallas kernels in interpret mode and the jnp oracles.
* One seeded op sequence goes through ``repro.lsm.db.LsmDB`` and
  ``repro_torch.lsm.db.LsmDB(device="cpu")``: the port's ``multi_get``
  (backends ``"device"`` and ``"host"``) must equal the JAX store's
  (``"host"`` and ``"pallas"``), the port's ``get`` loop and the model.
* Snapshots pin the file set; ``sort_mode="device"`` writes the same SST
  files as ``"merge"`` and as the JAX store.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import SchedulerConfig as JScheduler
from repro.kernels import bitonic_sort as jbitonic
from repro.kernels import bloom as jbloom
from repro.kernels import lookup as jlookup
from repro.kernels import ref as jref
from repro.lsm import ReadOptions as JReadOptions
from repro.lsm.db import DBConfig as JConfig
from repro.lsm.db import LsmDB as JDB
from repro.lsm.sstable import FileMeta as JFileMeta
from repro.lsm.sstable import TableReader as JReader
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.kernels import ops, ref
from repro_torch.lsm import ReadOptions
from repro_torch.lsm.db import DBConfig, LsmDB

KW = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)   # the read kernels' edge cases


def t(a: np.ndarray) -> torch.Tensor:
    """uint32 (or int32) numpy -> int32 bit-pattern tensor on the CPU."""
    a = np.ascontiguousarray(np.asarray(a))
    return torch.from_numpy(a.astype(a.dtype if a.dtype == np.int32
                                      else np.uint32).view(np.int32))


def u(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def lexsorted(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(tuple(rows[:, i]
                                 for i in reversed(range(rows.shape[1]))))]


# ---------------------------------------------------------------------------
# plain kernel versions against the Pallas kernels and the jnp oracles
# ---------------------------------------------------------------------------


def _filters_and_keys(rng, rows, per, n_words, lanes, probes):
    """Filters built from ``per`` keys each, and the keys, so that probes
    of the same keys hit and fresh keys mostly miss."""
    keys = rng.integers(0, 2**32, (rows, per, lanes), dtype=np.uint32)
    filters = u(ref.bloom_build(t(keys), n_words=n_words, n_probes=probes))
    return filters, keys


@pytest.mark.parametrize("c,n_words,lanes,probes", [
    (37, 8, 4, 6), (64, 5, 4, 6), (20, 219, 2, 3)])
def test_bloom_multi_probe_matches_pallas_and_ref(c, n_words, lanes, probes):
    rng = np.random.default_rng(c)
    filters, keys = _filters_and_keys(rng, c, 4, n_words, lanes, probes)
    q = keys[:, 0].copy()
    absent = rng.random(c) < 0.5
    q[absent] = rng.integers(0, 2**32, (absent.sum(), lanes), np.uint32)
    got = ref.bloom_multi_probe(t(filters), t(q), n_probes=probes).numpy()
    pallas = np.asarray(jbloom.multi_probe(filters, q, n_probes=probes,
                                           interpret=True))
    oracle = np.asarray(jref.bloom_multi_probe(filters, q, n_probes=probes))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)
    assert got[~absent].all() and not got[absent].all()


@pytest.mark.parametrize("g,q,n_words,lanes,probes", [
    (5, 40, 5, 4, 6), (3, 300, 7, 4, 3), (6, 9, 160, 2, 6)])
def test_bloom_query_matches_pallas_and_ref(g, q, n_words, lanes, probes):
    rng = np.random.default_rng(g * q)
    filters, keys = _filters_and_keys(rng, g, 8, n_words, lanes, probes)
    queries = rng.integers(0, 2**32, (g, q, lanes), dtype=np.uint32)
    queries[:, :8] = keys
    got = ref.bloom_query(t(filters), t(queries), n_probes=probes).numpy()
    pallas = np.asarray(jbloom.bloom_query(filters, queries, n_probes=probes,
                                           interpret=True))
    oracle = np.asarray(jref.bloom_query(filters, queries, n_probes=probes))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)
    assert got[:, :8].all()


def lookup_case(rng, c, k, lanes, vw):
    """Sorted blocks with duplicate keys, the all-ones sentinel at and
    after ``nvalid``, some rows with ``nvalid = 0``; queries present
    (duplicates among them), absent, and equal to a key past ``nvalid``."""
    keys = np.zeros((c, k, lanes), np.uint32)
    nvalid = rng.integers(0, k + 1, c).astype(np.int32)
    nvalid[:3] = (0, k, 1)
    queries = np.zeros((c, lanes), np.uint32)
    for i in range(c):
        rows = rng.integers(0, 6, (k, lanes)).astype(np.uint32)
        rows = lexsorted(rows)
        keys[i] = rows
        keys[i, nvalid[i]:] = 0xFFFFFFFF
        kind = i % 3
        if kind == 0 and nvalid[i] > 0:          # present
            queries[i] = rows[rng.integers(0, nvalid[i])]
        elif kind == 1 and nvalid[i] < k:        # past nvalid: not found
            queries[i] = rows[nvalid[i]]
        else:                                    # most likely absent
            queries[i] = rng.integers(0, 6, lanes)
    meta = rng.integers(0, 2**32, (c, k), dtype=np.uint32)
    vals = rng.integers(0, 2**32, (c, k, vw), dtype=np.uint32)
    return keys, meta, vals, nvalid, queries


@pytest.mark.parametrize("c,k,lanes,vw", [(23, 16, 4, 3), (40, 16, 4, 68),
                                          (9, 40, 2, 5)])
def test_lookup_blocks_matches_pallas_and_ref(c, k, lanes, vw):
    rng = np.random.default_rng(c * k)
    keys, meta, vals, nvalid, queries = lookup_case(rng, c, k, lanes, vw)
    found, m, v = ref.lookup_blocks(t(keys), t(meta), t(vals), t(nvalid),
                                    t(queries))
    pf, pm, pv = jlookup.lookup_blocks(keys, meta, vals, nvalid, queries,
                                       interpret=True)
    of, om, ov = jref.lookup_blocks(keys, meta, vals, nvalid, queries)
    for want_f, want_m, want_v in ((pf, pm, pv), (of, om, ov)):
        np.testing.assert_array_equal(found.numpy(), np.asarray(want_f))
        np.testing.assert_array_equal(u(m), np.asarray(want_m))
        np.testing.assert_array_equal(u(v), np.asarray(want_v))
    f = found.numpy()
    assert f.any() and not f.all()
    assert not f[nvalid == 0].any()
    # the leftmost equal row (the newest version) is the one returned
    for i in np.nonzero(f)[0]:
        first = int(np.nonzero((keys[i] == queries[i]).all(-1))[0][0])
        assert u(m)[i] == meta[i, first]
        np.testing.assert_array_equal(u(v)[i], vals[i, first])
    assert (u(m)[~f] == 0).all() and (u(v)[~f] == 0).all()


@pytest.mark.parametrize("c,k,lanes,vw", [(23, 16, 4, 3), (40, 16, 4, 68),
                                          (9, 40, 2, 5)])
def test_lookup_blocks_packed_matches_pallas_and_ref(c, k, lanes, vw):
    """The packed form (what the read path copies back) is the Pallas
    kernel's and the oracle's three outputs side by side."""
    rng = np.random.default_rng(c * k)
    keys, meta, vals, nvalid, queries = lookup_case(rng, c, k, lanes, vw)
    got = ops.lookup_blocks_packed(t(keys), t(meta), t(vals), t(nvalid),
                                   t(queries))
    assert got.dtype == torch.int32 and tuple(got.shape) == (c, 2 + vw)
    for jf, jm, jv in (jlookup.lookup_blocks(keys, meta, vals, nvalid,
                                             queries, interpret=True),
                       jref.lookup_blocks(keys, meta, vals, nvalid, queries)):
        want = np.concatenate([np.asarray(jf).astype(np.uint32)[:, None],
                               np.asarray(jm)[:, None], np.asarray(jv)],
                              axis=1)
        np.testing.assert_array_equal(u(got), want)


@pytest.mark.parametrize("k,lanes,vw", chip_smoke.EDGE_SHAPES)
def test_lookup_blocks_edges_match_jax(k, lanes, vw):
    """The read kernels' edge blocks (``chip_smoke.edge_blocks``, which the
    card checks too) through the plain versions and the JAX oracle."""
    keys, meta, vals, nvalid, queries = chip_smoke.edge_blocks(
        np.random.default_rng(k * lanes + vw), 60, k, lanes, vw)
    found, m, v = ref.lookup_blocks(t(keys), t(meta), t(vals), t(nvalid),
                                    t(queries))
    of, om, ov = jref.lookup_blocks(keys, meta, vals, nvalid, queries)
    np.testing.assert_array_equal(found.numpy(), np.asarray(of))
    np.testing.assert_array_equal(u(m), np.asarray(om))
    np.testing.assert_array_equal(u(v), np.asarray(ov))
    packed = ref.lookup_blocks_packed(t(keys), t(meta), t(vals), t(nvalid),
                                      t(queries))
    np.testing.assert_array_equal(u(packed)[:, 0], found.numpy())
    np.testing.assert_array_equal(u(packed)[:, 1], u(m))
    np.testing.assert_array_equal(u(packed)[:, 2:], u(v))
    f = found.numpy()
    assert not f[nvalid == 0].any()
    assert not f[(queries == 0xFFFFFFFF).all(-1)].any()
    for i in np.nonzero(f)[0]:   # the leftmost equal row wins
        first = int(np.nonzero((keys[i] == queries[i]).all(-1))[0][0])
        assert u(m)[i] == meta[i, first]
    if k > 1:
        assert f.any() and not f.all()


@pytest.mark.parametrize("n_words,probes", chip_smoke.PROBE_EDGES)
def test_probe_edges_match_jax(n_words, probes):
    """The card tests' probe edges (short and long filter rows, 1, 6 and 10
    probes) through the plain versions and the JAX oracles."""
    rng = np.random.default_rng(n_words + probes)
    filters, keys = _filters_and_keys(rng, 40, 16, n_words, 4, probes)
    q = keys[:, 0].copy()
    absent = rng.random(40) < 0.5
    q[absent] = rng.integers(0, 2**32, (absent.sum(), 4), np.uint32)
    got = ref.bloom_multi_probe(t(filters), t(q), n_probes=probes).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jref.bloom_multi_probe(filters, q, n_probes=probes)))
    assert got[~absent].all()
    gq = np.concatenate([keys, rng.integers(0, 2**32, (40, 16, 4),
                                            dtype=np.uint32)], axis=1)
    got = ref.bloom_query(t(filters), t(gq), n_probes=probes).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jref.bloom_query(filters, gq, n_probes=probes)))
    assert got[:, :16].all()


@pytest.mark.parametrize("n,lanes,index_lane", [
    (1, 6, True), (5, 6, True), (100, 6, True), (257, 6, True),
    (70, 3, False)])
def test_bitonic_sort_matches_pallas_and_ref(n, lanes, index_lane):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 4, (n, lanes)).astype(np.uint32)
    rows[: n // 3, :2] = 0xFFFFFFFF     # all-ones key lanes, like padding
    if index_lane:
        rows[:, -1] = rng.permutation(n)
    got = u(ops.bitonic_sort(t(rows)))
    pallas = np.asarray(jbitonic.bitonic_sort(rows, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, np.asarray(jref.sort_tuples(
        rows, lanes)))
    np.testing.assert_array_equal(got, lexsorted(rows))


# ---------------------------------------------------------------------------
# the store: multi_get against the JAX store, the get loop and the model
# ---------------------------------------------------------------------------


def port_cfg(**kw):
    return DBConfig(geom=SSTGeometry(**KW), memtable_bytes=600,
                    scheduler=SchedulerConfig(l0_trigger=3,
                                              base_bytes=40_000), **kw)


def jax_cfg():
    return JConfig(geom=JGeometry(**KW), engine="cpu", memtable_bytes=600,
                   scheduler=JScheduler(l0_trigger=3, base_bytes=40_000))


def workload(seed: int, n_ops: int, keyspace: int):
    """Seeded puts (many overwrites) and deletes."""
    rng = np.random.default_rng(seed)
    ops_ = []
    for i in range(n_ops):
        k = b"key%05d" % rng.integers(0, keyspace)
        if rng.random() < 0.12:
            ops_.append(("delete", k))
        else:
            ops_.append(("put", k, b"v%06d" % i))
    return ops_


def apply(db, ops_, model):
    for op in ops_:
        if op[0] == "put":
            db.put(op[1], op[2])
            model[op[1]] = op[2]
        else:
            db.delete(op[1])
            model.pop(op[1], None)


def sst_files(path):
    return {int(f[:-4]): open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".sst")}


def read_batches(rng, keyspace, mem_keys):
    """Batches with present keys, keys never written (in and out of the
    files' ranges), duplicates, memtable-only keys, and an empty one."""
    loaded = [b"key%05d" % i for i in range(keyspace)]
    never = [b"key%05dx" % i for i in range(0, keyspace, 7)] + \
        [b"a-before", b"zz-after"]
    mixed = list(rng.choice(loaded, 60)) + never[:10] + mem_keys[:5]
    mixed += mixed[:7]                                   # duplicates
    rng.shuffle(mixed)
    return [loaded, never, mixed, mem_keys, []]


@pytest.mark.parametrize("seed,n_ops,keyspace", [(0, 1500, 400),
                                                 (4, 900, 120)])
def test_multi_get_matches_jax_store_and_get_loop(tmp_path, seed, n_ops,
                                                  keyspace):
    ops_ = workload(seed, n_ops, keyspace)
    mem_ops = [("put", b"mem%03d" % i, b"m%d" % i) for i in range(6)]
    jdb = JDB(str(tmp_path / "jax"), jax_cfg())
    tdb = LsmDB(str(tmp_path / "port"), port_cfg(), device="cpu")
    model: dict = {}
    for db in (jdb, tdb):
        apply(db, ops_, model)
        db.flush()
        apply(db, mem_ops, model)          # memtable-only keys on top
    assert tdb.stats.compactions > 0 and len(tdb.mem) == len(mem_ops)
    rng = np.random.default_rng(seed)
    batches = read_batches(rng, keyspace, [op[1] for op in mem_ops])
    for when in ("open", "reopened"):
        for keys in batches:
            want = [model.get(k) for k in keys]
            assert [tdb.get(k) for k in keys] == want
            for backend in ("device", "host"):
                assert tdb.multi_get(keys, ReadOptions(backend=backend)) \
                    == want, (when, backend)
            if when == "open":
                for backend in ("host", "pallas"):
                    assert jdb.multi_get(keys, JReadOptions(
                        backend=backend)) == want, backend
        if when == "open":
            assert tdb.stats.multi_gets == 2 * len(batches)
            assert tdb.stats.multi_get_keys == 2 * sum(map(len, batches))
            tdb.close()
            # cold block cache: the bloom prune runs on every candidate
            tdb = LsmDB(str(tmp_path / "port"), port_cfg(), device="cpu")
            assert tdb.multi_get(batches[1]) == [None] * len(batches[1])
            assert tdb.stats.bloom_negative_skips > 0
    jdb.close()
    tdb.close()


def test_table_reader_multi_get_matches_jax(tmp_path):
    tdb = LsmDB(str(tmp_path / "db"), port_cfg(), device="cpu")
    model: dict = {}
    apply(tdb, workload(2, 600, 200), model)
    tdb.flush()
    keys = [b"key%05d" % i for i in range(210)] + [b"key00003"] * 2
    for _, fm in tdb.versions.current.all_files():
        rdr = tdb.cache.reader(fm)
        jrdr = JReader(JFileMeta.from_json(fm.to_json()), JGeometry(**KW))
        want = jrdr.multi_get(keys, JReadOptions(backend="host"))
        assert want == [jrdr.get(k) for k in keys]
        for backend in ("device", "host"):
            assert rdr.multi_get(keys, ReadOptions(backend=backend)) == want
    tdb.close()


def test_snapshot_pins_the_file_set(tmp_path):
    db = LsmDB(str(tmp_path / "db"), port_cfg(auto_compact=False),
               device="cpu")
    for i in range(40):
        db.put(b"s%04d" % i, b"v%d" % i)
    db.flush()
    snap = db.snapshot()
    so = ReadOptions(snapshot=snap)
    keys = [b"s%04d" % i for i in range(42)]
    before = db.multi_get(keys, so)
    assert before == [b"v%d" % i for i in range(40)] + [None, None]
    db.put(b"post-snap", b"x")             # the captured memtable is live
    assert db.get(b"post-snap", so) == b"x"
    for r in range(3):                     # more L0 files, then compact
        for i in range(40):
            db.put(b"t%d%04d" % (r, i), b"w%d" % i)
        db.flush()
    db.maybe_compact()
    gone = [fm for _, fm in snap.version.all_files()
            if not os.path.exists(fm.path)]
    assert gone                            # compacted away under the pin
    assert db.multi_get(keys) == before    # the latest view reads on
    with pytest.raises(FileNotFoundError):
        db.get(b"s0000", so)
    with pytest.raises(FileNotFoundError):
        db.multi_get(keys, so)
    with pytest.raises(FileNotFoundError):
        db.scan(b"s", b"t", so)
    db.close()


@pytest.mark.parametrize("backend", ["auto", "pallas", "ref", "cuda", ""])
def test_unknown_read_backend_raises(backend):
    with pytest.raises(ValueError, match="backend"):
        ReadOptions(backend=backend)


def test_device_sort_mode_writes_the_same_files(tmp_path):
    ops_ = workload(0, 1500, 400)
    jdb = JDB(str(tmp_path / "jax"), jax_cfg())
    apply(jdb, ops_, {})
    jdb.close()
    files = {"jax": sst_files(str(tmp_path / "jax"))}
    for mode in ("merge", "device"):
        db = LsmDB(str(tmp_path / mode), port_cfg(sort_mode=mode),
                   device="cpu")
        model: dict = {}
        apply(db, ops_, model)
        assert db.stats.compactions > 2
        keys = [b"key%05d" % i for i in range(400)]
        assert db.multi_get(keys) == [model.get(k) for k in keys]
        db.close()
        files[mode] = sst_files(str(tmp_path / mode))
    assert files["device"] == files["merge"] == files["jax"]
