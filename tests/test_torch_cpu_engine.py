"""The port's CPU compaction baseline, its engine choice and its
background reader, on the CPU.

``repro_torch.lsm.cpu_engine.CpuCompactionEngine`` must equal the JAX
package's ``CpuCompactionEngine`` bit for bit (images and stats) on the
run shapes of ``test_torch_compaction.py``: sorted runs of one to three
blocks' entries with overlapping keys, overwrites and tombstones.
"""

import os
import threading

import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.lsm import cpu_engine as jce
from repro.lsm import sstable as jsstable
from repro.lsm.db import DBConfig as JConfig
from repro.lsm.db import make_engine as jmake
from repro_torch.core import formats, offload
from repro_torch.core.background import BackgroundExecutor, PrefetchReader
from repro_torch.core.formats import SSTGeometry
from repro_torch.lsm import cpu_engine as ce
from repro_torch.lsm import sstable
from repro_torch.lsm.db import DBConfig, LsmDB, make_engine
from repro_torch.lsm.engine import TorchCompactionEngine

KW = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)
GEOM = SSTGeometry(**KW)
JGEOM = jformats.SSTGeometry(**KW)
K = GEOM.block_kvs


def _entries(rng, n, seq0, keyspace=60):
    """n sorted unique-key entries with sequence numbers from seq0; about
    a fifth are tombstones."""
    ids = np.sort(rng.choice(keyspace, n, replace=False))
    keys = np.stack([jformats.pack_key_bytes(b"k%05d" % i, 16) for i in ids])
    is_value = rng.random(n) > 0.2
    meta = ((np.arange(n, dtype=np.uint32) + seq0) << 1) | is_value
    vals = rng.integers(0, 2**32, (n, GEOM.value_words), dtype=np.uint32)
    return keys, meta.astype(np.uint32), vals


def _run_images(n_runs: int, seed: int = 0):
    """``n_runs`` flushed host images, built by the JAX numpy engine."""
    rng = np.random.default_rng(seed + n_runs)
    eng = jce.CpuCompactionEngine(JGEOM)
    return [eng.build_image(*_entries(rng, int(rng.integers(K, 3 * K)),
                                      seq0=1 + 1000 * r))
            for r in range(n_runs)]


def _assert_images_equal(got, want):
    for name, a, b in zip(formats.SSTImage._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def _counts(es):
    return (es.n_input, es.n_live, es.n_dropped, es.crc_ok, es.bytes_in,
            es.bytes_out)


@pytest.mark.parametrize("n_runs", [1, 2, 3, 5])
@pytest.mark.parametrize("bottom", [False, True])
def test_compact_equals_jax(n_runs, bottom):
    images = _run_images(n_runs)
    got, gst = ce.CpuCompactionEngine(GEOM).compact(
        [formats.SSTImage(*im) for im in images], bottom_level=bottom)
    want, wst = jce.CpuCompactionEngine(JGEOM).compact(images,
                                                       bottom_level=bottom)
    _assert_images_equal(got, want)
    assert _counts(gst) == _counts(wst) and gst.crc_ok
    assert gst.device_seconds == 0.0 and gst.host_seconds > 0.0


@pytest.mark.parametrize("n_runs,bottom", [(2, False), (5, True)])
def test_compact_paths_and_many_equal_jax(tmp_path, n_runs, bottom):
    paths = []
    for i, im in enumerate(_run_images(n_runs, seed=4)):
        p = str(tmp_path / f"{i:06d}.sst")
        jsstable.write_sst(p, im, i)
        paths.append(p)
    eng = ce.CpuCompactionEngine(GEOM, threads=4)
    assert eng.threads == 4
    got, gst = eng.compact_paths(paths, bottom_level=bottom)
    want, wst = jce.CpuCompactionEngine(JGEOM).compact_paths(
        paths, bottom_level=bottom)
    _assert_images_equal(got, want)
    assert _counts(gst) == _counts(wst)
    many = eng.compact_many([(paths, bottom), (paths[:1], False)])
    _assert_images_equal(many[0][0], want)
    _assert_images_equal(many[1][0], jce.CpuCompactionEngine(JGEOM)
                         .compact_paths(paths[:1])[0])


@pytest.mark.parametrize("n,n_blocks", [(1, None), (K + 3, None),
                                        (3 * K, None), (5, 4), (2 * K, 5)])
def test_build_image_equals_jax(n, n_blocks):
    keys, meta, vals = _entries(np.random.default_rng(n), n, seq0=9)
    got = ce.CpuCompactionEngine(GEOM).build_image(keys, meta, vals,
                                                   n_blocks=n_blocks)
    want = jce.CpuCompactionEngine(JGEOM).build_image(keys, meta, vals,
                                                      n_blocks=n_blocks)
    _assert_images_equal(got, want)


def test_numpy_mirrors_equal_jax():
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 8, (1000, 4)).astype(np.uint32), axis=0)
    for r in (1, 12, 16):
        np.testing.assert_array_equal(ce.np_prefix_encode(keys, r),
                                      jce.np_prefix_encode(keys, r))
    g = keys[:384].reshape(24, 16, 4)
    valid = rng.random((24, 16)) > 0.3
    for words, probes in ((5, 6), (64, 1), (9, 30)):
        np.testing.assert_array_equal(
            ce.np_bloom_build(g, valid, words, probes),
            jce.np_bloom_build(g, valid, words, probes))
    packed = np.ascontiguousarray(rng.integers(0, 2**32, (500, 3),
                                               dtype=np.uint32)
                                  .astype(">u4")).view("S12").ravel()
    lens = [0, 100, 1, 0, 250, 149]
    np.testing.assert_array_equal(ce._np_merge_run_order(packed, lens),
                                  jce._np_merge_run_order(packed, lens))


def test_cpu_engine_equals_the_torch_engine():
    """The baseline's trimmed image is the torch engine's (on the CPU):
    the two pad a job differently, and ``write_sst`` trims both."""
    images = [formats.SSTImage(*im) for im in _run_images(3, seed=2)]
    got, gst = ce.CpuCompactionEngine(GEOM).compact(images,
                                                    bottom_level=True)
    want, wst = TorchCompactionEngine(GEOM, device="cpu").compact(
        images, bottom_level=True)
    _assert_images_equal(sstable.trim_image(got), sstable.trim_image(want))
    assert _counts(gst) == _counts(wst)


# ---------------------------------------------------------------------------
# DBConfig.engine and make_engine
# ---------------------------------------------------------------------------


def test_make_engine_picks_the_named_engine():
    dev = make_engine(DBConfig(geom=GEOM), "cpu")
    assert isinstance(dev, TorchCompactionEngine)
    assert dev.device.type == "cpu" and dev.staging is None
    cpu = make_engine(DBConfig(geom=GEOM, engine="cpu", threads=8), "cpu")
    assert isinstance(cpu, ce.CpuCompactionEngine) and cpu.threads == 8
    assert DBConfig().engine == "device" and DBConfig().threads == 1
    for cfg in (DBConfig(engine="gpu"), DBConfig(engine="")):
        with pytest.raises(ValueError) as got:
            make_engine(cfg, "cpu")
        with pytest.raises(ValueError) as want:
            jmake(JConfig(engine=cfg.engine))
        assert str(got.value) == str(want.value)


def test_cpu_engine_store_touches_no_device(tmp_path, monkeypatch):
    """A baseline store on ``device="cpu"`` never builds a torch engine,
    and never asks for CUDA; an unknown engine fails before the store's
    directory exists."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(TorchCompactionEngine, "__init__", None)
    cfg = DBConfig(geom=GEOM, engine="cpu", memtable_bytes=600)
    db = LsmDB(str(tmp_path / "db"), cfg, device="cpu")
    for i in range(300):
        db.put(b"key%04d" % (i % 120), b"v%05d" % i)
    assert db.stats.flushes > 3 and db.stats.compactions > 0
    assert db.stats.compact_device_seconds == 0.0
    assert db.stats.compact_wall_seconds > 0.0
    assert db.get(b"key0119") == b"v00239"
    db.close()
    with pytest.raises(ValueError, match="unknown engine"):
        LsmDB(str(tmp_path / "bad"), DBConfig(engine="tpu"), device="cpu")
    assert not (tmp_path / "bad").exists()


# ---------------------------------------------------------------------------
# core.background
# ---------------------------------------------------------------------------


def _sst_threads():
    return [t for t in threading.enumerate() if t.name.startswith("sst-io")]


def test_prefetch_reader_yields_in_order_and_closes():
    before = len(_sst_threads())
    rdr = PrefetchReader()
    seen = []

    def read(p):
        seen.append(p)
        return p * 2

    assert list(rdr.read_all([1, 2, 3, 4], read)) == [2, 4, 6, 8]
    assert seen == [1, 2, 3, 4] and list(rdr.read_all([], read)) == []
    rdr.close()
    assert len(_sst_threads()) == before


def test_prefetch_reader_reraises_a_read_error():
    rdr = PrefetchReader()

    def read(p):
        if p == "bad":
            raise OSError(f"cannot read {p}")
        return p

    it = rdr.read_all(["a", "bad", "c"], read)
    assert next(it) == "a"
    with pytest.raises(OSError, match="cannot read bad"):
        next(it)
    assert list(rdr.read_all(["x"], read)) == ["x"]   # still usable
    rdr.close()


def test_background_executor_waits_and_reraises():
    ex = BackgroundExecutor(workers=2, name="t")
    done = []
    for i in range(20):
        ex.submit(done.append, i)
    assert ex.wait_idle(timeout=10) and sorted(done) == list(range(20))
    ex.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        ex.wait_idle(timeout=10)
    ex.check()   # the error surfaced once
    ex.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(done.append, 0)


def test_torch_engine_compact_paths_reads_ahead_and_closes(tmp_path):
    """``compact_paths`` reads through the engine's ``PrefetchReader``:
    its image is ``compact``'s on the same files, and ``close()`` stops
    the reader's thread."""
    paths = []
    for i, im in enumerate(_run_images(5, seed=8)):
        p = str(tmp_path / f"{i:06d}.sst")
        jsstable.write_sst(p, im, i)
        paths.append(p)
    before = len(_sst_threads())
    eng = TorchCompactionEngine(GEOM, device="cpu")
    got, gst = eng.compact_paths(paths)
    assert len(_sst_threads()) == before + 1
    want, wst = eng.compact([sstable.read_sst(p) for p in paths])
    _assert_images_equal(got, want)
    assert _counts(gst) == _counts(wst)
    os.remove(paths[2])
    with pytest.raises(FileNotFoundError):
        eng.compact_paths(paths)
    eng.close()
    assert len(_sst_threads()) == before
    eng.close()   # a second close is a no-op


# ---------------------------------------------------------------------------
# CompactionExecutor.compact_overlapped (Fig. 6(b))
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad_blocks", [None, 16])
def test_compact_overlapped_yields_data_then_bloom_then_stats(pad_blocks):
    images = [formats.image_from_numpy(im, "cpu")
              for im in _run_images(3, seed=1)]
    ex = offload.CompactionExecutor(GEOM, device="cpu")
    stages = list(ex.compact_overlapped(images, bottom_level=True,
                                        pad_blocks=pad_blocks))
    assert [tag for tag, _ in stages] == ["data", "bloom", "stats"]
    out, stats = ex.compact(images, bottom_level=True, pad_blocks=pad_blocks)
    data = stages[0][1]
    for got, want in zip(data + (stages[1][1],),
                         (out.keys, out.meta, out.vals, out.shared,
                          out.nvalid, out.crc, out.bloom)):
        assert torch.equal(got, want)
    assert stages[2][1] == stats
