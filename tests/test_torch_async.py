"""The port's async write path against the JAX package's, on the CPU
(ROADMAP A8; the twin of ``tests/test_async.py``, case for case).

``repro_torch.lsm.db.LsmDB(async_compaction=True, device="cpu")`` runs its
flush workers and compaction worker on the torch engine's plain versions;
``repro.lsm.db.LsmDB(engine="cpu", async_compaction=True)`` is the
reference.  With ``auto_compact=False`` the installs are sequenced, so the
async store's SST files are the sync store's and JAX's, byte for byte,
before and after ``maybe_compact()`` + ``wait_idle()``.  With
``auto_compact=True`` compactions interleave with flushes, so contents are
compared (``get``, ``multi_get``, the full ``scan``).  Every wait is
bounded, so a regression fails instead of hanging.
"""

import itertools
import os
import sys
import threading
import time

import numpy as np
import pytest

from repro.core.background import InstallSequencer as JSequencer
from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import SchedulerConfig as JScheduler
from repro.lsm.db import DBConfig as JConfig
from repro.lsm.db import LsmDB as JDB
from repro_torch.core.background import BackgroundExecutor, InstallSequencer
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.lsm.faults import BackgroundError

# tests/test_async.py's geometry and scheduler
KW = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)
WAIT = 60.0   # seconds any barrier, join or gate may take here


def acfg(engine="device", **kw):
    return DBConfig(geom=SSTGeometry(**KW), engine=engine,
                    memtable_bytes=kw.pop("memtable_bytes", 600),
                    scheduler=SchedulerConfig(l0_trigger=3,
                                              base_bytes=40_000),
                    async_compaction=kw.pop("async_compaction", True), **kw)


def jcfg(**kw):
    return JConfig(geom=JGeometry(**KW), engine="cpu",
                   memtable_bytes=kw.pop("memtable_bytes", 600),
                   scheduler=JScheduler(l0_trigger=3, base_bytes=40_000),
                   async_compaction=kw.pop("async_compaction", True), **kw)


def port(path, **kw) -> LsmDB:
    return LsmDB(str(path), acfg(**kw), device="cpu")


def apply_workload(db, n_ops=700, n_keys=120, seed=0):
    model = {}
    rng = np.random.default_rng(seed)
    for i in range(n_ops):
        k = b"key%03d" % rng.integers(0, n_keys)
        if rng.random() < 0.15:
            db.delete(k)
            model.pop(k, None)
        else:
            v = b"v%06d" % i
            db.put(k, v)
            model[k] = v
    return model


def sst_files(path):
    return {int(f[:-4]): open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".sst")}


def gated(engine):
    """Park ``engine.build_image`` until the returned event is set (at most
    ``WAIT`` seconds)."""
    gate = threading.Event()
    real = engine.build_image

    def build(*a, **kw):
        gate.wait(timeout=WAIT)
        return real(*a, **kw)
    engine.build_image = build
    return gate


def failing_once(engine, exc=RuntimeError("injected flush failure"),
                 gate=None):
    """Make the next ``engine.build_image`` raise ``exc``, once (after
    ``gate`` is set, when one is given)."""
    real = engine.build_image
    state = {"armed": True}

    def build(*a, **kw):
        if state["armed"]:
            state["armed"] = False
            if gate is not None:
                gate.wait(timeout=WAIT)
            raise exc
        return real(*a, **kw)
    engine.build_image = build


def reversed_builds(engine):
    """Hold the first ``engine.build_image`` until the second has returned,
    so two flush workers finish their builds out of rotation order."""
    real = engine.build_image
    calls = itertools.count()
    second_done = threading.Event()

    def build(*a, **kw):
        n = next(calls)
        if n == 0:
            second_done.wait(timeout=WAIT)
        try:
            return real(*a, **kw)
        finally:
            if n == 1:
                second_done.set()
    engine.build_image = build
    return second_done


def join(threads):
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# background primitives
# ---------------------------------------------------------------------------


def test_executor_wait_idle_and_error_propagation():
    ex = BackgroundExecutor(workers=2)
    hits = []
    ex.submit(hits.append, 1)
    ex.submit(hits.append, 2)
    assert ex.wait_idle(timeout=WAIT)
    assert sorted(hits) == [1, 2]

    def boom():
        raise RuntimeError("bg failure")
    ex.submit(boom)
    with pytest.raises(RuntimeError, match="bg failure"):
        ex.wait_idle(timeout=WAIT)
    ex.shutdown()


@pytest.mark.parametrize("seq_cls", [InstallSequencer, JSequencer],
                         ids=["port", "jax"])
def test_install_sequencer_orders_out_of_order_workers(seq_cls):
    """Workers holding tickets 3, 1, 2 start first; ticket 0 comes last:
    the installs still land 0, 1, 2, 3 -- in both packages."""
    seq = seq_cls()
    tickets = [seq.issue() for _ in range(4)]
    assert tickets == [0, 1, 2, 3]
    order = []

    def worker(t):
        seq.wait_turn(t)
        order.append(t)
        seq.done(t)
    threads = [threading.Thread(target=worker, args=(t,)) for t in (3, 1, 2)]
    for th in threads:
        th.start()
    time.sleep(0.05)
    assert order == []          # every later ticket waits behind ticket 0
    worker(0)
    join(threads)
    assert order == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["device", "cpu"])
def test_async_matches_sync_contents(tmp_path, engine):
    """After ``wait_idle`` the port's async store (two flush workers,
    compaction in the background) answers every ``get``, ``multi_get`` and
    the full ``scan`` as the port's sync store and JAX's async store do."""
    sync_db = port(tmp_path / "sync", engine=engine, async_compaction=False)
    async_db = port(tmp_path / "async", engine=engine, flush_workers=2)
    jdb = JDB(str(tmp_path / "jax"), jcfg(flush_workers=2))
    model = apply_workload(sync_db)
    assert apply_workload(async_db) == apply_workload(jdb) == model
    async_db.wait_idle(timeout=WAIT)
    jdb.wait_idle()
    assert not async_db.imm
    keys = [b"key%03d" % i for i in range(120)]
    want = [model.get(k) for k in keys]
    assert [async_db.get(k) for k in keys] == want
    assert [sync_db.get(k) for k in keys] == [jdb.get(k) for k in keys] \
        == want
    assert async_db.multi_get(keys) == jdb.multi_get(keys) == want
    everything = (b"", b"\xff" * 17)
    assert async_db.scan(*everything) == jdb.scan(*everything) == \
        sorted(model.items())
    st = async_db.stats
    assert st.flushes > 1 and st.compactions + st.trivial_moves >= 1
    assert st.flushes == sync_db.stats.flushes == jdb.stats.flushes
    for db in (sync_db, async_db, jdb):
        db.close()


def test_flush_workers_preserve_rotation_order(tmp_path):
    """Overwrites of one key span many rotated memtables; with three flush
    workers the L0 installs still land in rotation order, also when the
    first build finishes after the second."""
    db = port(tmp_path / "db", flush_workers=3, memtable_bytes=300)
    jdb = JDB(str(tmp_path / "jax"), jcfg(flush_workers=3,
                                          memtable_bytes=300))
    for d in (db, jdb):
        out_of_order = reversed_builds(d.engine)
        for i in range(400):
            d.put(b"hot", b"v%06d" % i)       # the same key every time
            d.put(b"fill%04d" % i, b"x" * 8)  # forces rotations
        assert out_of_order.wait(timeout=WAIT)
    db.wait_idle(timeout=WAIT)
    jdb.wait_idle()
    assert db.get(b"hot") == jdb.get(b"hot") == b"v%06d" % 399
    assert db.scan(b"", b"\xff") == jdb.scan(b"", b"\xff")
    assert db.stats.flushes == jdb.stats.flushes > 10
    db.close()
    jdb.close()


def test_put_does_not_block_on_flush(tmp_path):
    """A rotation is orders faster than the flush it hands on: park the
    flush worker and keep writing; queued tables stay readable."""
    db = port(tmp_path / "db", memtable_bytes=300, max_pending_memtables=64)
    gate = gated(db.engine)
    t0 = time.perf_counter()
    for i in range(120):
        db.put(b"k%04d" % i, b"x" * 16)   # several rotations land here
    put_wall = time.perf_counter() - t0
    assert db.stats.write_stalls == 0
    assert len(db.imm) >= 1               # the flush is parked on the gate
    assert put_wall < 5.0
    for i in range(120):                  # reads see the queued memtables
        assert db.get(b"k%04d" % i) == b"x" * 16
    assert db.level_sizes()[0] == 0
    gate.set()
    db.wait_idle(timeout=WAIT)
    for i in range(120):
        assert db.get(b"k%04d" % i) == b"x" * 16
    assert db.level_sizes()[0] + db.level_sizes()[1] > 0
    db.close()


def test_write_stall_backpressure(tmp_path):
    """``max_pending_memtables=1``: a writer that outruns its flushes
    stalls (counted) and resumes as they drain."""
    db = port(tmp_path / "db", memtable_bytes=300, max_pending_memtables=1)
    slow = threading.Semaphore(0)
    real_build = db.engine.build_image

    def slow_build(*a, **kw):
        slow.acquire(timeout=WAIT)
        return real_build(*a, **kw)
    db.engine.build_image = slow_build
    done = threading.Event()

    def writer():
        for i in range(200):
            db.put(b"w%04d" % i, b"y" * 16)
        done.set()
    th = threading.Thread(target=writer)
    th.start()
    for _ in range(400):
        slow.release()
        time.sleep(0.001)
    join([th])
    assert done.is_set()
    assert db.stats.write_stalls >= 1
    db.wait_idle(timeout=WAIT)
    for i in range(200):
        assert db.get(b"w%04d" % i) == b"y" * 16
    db.close()


def test_background_error_surfaces_as_a_classified_error(tmp_path):
    """A failed flush surfaces at the next rotation or ``wait_idle`` as a
    ``BackgroundError`` (an ``IOError``) carrying the cause and its
    severity -- as JAX's, whose retries do not touch a hard error -- and
    the failed memtable stays queued and readable."""
    errs = []
    for name, db in (("port", port(tmp_path / "db", memtable_bytes=300)),
                     ("jax", JDB(str(tmp_path / "jax"),
                                 jcfg(memtable_bytes=300)))):
        def broken_build(*a, **kw):
            raise RuntimeError("injected flush failure")
        db.engine.build_image = broken_build
        with pytest.raises(IOError, match="injected flush failure") as ei:
            for i in range(60):
                db.put(b"e%04d" % i, b"z" * 16)
            db.wait_idle(**({"timeout": WAIT} if name == "port" else {}))
        errs.append(ei.value)
        assert db.get(b"e0000") == b"z" * 16
        assert db.level_sizes()[0] == 0
    ported, ref = errs
    assert type(ported).__name__ == type(ref).__name__ == "BackgroundError"
    assert isinstance(ported, BackgroundError)
    assert (ported.op, ported.severity) == (ref.op, ref.severity) == \
        ("flush", "hard")
    assert repr(ported.cause) == repr(ref.cause)


def test_failed_flush_halts_younger_installs_no_stale_reads(tmp_path):
    """An older memtable's failed flush halts the pipeline: no younger
    memtable installs below it (its older value would shadow the newer
    one for good), and the newer value wins -- in both packages."""
    for db in (port(tmp_path / "db", memtable_bytes=300,
                    max_pending_memtables=64),
               JDB(str(tmp_path / "jax"), jcfg(memtable_bytes=300,
                                               max_pending_memtables=64,
                                               bg_max_retries=0))):
        failing_once(db.engine, RuntimeError("transient flush failure"))
        with pytest.raises((RuntimeError, IOError)):
            db.put(b"hot", b"old")
            for i in range(40):
                db.put(b"f%04d" % i, b"x" * 16)   # rotation 1: fails
            db.put(b"hot", b"new")
            for i in range(40):
                db.put(b"g%04d" % i, b"x" * 16)   # rotation 2: must wait
            if isinstance(db, LsmDB):
                db.wait_idle(timeout=WAIT)
            else:
                db.wait_idle()
        assert db.get(b"hot") == b"new"
        assert db.level_sizes()[0] == 0


def test_async_flush_api_drains(tmp_path):
    db = port(tmp_path / "db")
    for i in range(40):
        db.put(b"f%04d" % i, b"v%04d" % i)
    db.flush()
    assert len(db.mem) == 0 and not db.imm
    assert db.stats.flushes >= 1
    for i in range(40):
        assert db.get(b"f%04d" % i) == b"v%04d" % i
    db.close()


def test_async_reopen_after_close(tmp_path):
    """Close drains; the directory reopens in the port (async and sync)
    and in JAX with every acknowledged write."""
    path = tmp_path / "db"
    db = port(path)
    model = apply_workload(db, n_ops=500)
    db.close()
    keys = [b"key%03d" % i for i in range(120)]
    for reopened in (port(path), port(path, async_compaction=False),
                     JDB(str(path), jcfg())):
        assert [reopened.get(k) for k in keys] == \
            [model.get(k) for k in keys]
        reopened.close()


def test_concurrent_readers_during_compaction(tmp_path):
    """``get`` and ``multi_get`` stay right while background flushes and
    compactions change the version set under them."""
    db = port(tmp_path / "db", memtable_bytes=400)
    stop = threading.Event()
    errors = []
    sample = [b"key%03d" % kid for kid in (0, 13, 77)]

    def reader():
        while not stop.is_set():
            for k, v in zip(sample, db.multi_get(sample)):
                if v is not None and not v.startswith(b"v"):
                    errors.append((k, v))
            for k in sample:
                v = db.get(k)
                if v is not None and not v.startswith(b"v"):
                    errors.append((k, v))
    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        model = apply_workload(db, n_ops=900, n_keys=90, seed=3)
        db.wait_idle(timeout=WAIT)
    finally:
        stop.set()
        join(threads)
    assert not errors
    assert db.stats.compactions >= 1
    for kid in range(90):
        k = b"key%03d" % kid
        assert db.get(k) == model.get(k), k
    db.close()


def test_readers_never_see_a_stale_or_unwritten_value(tmp_path):
    """Stress: 8 reader threads (more threads than this machine's cores
    with the flush workers) and a switch interval of 10 us against a
    writer of stamped values.  A read must return a value the writer
    issued for that key, and none older than the last one acknowledged
    before the read began (a lost install or a flush below a newer one
    breaks it)."""
    db = port(tmp_path / "db", memtable_bytes=300, flush_workers=4)
    keys = [b"s%02d" % i for i in range(16)]
    issued = {k: [] for k in keys}      # values in put order
    acked = {k: 0 for k in keys}        # how many of them returned
    errors, stop = [], threading.Event()

    def check(k, got, floor):
        vals = issued[k][:]
        if got is None:
            ok = floor == 0
        else:
            ok = got in vals and vals.index(got) >= floor - 1
        if not ok:
            errors.append((k, got, floor))

    def reader(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            k = keys[int(rng.integers(len(keys)))]
            floor = acked[k]
            check(k, db.get(k), floor)
            floors = [acked[x] for x in keys]
            for x, got, f in zip(keys, db.multi_get(keys), floors):
                check(x, got, f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader, args=(s,)) for s in range(8)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 8
        for i in range(1500):
            k = keys[i % len(keys)]
            v = b"%s-%05d" % (k, i)
            issued[k].append(v)
            db.put(k, v)
            acked[k] += 1
            db.put(b"f%05d" % i, b"x" * 8)   # forces rotations
            if time.monotonic() > deadline:
                break
        db.wait_idle(timeout=WAIT)
    finally:
        stop.set()
        join(threads)
        sys.setswitchinterval(old)
    assert not errors, errors[:5]
    assert db.stats.flushes > 5
    assert [db.get(k) for k in keys] == [issued[k][-1] for k in keys]
    db.close()


def test_resume_requeues_and_installs(tmp_path):
    """A failed build halts the pipeline; ``resume()`` issues new tickets
    to the queued memtables, their flushes install in rotation order,
    and the L0 files are a sync store's for the same stream -- and JAX's
    after its own ``resume()`` (with no retries, as the port has none).
    The first build fails only once the whole stream is queued, so every
    rotation happens where the sync store flushes."""
    stream = [(b"r%04d" % (i % 70), b"v%05d" % i) for i in range(90)]
    sync_db = port(tmp_path / "sync", async_compaction=False,
                   auto_compact=False, memtable_bytes=300)
    for k, v in stream:
        sync_db.put(k, v)
    sync_db.flush()
    stores = [(port(tmp_path / "db", auto_compact=False, memtable_bytes=300,
                    flush_workers=2, max_pending_memtables=64), True),
              (JDB(str(tmp_path / "jax"),
                   jcfg(auto_compact=False, memtable_bytes=300,
                        flush_workers=2, max_pending_memtables=64,
                        bg_max_retries=0)), False)]
    for db, is_port in stores:
        wait = (lambda d=db: d.wait_idle(timeout=WAIT)) if is_port \
            else db.wait_idle
        assert not db.resume()            # nothing to clear
        gate = threading.Event()
        failing_once(db.engine, gate=gate)
        for k, v in stream:
            db.put(k, v)
        queued = len(db.imm)
        gate.set()
        with pytest.raises(IOError, match="injected flush failure"):
            wait()
        assert queued >= 3 and len(db.imm) == queued
        assert db.level_sizes()[0] == 0
        for k, v in dict(stream).items():  # the queue stays readable
            assert db.get(k) == v
        assert db.resume()
        db.flush()
        wait()
        assert not db.imm
        assert db.resume() is False
        for k, v in dict(stream).items():
            assert db.get(k) == v
    (tdb, _), (jdb, _) = stores
    assert sst_files(tdb.path) == sst_files(jdb.path) == \
        sst_files(sync_db.path) != {}
    for db in (sync_db, tdb, jdb):
        db.close()


def workload(seed: int, n_ops: int, keyspace: int):
    """Seeded puts (many overwrites), deletes and write_batches."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        k = b"key%05d" % rng.integers(0, keyspace)
        r = rng.random()
        if r < 0.12:
            ops.append(("delete", k))
        elif r < 0.2:
            ops.append(("batch", [("put", b"key%05d" % rng.integers(
                0, keyspace), b"b%06d" % (i * 10 + j)) for j in range(5)]
                + [("delete", b"key%05d" % rng.integers(0, keyspace))]))
        else:
            ops.append(("put", k, b"v%06d" % i))
    return ops


def apply(db, ops):
    for op in ops:
        if op[0] == "put":
            db.put(op[1], op[2])
        elif op[0] == "delete":
            db.delete(op[1])
        else:
            db.write_batch(op[1])


@pytest.mark.parametrize("flush_workers", [1, 3])
def test_async_files_are_the_sync_and_jax_files(tmp_path, flush_workers):
    """The bit-for-bit gate: with ``auto_compact=False`` the installs are
    sequenced and the file numbers are taken inside them, so the port's
    async store writes the SST files of JAX's async store and of the
    port's sync store for one seeded stream, whatever ``flush_workers``
    is (with several workers the first build is made to finish after the
    second); after ``maybe_compact()`` + ``wait_idle()`` the drain runs
    alone, so the files match again."""
    ops = workload(5, 1500, 300)
    sync_db = port(tmp_path / "sync", async_compaction=False,
                   auto_compact=False)
    tdb = port(tmp_path / "port", auto_compact=False,
               flush_workers=flush_workers, max_pending_memtables=4)
    jdb = JDB(str(tmp_path / "jax"), jcfg(auto_compact=False,
                                          flush_workers=flush_workers))
    if flush_workers > 1:
        reversed_builds(tdb.engine)
    for db in (sync_db, tdb, jdb):
        apply(db, ops)
    tdb.wait_idle(timeout=WAIT)
    jdb.wait_idle()
    first = sst_files(sync_db.path)
    assert len(first) > 20
    assert sst_files(tdb.path) == sst_files(jdb.path) == first
    for db in (sync_db, tdb, jdb):
        db.maybe_compact()
    tdb.wait_idle(timeout=WAIT)
    jdb.wait_idle()
    after = sst_files(sync_db.path)
    assert after != first and sync_db.stats.compactions >= 1
    assert sst_files(tdb.path) == sst_files(jdb.path) == after
    assert tdb.level_sizes() == jdb.level_sizes() == sync_db.level_sizes()
    st = tdb.stats
    assert (st.flushes, st.compactions, st.trivial_moves) == \
        (jdb.stats.flushes, jdb.stats.compactions, jdb.stats.trivial_moves)
    for db in (sync_db, tdb, jdb):
        db.close()
