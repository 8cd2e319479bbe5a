"""The port's failpoints, background retries and write options against the
JAX package's, on the CPU (ROADMAP A9; the twin of ``tests/test_faults.py``'s
registry, retry and engine cases).

The registry's parse, gates, scoping and seeded rates, ``classify``,
``backoff_delays`` and ``with_retries`` run through both modules on the
same inputs.  The stores run the same operations with the same specs:
``repro.lsm.db.LsmDB(engine="cpu")`` is the reference and the port's store
runs the torch engine's plain versions (``device="cpu"``).  One divergence
is pinned on purpose: a persistent ``engine.launch`` or ``engine.crc``
fault raises in the port, where JAX falls back to its CPU engine.
"""

import os
import random
import threading

import numpy as np
import pytest

from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import SchedulerConfig as JScheduler
from repro.lsm import WriteOptions as JWriteOptions
from repro.lsm import faults as jfaults
from repro.lsm.db import DBConfig as JConfig
from repro.lsm.db import LsmDB as JDB
from repro_torch import lsm as tlsm
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.lsm import WriteOptions, faults
from repro_torch.lsm import cpu_engine as port_cpu_engine
from repro_torch.lsm.db import DBConfig, DBStats, LsmDB
from repro_torch.lsm.engine import TorchCompactionEngine
from repro_torch.lsm.sharded import ShardedDB

# tests/test_faults.py's geometry and scheduler
KW = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)
WAIT = 60.0   # seconds any barrier or gate may take here
BOTH = pytest.mark.parametrize("mod", [jfaults, faults], ids=["jax", "port"])


def tcfg(**kw):
    return DBConfig(geom=SSTGeometry(**KW), engine="device",
                    memtable_bytes=kw.pop("memtable_bytes", 600),
                    scheduler=SchedulerConfig(l0_trigger=3,
                                              base_bytes=40_000),
                    bg_retry_base_s=1e-4, **kw)


def jcfg(engine="cpu", **kw):
    return JConfig(geom=JGeometry(**KW), engine=engine,
                   memtable_bytes=kw.pop("memtable_bytes", 600),
                   scheduler=JScheduler(l0_trigger=3, base_bytes=40_000),
                   bg_retry_base_s=1e-4, **kw)


def stores(tmp_path, jengine="cpu", **kw):
    """(JAX store on ``jengine``, port store) with the same config."""
    return (JDB(str(tmp_path / "j"), jcfg(jengine, **kw)),
            LsmDB(str(tmp_path / "t"), tcfg(**kw), device="cpu"))


def sst_files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".sst")}


@pytest.fixture(autouse=True)
def _clean_failpoints(monkeypatch):
    # a JAX registry of the test's own: its fire counts live as long as
    # the registry, and the JAX package's tests read them from theirs
    monkeypatch.setattr(jfaults, "FAILPOINTS", jfaults.FailpointRegistry())
    for mod in (jfaults, faults):
        mod.FAILPOINTS.clear()
    yield
    for mod in (jfaults, faults):
        mod.FAILPOINTS.clear()


# ---------------------------------------------------------------------------
# the registry, classify, backoff and retries, through both modules
# ---------------------------------------------------------------------------


SPECS = [
    "wal.append=torn, flush.build=raise:x2,engine.launch=hard:p0.25:a3",
    {"sst.write": ("crash", None, 1, 2)},
    {"manifest.append": "torn:a1:x1", "compact.round": "crash:a1:x1"},
    "engine.crc=off",
]


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_parse_grammar_same_as_jax(spec):
    want = jfaults.parse_failpoints(spec)
    got = faults.parse_failpoints(spec)
    assert {n: vars(s) for n, s in got.items()} == \
        {n: vars(s) for n, s in want.items()}
    assert faults.KNOWN_POINTS == jfaults.KNOWN_POINTS
    assert len(faults.KNOWN_POINTS) == 13


@pytest.mark.parametrize("bad", ["wal.apend=raise", "wal.append=explode",
                                 "wal.append=raise:p1.5", "wal.append",
                                 "wal.append=raise:q3"])
def test_parse_rejects_as_jax(bad):
    with pytest.raises(ValueError) as want:
        jfaults.parse_failpoints(bad)
    with pytest.raises(ValueError) as got:
        faults.parse_failpoints(bad)
    assert str(got.value) == str(want.value)


def _decisions(mod, spec, name, n, seed=7):
    """What ``fire`` did at each of ``n`` evaluations: None, "torn",
    the raised type's name and severity."""
    reg = mod.FailpointRegistry(spec, seed=seed)
    out = []
    for _ in range(n):
        try:
            out.append(reg.fire(name))
        except mod.FaultInjected as e:
            out.append(("FaultInjected", e.severity))
        except mod.SimulatedCrash:
            out.append("SimulatedCrash")
    return out, reg.fired(name), reg.fire_counts()


@pytest.mark.parametrize("spec,name", [
    ({"flush.build": "raise:a2:x1"}, "flush.build"),
    ({"flush.build": "hard:x3"}, "flush.build"),
    ({"sst.write": "torn:a4"}, "sst.write"),
    ({"engine.launch": "crash:a1:x2"}, "engine.launch"),
    ({"engine.launch": "raise:p0.5"}, "engine.launch"),
    ({"engine.crc": "raise:p0.2:a5:x9"}, "engine.crc"),
    ({"wal.append": "off"}, "wal.append"),
    ({"wal.append": "raise"}, "wal.fsync"),
])
def test_fire_gates_and_seeded_rates_as_jax(spec, name):
    want = _decisions(jfaults, spec, name, 64)
    got = _decisions(faults, spec, name, 64)
    assert got == want
    if "p0.5" in str(spec):   # the rate gate really samples
        assert 0 < got[1] < 64


def test_reseed_and_clear_as_jax():
    runs = []
    for mod in (jfaults, faults):
        reg = mod.FailpointRegistry({"engine.launch": "raise:p0.5"})
        reg.reseed(123)
        seen = []
        for _ in range(40):
            try:
                reg.fire("engine.launch")
                seen.append(0)
            except mod.FaultInjected:
                seen.append(1)
        reg.clear("engine.launch")
        assert reg.fire("engine.launch") is None
        runs.append((seen, reg.fired("engine.launch")))
    assert runs[0] == runs[1]


@BOTH
def test_active_scoping_restores_prior_spec(mod):
    reg = mod.FailpointRegistry({"wal.append": "raise"})
    with reg.active({"wal.append": "off", "sst.write": "hard"}):
        assert reg.fire("wal.append") is None
        with pytest.raises(mod.FaultInjected):
            reg.fire("sst.write")
    assert reg.fire("sst.write") is None
    with pytest.raises(mod.FaultInjected):
        reg.fire("wal.append")


def test_classify_as_jax():
    cases = [lambda m: m.FaultInjected("x", "transient"),
             lambda m: m.FaultInjected("x", "hard"),
             lambda m: OSError("disk hiccup"),
             lambda m: IOError("SST block checksum mismatch"),
             lambda m: IOError("bad CRC"),
             lambda m: ValueError("corrupt header"),
             lambda m: TypeError("logic bug"),
             lambda m: RuntimeError("CUDA error: launch failed"),
             lambda m: m.BackgroundError("flush", OSError("x")),
             lambda m: m.BackgroundError("compact", TypeError("x"))]
    assert [faults.classify(c(faults)) for c in cases] == \
        [jfaults.classify(c(jfaults)) for c in cases]
    e = faults.BackgroundError("flush", faults.FaultInjected("flush.build"))
    assert e.severity == "transient" and "resume()" in str(e)


def test_backoff_delays_as_jax():
    for args in ((4, 0.005), (3, 1e-4), (0, 1.0)):
        for kw in ({}, {"factor": 3.0, "jitter": 0.1}):
            assert list(faults.backoff_delays(*args, rng=random.Random(5),
                                              **kw)) == \
                list(jfaults.backoff_delays(*args, rng=random.Random(5),
                                            **kw))


@BOTH
def test_with_retries_transient_only(mod):
    calls = {"n": 0, "retries": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    def count():
        calls["retries"] += 1

    assert mod.with_retries(flaky, retries=3, base_s=1e-5,
                            on_retry=count) == "ok"
    assert calls == {"n": 3, "retries": 2}

    def hard():
        calls["n"] += 1
        raise IOError("corrupt block")

    calls["n"] = 0
    with pytest.raises(IOError, match="corrupt"):
        mod.with_retries(hard, retries=5, base_s=1e-5)
    assert calls["n"] == 1

    def crash():
        calls["n"] += 1
        raise mod.SimulatedCrash("flush.build")

    calls["n"] = 0
    with pytest.raises(mod.SimulatedCrash):
        mod.with_retries(crash, retries=5, base_s=1e-5)
    assert calls["n"] == 1

    def always():
        calls["n"] += 1
        raise mod.FaultInjected("flush.build")

    calls["n"] = 0
    with pytest.raises(mod.FaultInjected):
        mod.with_retries(always, retries=2, base_s=1e-5)
    assert calls["n"] == 3


def test_exports_and_stats_fields_as_jax():
    import repro.lsm as jlsm
    for name in ("FaultInjected", "SimulatedCrash", "BackgroundError",
                 "FailpointRegistry", "RepairReport", "repair_sharded"):
        assert getattr(tlsm, name).__name__ == getattr(jlsm, name).__name__
    assert tlsm.FAILPOINTS is faults.FAILPOINTS
    assert tlsm.DEFAULT_WRITE_OPTIONS == WriteOptions()
    assert vars(WriteOptions()) == vars(JWriteOptions())
    assert faults.fsync_dir is not None
    names = {f for f in DBStats.__dataclass_fields__}
    assert {"bg_retries", "bg_resumes"} <= names
    cfg, jc = DBConfig(), JConfig()
    for f in ("sync_writes", "failpoints", "bg_max_retries",
              "bg_retry_base_s"):
        assert getattr(cfg, f) == getattr(jc, f)


# ---------------------------------------------------------------------------
# the stores: background retries, halt and resume
# ---------------------------------------------------------------------------


def _puts(db, n=120):
    for i in range(n):
        db.put(b"key%03d" % i, b"val%03d" % i)


def test_transient_flush_fault_retried_as_jax(tmp_path):
    out = []
    for mod, db in zip((jfaults, faults),
                       stores(tmp_path, async_compaction=True,
                              auto_compact=False)):
        mod.FAILPOINTS.install("flush.build=raise:x2")
        _puts(db)
        db.flush()
        db.wait_idle()          # the retries absorb the fault
        assert db.stats.bg_retries == 2
        assert db.get(b"key042") == b"val042"
        db.close()
        mod.FAILPOINTS.clear()
        out.append(sst_files(db.path))
    assert out[0] == out[1] and out[0]


def test_hard_flush_fault_halts_then_resume_as_jax(tmp_path):
    """One memtable rotates onto a flush whose build fails hard: the
    store halts (``BackgroundError`` at ``flush()``, then at the next
    rotation), and after ``resume()`` its SST files are JAX's.  The writes
    fill the memtable exactly, so the halt meets the same writes in both
    stores."""
    out = []
    for mod, db in zip((jfaults, faults),
                       stores(tmp_path, async_compaction=True,
                              auto_compact=False)):
        mod.FAILPOINTS.install("flush.build=hard")
        i = 0
        while not db.imm:      # up to and with the put that rotates
            db.put(b"key%03d" % i, b"val%03d" % i)
            i += 1
        with pytest.raises(mod.BackgroundError) as ei:
            db.flush()         # nothing left to rotate: it waits
        assert ei.value.severity == "hard" and "resume()" in str(ei.value)
        with pytest.raises(IOError, match="resume"):
            for i in range(5000):
                db.put(b"x%05d" % i, b"y")
        assert db.stats.bg_retries == 0   # a hard fault is not retried
        mod.FAILPOINTS.clear()
        assert db.resume() is True
        db.wait_idle()
        assert db.stats.bg_resumes == 1
        assert db.resume() is False
        assert db.get(b"key004") == b"val004"
        db.flush()
        db.wait_idle()
        db.close()
        out.append(sst_files(db.path))
    assert out[0] == out[1] and len(out[0]) >= 2


def test_transient_compaction_fault_retried_as_jax(tmp_path):
    """``compact.install=raise:x1`` on the async store's compaction worker:
    one ``bg_retries``, the job installs on the retry, and the files equal
    JAX's."""
    out = []
    for mod, db in zip((jfaults, faults),
                       stores(tmp_path, async_compaction=True,
                              auto_compact=False)):
        _puts(db, 240)
        db.flush()
        db.wait_idle()
        mod.FAILPOINTS.install("compact.install=raise:x1")
        db.maybe_compact()
        db.wait_idle()
        assert db.stats.bg_retries == 1 and db.stats.compactions >= 1
        db.close()
        out.append(sst_files(db.path))
    assert out[0] == out[1] and out[0]


def test_sync_store_failpoints_raise_at_the_caller(tmp_path):
    """In a sync store ``flush.build`` and ``compact.install`` raise in the
    caller's thread (no retry: there is no background worker), as JAX's;
    ``db.write_batch`` leaves the batch in the WAL, replayed on reopen."""
    for mod, db in zip((jfaults, faults), stores(tmp_path,
                                                 auto_compact=False)):
        _puts(db, 30)
        with mod.FAILPOINTS.active("flush.build=raise:x1"):
            with pytest.raises(mod.FaultInjected):
                db.flush()
        db.flush()
        with mod.FAILPOINTS.active("db.write_batch=raise:x1"):
            with pytest.raises(mod.FaultInjected):
                db.write_batch([("put", b"b1", b"x"), ("put", b"b2", b"y")])
        db.close()
        again = type(db)(db.path, db.cfg, **(
            {"device": "cpu"} if mod is faults else {}))
        assert (again.get(b"b1"), again.get(b"b2")) == (b"x", b"y")
        assert again.get(b"key007") == b"val007"
        again.close()


def test_cache_insert_fires_in_the_read_path(tmp_path):
    db = LsmDB(str(tmp_path / "t"), tcfg(), device="cpu")
    _puts(db, 30)
    db.flush()
    with faults.FAILPOINTS.active("cache.insert=raise:x1"):
        with pytest.raises(faults.FaultInjected):
            db.get(b"key003")
    assert db.get(b"key003") == b"val003"
    db.close()


# ---------------------------------------------------------------------------
# the engine: one retry on the card, then raise (the JAX engine falls back)
# ---------------------------------------------------------------------------


def _fill(db, n=240):
    for i in range(n):
        db.put(b"key%03d" % ((i * 53) % n), b"val%05d" % i)
        if i % 60 == 59:
            db.flush()
            db.maybe_compact()
    db.flush()
    db.maybe_compact()
    db.wait_idle()


@pytest.mark.parametrize("point", ["engine.launch", "engine.crc"])
def test_single_engine_fault_absorbed_by_one_retry(tmp_path, point):
    ok = LsmDB(str(tmp_path / "ok"), tcfg(), device="cpu")
    _fill(ok)
    fired = jfaults.FAILPOINTS.fired(point)
    out = []
    for mod, db in zip((jfaults, faults), stores(tmp_path, "device")):
        mod.FAILPOINTS.install(f"{point}=raise:x1")
        _fill(db)
        mod.FAILPOINTS.clear()
        assert db.engine.launch_retries == 1
        assert getattr(db.engine, "fallbacks", 0) == 0
        assert db.stats.compactions == ok.stats.compactions
        db.close()
        out.append(sst_files(db.path))
    assert jfaults.FAILPOINTS.fired(point) - fired == 1
    assert out[0] == out[1] == sst_files(ok.path)
    assert ok.engine.launch_retries == 0
    ok.close()


@pytest.mark.parametrize("point", ["engine.launch", "engine.crc"])
def test_persistent_engine_fault_raises_where_jax_falls_back(tmp_path,
                                                             monkeypatch,
                                                             point):
    """The pinned divergence: JAX completes the job on its CPU engine
    (``fallbacks``); the port retries once on its device and raises, keeps
    the job's inputs, and never builds the CPU engine."""
    j, t = stores(tmp_path, "device", auto_compact=False)
    jfaults.FAILPOINTS.install(f"{point}=raise")
    _fill(j)
    assert j.engine.fallbacks >= 1 and j.stats.engine_fallbacks >= 1
    j.close()

    def no_cpu_engine(*a, **kw):
        raise AssertionError("the port built its CPU engine")

    monkeypatch.setattr(port_cpu_engine.CpuCompactionEngine, "__init__",
                        no_cpu_engine)
    _puts(t, 200)
    t.flush()
    before = sst_files(t.path)
    levels = t.level_sizes()
    assert levels[0] >= 3
    fired = faults.FAILPOINTS.fired(point)   # a lifetime count
    faults.FAILPOINTS.install(f"{point}=raise")
    with pytest.raises(faults.FaultInjected, match=point) as ei:
        t.compact_once()
    # the retry's error keeps the first attempt's as its cause
    assert isinstance(ei.value.__cause__, faults.FaultInjected)
    assert ei.value.__cause__ is not ei.value
    assert faults.FAILPOINTS.fired(point) - fired == 2   # the job, a retry
    assert t.engine.launch_retries == 1
    assert t.level_sizes() == levels and sst_files(t.path) == before
    faults.FAILPOINTS.clear()
    assert t.compact_once() and t.get(b"key042") == b"val042"
    t.close()


def test_persistent_launch_fault_on_the_async_worker(tmp_path):
    """``engine.launch=raise`` under the async compaction worker: the store
    retries the job ``bg_max_retries`` times, each with the engine's one
    retry, then halts with a transient ``BackgroundError``; after
    ``clear()`` and ``resume()`` the files are the clean store's."""
    cfg = dict(async_compaction=True, auto_compact=False)
    clean = LsmDB(str(tmp_path / "clean"), tcfg(**cfg), device="cpu")
    db = LsmDB(str(tmp_path / "t"), tcfg(**cfg), device="cpu")
    for s in (clean, db):
        _puts(s, 240)
        s.flush()
        s.wait_idle()
    clean.maybe_compact()
    clean.wait_idle()
    fired = faults.FAILPOINTS.fired("engine.launch")
    faults.FAILPOINTS.install("engine.launch=raise")
    db.maybe_compact()
    with pytest.raises(faults.BackgroundError) as ei:
        db.wait_idle(timeout=WAIT)
    assert ei.value.severity == "transient"
    assert faults.FAILPOINTS.fired("engine.launch") - fired == (3 + 1) * 2
    assert db.stats.bg_retries == 3 and db.engine.launch_retries == 4
    faults.FAILPOINTS.clear()
    assert db.resume() is True
    db.maybe_compact()
    db.wait_idle(timeout=WAIT)
    for s in (clean, db):
        s.close()
    assert sst_files(db.path) == sst_files(clean.path)


def test_stacked_launch_fault_reruns_its_jobs_one_by_one(tmp_path):
    """``compact_many``: a stacked launch that raises runs its jobs again
    on the single-job path (one ``launch_retries``), each result equal to
    the clean stacked launch's."""
    cfg = tcfg(auto_compact=False)
    db = ShardedDB(str(tmp_path / "s"), cfg, boundaries=[b"key200"],
                   device="cpu")
    for i in range(400):
        db.put(b"key%03d" % ((i * 7) % 400), b"v%05d" % i)
        if i % 50 == 49:
            db.flush()
    jobs = []
    for s in db.shards:
        job = s.pick_compaction()
        jobs.append(([f.path for f in job.all_inputs], job.bottom_level))
    eng = TorchCompactionEngine(cfg.geom, device="cpu")
    clean = eng.compact_many(jobs)
    assert eng.batch_launches == 1 and eng.launch_retries == 0
    with faults.FAILPOINTS.active("engine.launch=raise:x1"):
        got = eng.compact_many(jobs)
    assert eng.launch_retries == 1 and eng.batch_launches == 2
    for (a, ea), (b, eb) in zip(clean, got):
        assert ea.batched and not eb.batched and eb.crc_ok
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    eng.close()
    db.close()


def test_persistent_stacked_launch_fault_raises_with_its_first_error(
        tmp_path):
    """``compact_many`` under ``engine.launch=raise``: the stacked launch
    fails, its first job's rerun and that rerun's retry fail too, and the
    error raised names the stacked launch's error (its cause is the
    rerun's first attempt)."""
    cfg = tcfg(auto_compact=False)
    db = ShardedDB(str(tmp_path / "s"), cfg, boundaries=[b"key200"],
                   device="cpu")
    for i in range(400):
        db.put(b"key%03d" % ((i * 7) % 400), b"v%05d" % i)
        if i % 50 == 49:
            db.flush()
    jobs = []
    for s in db.shards:
        job = s.pick_compaction()
        jobs.append(([f.path for f in job.all_inputs], job.bottom_level))
    eng = TorchCompactionEngine(cfg.geom, device="cpu")
    fired = faults.FAILPOINTS.fired("engine.launch")
    with faults.FAILPOINTS.active("engine.launch=raise"), \
            pytest.raises(faults.FaultInjected) as ei:
        eng.compact_many(jobs)
    assert faults.FAILPOINTS.fired("engine.launch") - fired == 3
    assert eng.launch_retries == 2   # the stacked rerun, the job's retry
    assert isinstance(ei.value.__cause__, faults.FaultInjected)
    assert any("stacked launch of 2 jobs" in n
               for n in getattr(ei.value, "__notes__", []))
    eng.close()
    db.close()


def test_resume_refuses_a_crashed_store(tmp_path):
    """A flush worker's ``SimulatedCrash`` is a process death: ``resume()``
    raises it again and does not restart the store's workers."""
    db = LsmDB(str(tmp_path / "t"),
               tcfg(async_compaction=True, auto_compact=False),
               device="cpu")
    faults.FAILPOINTS.install("flush.build=crash:x1")
    i = 0
    while not db.imm:
        db.put(b"key%03d" % i, b"val%03d" % i)
        i += 1
    with pytest.raises(faults.SimulatedCrash):
        db.wait_idle(timeout=WAIT)
    faults.FAILPOINTS.clear()
    for _ in range(2):
        with pytest.raises(faults.SimulatedCrash):
            db.resume()
    assert db.stats.bg_resumes == 0 and len(db.imm) == 1
    with pytest.raises(faults.SimulatedCrash):
        db.put(b"zz", b"after")
        db.flush()
    from repro_torch.testing import crashmatrix
    crashmatrix._abandon(db)


def test_compact_round_fires_in_the_queue(tmp_path):
    db = ShardedDB(str(tmp_path / "s"), tcfg(), boundaries=[b"key060"],
                   device="cpu")
    faults.FAILPOINTS.install("compact.round=raise:x1")
    with pytest.raises(faults.FaultInjected, match="compact.round"):
        _puts(db, 240)
        db.flush()
        db.maybe_compact()
    faults.FAILPOINTS.clear()
    db.maybe_compact()
    assert db.get(b"key100") == b"val100"
    db.close()


# ---------------------------------------------------------------------------
# write options
# ---------------------------------------------------------------------------


def test_write_options_sync_override_as_jax(tmp_path, monkeypatch):
    """``WriteOptions.sync`` forces or skips the WAL fsync a call, in both
    directions, as JAX's: the fsyncs a call are counted."""
    real = os.fsync
    calls = []

    def fsync(fd):
        calls.append(fd)
        return real(fd)

    monkeypatch.setattr(os, "fsync", fsync)
    seen = []
    for wo, mod in ((JWriteOptions, jfaults), (WriteOptions, faults)):
        counts = []
        for synced in (False, True):
            path = tmp_path / f"{mod.__name__}-{synced}"
            db = (JDB(str(path), jcfg(sync_writes=synced)) if mod is jfaults
                  else LsmDB(str(path), tcfg(sync_writes=synced),
                             device="cpu"))
            for opts in (None, wo(sync=True), wo(sync=False), wo()):
                del calls[:]
                db.put(b"k", b"v", opts)
                db.delete(b"k", opts)
                db.write_batch([("put", b"a", b"1")], opts)
                counts.append(len(calls))
            db.close()
        seen.append(counts)
    assert seen[0] == seen[1] == [0, 3, 0, 0, 3, 3, 0, 3]


def test_wait_stall_false_sheds_as_jax(tmp_path):
    """With the immutable queue full (its one flush parked),
    ``WriteOptions(wait_stall=False)`` raises ``IOError`` at the rotation;
    the triggering write is in the WAL and the memtable, and every
    acknowledged write reads back after the drain."""
    for wo, db in zip((JWriteOptions, WriteOptions),
                      stores(tmp_path, async_compaction=True,
                             auto_compact=False, max_pending_memtables=1)):
        gate = threading.Event()
        real = db.engine.build_image

        def parked(*a, real=real, gate=gate):
            gate.wait(WAIT)
            return real(*a)

        db.engine.build_image = parked
        acked = {}
        shed = None
        for i in range(200):
            k, v = b"key%03d" % i, b"val%03d" % i
            try:
                db.put(k, v, wo(wait_stall=False))
            except IOError as e:
                shed = (i, str(e))
                acked[k] = v     # written before the rotation was refused
                break
            acked[k] = v
        assert shed is not None and "wait_stall" in shed[1]
        assert db.stats.write_stalls == 0
        assert db.get(b"key%03d" % shed[0]) == b"val%03d" % shed[0]
        gate.set()
        db.wait_idle()
        db.flush()
        db.wait_idle()
        assert all(db.get(k) == v for k, v in acked.items())
        db.close()
