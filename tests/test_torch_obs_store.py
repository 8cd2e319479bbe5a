"""The port's metrics and tracing wired through the store (ROADMAP A10),
against the JAX store's on the CPU: the registry counters and histogram
counts of the same seeded operations, counts that stay exact under
racing writers and readers, span nesting with the launch spans' measured
child phases, the sharded store's shared registry and stacked launch,
and the cost of the instrumentation.  Also A20's names of the modules
this touches (``DecodedBlock.nbytes``, ``TableReader.n_blocks``,
``cpu_engine.np_bloom_query``)."""

import contextlib
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import SchedulerConfig as JScheduler
from repro.lsm import cpu_engine as jce
from repro.lsm import sstable as jsst
from repro.lsm.db import DBConfig as JConfig
from repro.lsm.db import DBStats as JStats
from repro.lsm.db import LsmDB as JDB
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.device import DeviceTimer
from repro_torch.lsm import ReadOptions, sstable
from repro_torch.lsm import cpu_engine as tce
from repro_torch.lsm.db import DBConfig, DBStats, LsmDB
from repro_torch.lsm.engine import PHASE_SPANS
from repro_torch.lsm.sharded import ShardedDB
from repro_torch.obs import (NULL_REGISTRY, MetricsRegistry, Tracer,
                             merge_histograms)

# JAX's tests/test_obs.py ``obs_cfg`` geometry and scheduler
KW = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)
SCHED = dict(l0_trigger=3, base_bytes=40_000)
# the port's own DBStats fields (JAX has none of them)
PORT_ONLY = {"multi_get_waves", "multi_get_staged_bytes",
             "multi_get_stage_seconds", "compact_wall_seconds"}


def obs_cfg(engine="device", **kw):
    return DBConfig(geom=SSTGeometry(**KW), engine=engine,
                    memtable_bytes=kw.pop("memtable_bytes", 600),
                    scheduler=SchedulerConfig(**SCHED), **kw)


def jax_cfg(**kw):
    return JConfig(geom=JGeometry(**KW), engine="cpu",
                   memtable_bytes=kw.pop("memtable_bytes", 600),
                   scheduler=JScheduler(**SCHED), **kw)


def seeded_ops(seed: int, n: int, keyspace: int) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        k = b"key%05d" % rng.integers(0, keyspace)
        r = rng.random()
        if r < 0.1:
            ops.append(("delete", k))
        elif r < 0.16:
            ops.append(("batch", [("put", b"key%05d" % rng.integers(
                0, keyspace), b"b%06d" % (10 * i + j)) for j in range(4)]
                + [("delete", b"key%05d" % rng.integers(0, keyspace))]))
        elif r < 0.4:
            ops.append(("get", k))
        elif r < 0.43:
            ops.append(("multi_get", [b"key%05d" % x for x in
                                      rng.integers(0, keyspace, 24)]))
        else:
            ops.append(("put", k, b"v%06d" % i))
    return ops


def drive(db, ops) -> list:
    out = []
    for op in ops:
        if op[0] == "put":
            db.put(op[1], op[2])
        elif op[0] == "delete":
            db.delete(op[1])
        elif op[0] == "batch":
            db.write_batch(op[1])
        elif op[0] == "get":
            out.append(db.get(op[1]))
        else:
            out.append(db.multi_get(op[1]))
    db.flush()
    out.append(db.scan(b"key", b"kez"))
    return out


def counters(reg, labels=()) -> dict:
    return {c["name"]: c["value"] for c in reg.snapshot()["counters"]
            if tuple(sorted(c["labels"].items())) == tuple(labels)}


def hist_counts(reg) -> dict:
    return {(h["name"], tuple(sorted(h["labels"].items()))): h["count"]
            for h in reg.snapshot()["histograms"]}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("engine", ["device", "cpu"])
def test_registry_equals_jax_store(tmp_path, engine, seed):
    """The same seeded writes, reads, batches and ``multi_get``s on the
    JAX store (``engine="cpu"``) and on the port's (either engine, on the
    CPU): every shared ``lsm.*`` counter equal but the timings, the
    histograms' counts equal, the gauges equal, the reads equal."""
    ops = seeded_ops(seed, 1800, 300)
    jreg, treg = JRegistry(), MetricsRegistry()
    jdb = JDB(str(tmp_path / "jax"), jax_cfg(metrics=jreg))
    tdb = LsmDB(str(tmp_path / "port"), obs_cfg(engine, metrics=treg),
                device="cpu")
    assert drive(tdb, ops) == drive(jdb, ops)
    jc, tc = counters(jreg), counters(treg)
    shared = {f"lsm.{f.name}" for f in dataclasses.fields(JStats)}
    assert set(tc) == shared | {f"lsm.{n}" for n in PORT_ONLY}
    timings = {n for n in shared if n.endswith("_seconds")}
    for name in sorted(shared - timings):
        assert tc[name] == jc[name], name
    assert tc["lsm.compactions"] > 2 and tc["lsm.block_cache_hits"] > 0
    assert tc["lsm.block_cache_misses"] > 0 and tc["lsm.multi_gets"] > 0
    assert tc["lsm.engine_fallbacks"] == 0
    assert hist_counts(treg) == hist_counts(jreg)
    gauges = {g["name"]: g["value"] for g in treg.snapshot()["gauges"]}
    assert gauges == {g["name"]: g["value"]
                      for g in jreg.snapshot()["gauges"]}
    # the stats snapshot reads the same live counters
    s = tdb.stats
    assert isinstance(s, DBStats)
    assert {f.name for f in dataclasses.fields(DBStats)} >= \
        {f.name for f in dataclasses.fields(JStats)}
    for f in dataclasses.fields(DBStats):
        assert getattr(s, f.name) == pytest.approx(tc[f"lsm.{f.name}"])
    assert s.puts == treg.find("lsm.op.latency_us", op="put").count
    jdb.close()
    tdb.close()


def test_stats_snapshot_and_null_registry(tmp_path):
    reg = MetricsRegistry()
    db = LsmDB(str(tmp_path / "db"), obs_cfg("cpu"), device="cpu",
               metrics=reg)
    for i in range(50):
        db.put(b"key%04d" % i, b"v%04d" % i)
    db.get(b"key0001")
    db.flush()
    s = db.stats
    assert s.puts == 50 and s.gets == 1 and s.flushes >= 1
    assert reg.counter("lsm.puts").value == 50
    db.put(b"more", b"v")
    assert s.puts == 50 and db.stats.puts == 51
    assert s.add(db.stats).puts == 101
    db.close()
    null = LsmDB(str(tmp_path / "null"), obs_cfg("cpu", metrics=NULL_REGISTRY),
                 device="cpu")
    null.put(b"k", b"v")
    assert null.stats == DBStats() and null.get(b"k") == b"v"
    null.close()


def test_counts_exact_under_racing_writers_and_readers(tmp_path):
    """JAX's conservation test, twinned: 8 writer threads on an async
    store, and beside them 4 readers whose ``get`` and ``multi_get``
    counts (bumped outside the store's lock) must come out exact."""
    db = LsmDB(str(tmp_path / "db"),
               obs_cfg(async_compaction=True, flush_workers=2), device="cpu")
    n_writers, per, n_readers, reads, batch = 8, 200, 4, 150, 6
    errs, stop = [], threading.Event()

    def writer(t):
        try:
            for i in range(per):
                db.put(b"t%02d-%04d" % (t, i), b"v%04d" % i)
        except BaseException as e:   # noqa: BLE001 - surfaced below
            errs.append(e)

    def reader(r):
        try:
            rng = np.random.default_rng(r)
            for i in range(reads):
                keys = [b"t%02d-%04d" % (rng.integers(0, n_writers),
                                         rng.integers(0, per))
                        for _ in range(batch)]
                db.get(keys[0])
                if i % 3 == 0:
                    db.multi_get(keys)
        except BaseException as e:   # noqa: BLE001 - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=writer, args=(t,))
          for t in range(n_writers)]
    ts += [threading.Thread(target=reader, args=(r,))
           for r in range(n_readers)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    stop.set()
    db.wait_idle(timeout=120)
    assert not errs and not any(t.is_alive() for t in ts)
    s = db.stats
    assert s.puts == n_writers * per
    assert s.gets == n_readers * reads
    assert s.multi_gets == n_readers * len(range(0, reads, 3))
    assert s.multi_get_keys == s.multi_gets * batch
    reg = db.metrics
    for op, n in (("put", s.puts), ("get", s.gets),
                  ("multi_get", s.multi_gets)):
        assert reg.find("lsm.op.latency_us", op=op).count == n
    assert len(db.scan(b"t00", b"t99")) == n_writers * per
    db.close()


def check_nesting(events):
    """Spans on one thread nest (JAX's ``tests/test_obs.py`` check)."""
    per_tid = {}
    for e in events:
        if e.get("ph") == "X":
            per_tid.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
    assert per_tid, "trace has no spans"
    for tid, spans in per_tid.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack = []
        for t0, t1, name in spans:
            while stack and t0 >= stack[-1][1] - 1e-6:
                stack.pop()
            if stack:
                assert t1 <= stack[-1][1] + 1e-6, \
                    f"tid {tid}: {name} [{t0},{t1}) straddles " \
                    f"{stack[-1][2]} [{stack[-1][0]},{stack[-1][1]})"
            stack.append((t0, t1, name))


def launch_children(events, launch_names=("compact.execute",
                                          "compact.batch_launch")):
    """Each launch span with its child phase spans (same thread, inside
    it, in ``PHASE_SPANS`` order)."""
    xs = [e for e in events if e.get("ph") == "X"]
    out = []
    for L in (e for e in xs if e["name"] in launch_names):
        lo, hi = L["ts"], L["ts"] + L["dur"]
        kids = sorted((e for e in xs if e["name"] in PHASE_SPANS
                       and e["tid"] == L["tid"]
                       and lo - 1e-6 <= e["ts"] <= hi + 1e-6),
                      key=lambda e: e["ts"])
        out.append((L, kids))
    return out


def test_span_nesting_async_torch_engine(tmp_path):
    """An async store on the torch engine: spans nest on every thread,
    and each launch span holds its three measured phases, host clock."""
    tr = Tracer()
    db = LsmDB(str(tmp_path / "db"), obs_cfg(async_compaction=True,
                                             flush_workers=3),
               device="cpu", tracer=tr)
    assert db.engine.tracer is tr
    rng = np.random.default_rng(5)
    for i in range(600):
        db.put(b"key%03d" % rng.integers(0, 120), b"v%06d" % i)
    db.multi_get([b"key%03d" % i for i in range(0, 120, 3)])
    db.wait_idle(timeout=120)
    db.close()
    events = tr.to_chrome()["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"db.put", "flush.build", "flush.install_l0", "memtable.rotate",
            "compact.job", "compact.execute", "compact.read_inputs",
            "compact.install", "db.multi_get"} <= names
    assert set(PHASE_SPANS) <= names
    check_nesting(events)
    launches = launch_children(events)
    assert launches
    for L, kids in launches:
        assert [k["name"] for k in kids] == list(PHASE_SPANS)
        assert all(k["args"] == {"clock": "host"} for k in kids)
        assert sum(k["dur"] for k in kids) <= L["dur"] + 1e-3
        assert L["args"]["jobs"] == 1 and L["args"]["bucket"] >= 1
    counters_seen = {e["name"] for e in events if e["ph"] == "C"}
    assert {"lsm.imm_queue.depth", "lsm.compaction.debt"} <= counters_seen


def test_write_stall_span_and_report(tmp_path):
    """A writer that outruns a slow flush stalls: each stall is a
    ``write_stall`` span with its cause and depth, and the report names
    a background span as its culprit."""
    from repro_torch.obs import report
    tr = Tracer()
    db = LsmDB(str(tmp_path / "db"), obs_cfg(async_compaction=True,
                                             max_pending_memtables=1,
                                             auto_compact=False),
               device="cpu", tracer=tr)
    build = db.engine.build_image

    def slow(*a):
        time.sleep(0.02)
        return build(*a)

    db.engine.build_image = slow
    for i in range(400):
        db.put(b"key%04d" % i, b"v%06d" % i)
    db.wait_idle(timeout=120)
    stalls = db.stats.write_stalls
    db.close()
    assert stalls > 0
    path = str(tmp_path / "trace.json")
    tr.export(path)
    events = report.load_events(path)
    spans = [e for e in events if e["name"] == "write_stall"]
    assert len(spans) == stalls
    assert all(e["args"]["cause"] == "imm_queue_full" and
               e["args"]["depth"] <= 1 for e in spans)
    rows = report.stall_breakdown(events)
    assert sum(r["count"] for r in rows) == stalls
    assert any(r["culprit"].startswith("flush.") for r in rows)


@contextlib.contextmanager
def one_round_per_notify():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def test_sharded_trace_has_stacked_launch(tmp_path):
    """One registry and one tracer for 2 shards and the queue: the
    per-shard counters stay apart, their merged put histograms equal the
    sum, and a stacked round is one ``compact.batch_launch`` with
    ``jobs >= 2`` under a ``compact.round``, its phases inside it."""
    tr, reg = Tracer(), MetricsRegistry()
    cfg = obs_cfg(metrics=reg, tracer=tr, auto_compact=False)
    db = ShardedDB(str(tmp_path / "sh"), cfg, boundaries=[b"m"],
                   device="cpu")
    assert db.engine.tracer is tr and db.queue.tracer is tr
    for i in range(900):
        prefix = b"a" if i % 2 else b"q"
        db.put(prefix + b"k%04d" % (i % 300), b"v%06d" % i)
    db.flush()
    with one_round_per_notify():
        db.maybe_compact()
    db.wait_idle(timeout=120)
    per_shard = [reg.find("lsm.puts", shard=str(i)).value for i in range(2)]
    assert per_shard == [450, 450] and db.stats.puts == 900
    assert [s.stats.puts for s in db.shards] == per_shard
    puts = [h for h in reg.find("lsm.op.latency_us")
            if h.labels.get("op") == "put"]
    assert len(puts) == 2
    merged = merge_histograms(puts)
    assert merged.count == 900 == sum(h.count for h in puts)
    assert reg.find("compact.queue.depth") is not None
    events = tr.to_chrome()["traceEvents"]
    check_nesting(events)
    xs = [e for e in events if e["ph"] == "X"]
    assert any(e["name"] == "compact.round" and e["args"]["jobs"] >= 2
               for e in xs)
    many = [e for e in xs if e["name"] == "compact_many"]
    assert many and all(e["args"]["jobs"] >= 1 for e in many)
    assert db.engine.batch_launches >= 1
    stacked = [(L, kids) for L, kids in launch_children(events)
               if L["name"] == "compact.batch_launch"]
    assert any(L["args"]["jobs"] >= 2 for L, _ in stacked)
    for L, kids in stacked:
        assert [k["name"] for k in kids] == list(PHASE_SPANS)
        assert sum(k["dur"] for k in kids) <= L["dur"] + 1e-3
    assert {e["args"]["shard"] for e in xs if e["name"] == "compact.install"
            } == {"0", "1"}
    assert db.stats.batched_compactions >= 2
    db.close()


def test_put_overhead_vs_null_registry(tmp_path):
    """The instrumented put path stays within 5 % of the no-op registry's
    (a big memtable: no flush; best of 5 trials), JAX's check."""
    def put_seconds(path, reg, n=4000):
        db = LsmDB(path, obs_cfg("cpu", memtable_bytes=1 << 30),
                   device="cpu", metrics=reg)
        ks = [b"k%07d" % i for i in range(n)]
        t0 = time.perf_counter()
        for k in ks:
            db.put(k, b"v")
        dt = time.perf_counter() - t0
        db.close()
        return dt

    best = float("inf")
    for trial in range(5):
        t_null = put_seconds(str(tmp_path / f"n{trial}"), NULL_REGISTRY)
        t_real = put_seconds(str(tmp_path / f"r{trial}"), MetricsRegistry())
        best = min(best, t_real / t_null)
        if best <= 1.05:
            break
    assert best <= 1.05, f"instrumentation overhead {100 * (best - 1):.1f}%"


def test_cpu_engine_phase_spans_equal_jax(tmp_path):
    """The numpy baseline records JAX's CPU engine's three host spans,
    with the same args, around the same phases."""
    db = LsmDB(str(tmp_path / "db"), obs_cfg("cpu"), device="cpu")
    for i in range(300):
        db.put(b"key%04d" % (i % 90), b"v%06d" % i)
    db.flush()
    paths = [fm.path for _, fm in db.versions.current.all_files()][:3]
    db.close()
    seen = []
    for engine, tracer in ((tce.CpuCompactionEngine, Tracer()),
                           (jce.CpuCompactionEngine, JTracer())):
        geom = (SSTGeometry if engine is tce.CpuCompactionEngine
                else JGeometry)(**KW)
        engine(geom, tracer=tracer).compact_paths(paths)
        seen.append([(e["name"], e.get("args"))
                     for e in tracer.to_chrome()["traceEvents"]
                     if e["ph"] == "X"])
    assert seen[0] == seen[1]
    assert [n for n, _ in seen[0]] == ["compact.crc_verify",
                                       "compact.merge_phase2",
                                       "compact.format"]


def test_device_timer_phases_on_the_cpu():
    """``phases`` reads the host bounds of two spans on the CPU: the
    three parts sum to the outer span, and no device time is recorded."""
    timer = DeviceTimer(__import__("torch").device("cpu"))
    assert timer.clock == "host" and timer.phases("pipeline", "sort") is None
    with timer.span("pipeline"):
        time.sleep(0.002)
        with timer.span("sort"):
            time.sleep(0.003)
        time.sleep(0.001)
    before, inner, after = timer.phases("pipeline", "sort")
    assert before >= 0.002 and inner >= 0.003 and after >= 0.001
    o0, o1 = timer._host["pipeline"][-1]
    assert before + inner + after == pytest.approx((o1 - o0) / 1e9)
    assert timer.seconds("pipeline") == 0.0 == timer.seconds("sort")


def test_block_cache_hooks_and_a20_names_equal_jax(tmp_path):
    """``BlockCache(on_hit=, on_miss=)`` counts as JAX's does;
    ``DecodedBlock.nbytes`` and ``TableReader.n_blocks`` equal JAX's on the
    same SST; ``cpu_engine.np_bloom_query`` is exported and equals
    JAX's."""
    db = LsmDB(str(tmp_path / "db"), obs_cfg("cpu"), device="cpu")
    for i in range(200):
        db.put(b"key%04d" % i, b"v%06d" % i)
    db.flush()
    fm = next(fm for _, fm in db.versions.current.all_files())
    db.close()
    jfm = jsst.FileMeta(**{f.name: getattr(fm, f.name)
                           for f in dataclasses.fields(jsst.FileMeta)})
    hits = {"t": [0, 0], "j": [0, 0]}
    tcache = sstable.BlockCache(
        8, on_hit=lambda: hits["t"].__setitem__(0, hits["t"][0] + 1),
        on_miss=lambda: hits["t"].__setitem__(1, hits["t"][1] + 1))
    jcache = jsst.BlockCache(
        8, on_hit=lambda: hits["j"].__setitem__(0, hits["j"][0] + 1),
        on_miss=lambda: hits["j"].__setitem__(1, hits["j"][1] + 1))
    trd = sstable.TableReader(fm, SSTGeometry(**KW), block_cache=tcache,
                              device="cpu")
    jrd = jsst.TableReader(jfm, JGeometry(**KW), block_cache=jcache)
    assert trd.n_blocks == jrd.n_blocks > 1
    for b in range(trd.n_blocks):
        tb, jb = trd.block(b), jrd.block(b)
        assert tb.nbytes == jb.nbytes > 0
    opts = ReadOptions(backend="host")
    for i in range(0, 240, 7):
        k = b"key%04d" % i
        assert trd.get(k, opts) == jrd.get(k)
    assert hits["t"] == hits["j"] and min(hits["t"]) > 0
    rng = np.random.default_rng(9)
    filters = rng.integers(0, 2 ** 32, (6, 16), dtype=np.uint32)
    keys = rng.integers(0, 2 ** 32, (6, 3, 4), dtype=np.uint32)
    np.testing.assert_array_equal(tce.np_bloom_query(filters, keys, 6),
                                  jce.np_bloom_query(filters, keys, 6))


def test_ycsb_launcher_exports_and_checks_p99(tmp_path, capsys):
    """``launch.ycsb --trace-out --metrics-out --prom-out`` writes the
    trace, the JSON snapshot and the Prometheus text of one run, and its
    histogram-p99 cross-check agrees with the JAX bench's on the same
    samples (a decade off fails both)."""
    import json
    import os

    from repro.obs import MetricsRegistry as JRegistry
    from repro_torch.launch import ycsb
    from repro_torch.obs import report, validate_prometheus_text
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)   # the top-level benchmarks/ package
    from benchmarks.ycsb_bench import check_histogram_p99 as jax_check
    out = {k: str(tmp_path / k) for k in ("trace.json", "m.json", "p.prom")}
    rc = ycsb.main(["--records", "2000", "--operations", "1000",
                    "--value-size", "64", "--device", "cpu",
                    "--trace-out", out["trace.json"],
                    "--metrics-out", out["m.json"],
                    "--prom-out", out["p.prom"]])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and "within 2**0.5: True" in lines[-2]
    r = json.loads(lines[-1])
    puts = r["db_stats"]["puts"]
    with open(out["m.json"]) as f:
        snap = json.load(f)
    counters = {c["name"]: c["value"] for c in snap["counters"]}
    assert counters["lsm.puts"] == puts >= 2000
    hists = {(h["name"], h["labels"].get("op")): h["count"]
             for h in snap["histograms"]}
    assert hists[("ycsb.op.latency_us", "put")] == puts == \
        hists[("lsm.op.latency_us", "put")]
    assert hists[("ycsb.op.latency_us", "get")] == r["reads_checked"]
    with open(out["p.prom"]) as f:
        assert validate_prometheus_text(f.read()) > 0
    spans = {row["name"]: row["count"]
             for row in report.report(out["trace.json"])["spans"]}
    assert spans["db.put"] == puts and spans["compact.execute"] >= 1
    rng = np.random.default_rng(8)
    values = [float(v) for v in np.exp(rng.normal(3, 1, 2000))]
    exact = float(np.percentile(values, 99.0))
    regs = (MetricsRegistry(), JRegistry())
    for reg in regs:
        h = reg.histogram("ycsb.op.latency_us", op="put")
        for v in values:
            h.record(v)
    for scale in (1.0, 10.0):
        assert ycsb.check_histogram_p99(regs[0], exact * scale, "put") == \
            jax_check(regs[1], exact * scale, "put")
        assert ycsb.check_histogram_p99(regs[0], exact * scale, None) == \
            jax_check(regs[1], exact * scale, None)
    assert ycsb.check_histogram_p99(regs[0], exact, "put")[2]
    assert not ycsb.check_histogram_p99(regs[0], 10 * exact, "put")[2]


def test_ycsb_async_exports_keep_each_run_apart(tmp_path, capsys):
    """``launch.ycsb --async --metrics-out``: the sync and the async run
    share one registry, each run's series labelled ``mode``, so each
    row's ``DBStats`` is its own store's: its puts equal the puts the
    launcher timed in that run, not both runs' sum, and its flushes the
    run's own ``lsm.flushes`` counter.  Each run's put p99 is
    cross-checked."""
    import json

    from repro_torch.launch import ycsb
    out = str(tmp_path / "m.json")
    rc = ycsb.main(["--records", "1200", "--operations", "600",
                    "--value-size", "64", "--device", "cpu", "--async",
                    "--metrics-out", out])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert sum("within 2**0.5: True" in line for line in lines) == 2
    r = json.loads(lines[-1])
    with open(out) as f:
        snap = json.load(f)
    counters = {(c["name"], c["labels"].get("mode")): c["value"]
                for c in snap["counters"]}
    hists = {(h["name"], h["labels"].get("op"), h["labels"].get("mode")):
             h["count"] for h in snap["histograms"]}
    for mode in ("sync", "async"):
        st = r[mode]["db_stats"]
        timed = hists[("ycsb.op.latency_us", "put", mode)]
        assert st["puts"] == timed == counters[("lsm.puts", mode)] >= 1200
        assert hists[("lsm.op.latency_us", "put", mode)] == timed
        assert r[mode]["flushes"] == st["flushes"] == \
            counters[("lsm.flushes", mode)] >= 1
    assert r["sync"]["db_stats"]["puts"] == r["async"]["db_stats"]["puts"]
