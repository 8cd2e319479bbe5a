"""``repro_torch.obs`` (ROADMAP A10) against the JAX package's ``repro.obs``
on the same seeded inputs: histogram buckets, percentiles and merges,
the Prometheus text, the Perfetto layout (the golden trace), the bounded
ring buffer and the report's aggregates.  Neither side touches JAX
arrays, so this file compiles nothing."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.obs import metrics as jmetrics
from repro.obs import report as jreport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import report as treport

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "trace_perfetto.json")


def seeded_values(seed: int, n: int = 200) -> list[float]:
    rng = np.random.default_rng(seed)
    return [float(v) for v in np.exp(rng.uniform(-8, 12, n))] + \
        [1.0, 2.0, 1e-9, 1e9, 0.0, -3.0, 2.0 ** 0.25, 2.0 ** -0.75]


def test_public_names_are_jax_s():
    assert tobs.__all__ == jobs.__all__
    for name in tobs.__all__:
        assert hasattr(tobs, name)
    assert tmetrics.ZERO_BUCKET == jmetrics.ZERO_BUCKET


def test_no_jax_and_no_repro_imported():
    code = ("import sys; import repro_torch.obs, repro_torch.obs.report; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_index_equals_jax(seed):
    for v in seeded_values(seed):
        i = tmetrics.bucket_index(v)
        assert i == jmetrics.bucket_index(v)
        assert tmetrics.bucket_hi(i) == jmetrics.bucket_hi(i)
        assert tmetrics.bucket_mid(i) == jmetrics.bucket_mid(i)
        if v > 0:
            assert 2.0 ** (i / 4.0) <= v < tmetrics.bucket_hi(i) or \
                v == pytest.approx(2.0 ** (i / 4.0))


def fill_pair(values, *, pend: bool):
    """One port and one JAX histogram fed the same values."""
    t = tobs.MetricsRegistry().histogram("t.lat")
    j = jobs.MetricsRegistry().histogram("t.lat")
    for v in values:
        if pend:
            t.pend(v)
            j.pend(v)
        else:
            t.record(v)
            j.record(v)
    return t, j


@pytest.mark.parametrize("pend", [False, True])
def test_percentiles_equal_jax(pend):
    rng = np.random.default_rng(1)
    values = [float(v) for v in np.exp(rng.normal(3.0, 1.5, 5000))]
    t, j = fill_pair(values, pend=pend)
    assert t.snapshot() == j.snapshot()
    qs = (1.0, 50.0, 90.0, 99.0, 99.9, 100.0)
    assert t.percentiles(qs) == j.percentiles(qs)
    assert (t.count, t.sum) == (j.count, j.sum)
    exact = float(np.percentile(values, 99.0))
    assert exact / 2 ** 0.5 <= t.percentile(99.0) <= exact * 2 ** 0.5
    empty = tobs.MetricsRegistry().histogram("e")
    assert empty.percentile(99.0) == 0.0 == \
        jobs.MetricsRegistry().histogram("e").percentile(99.0)


def test_merge_histograms_equal_jax():
    rng = np.random.default_rng(2)
    parts = [[float(v) for v in np.exp(rng.normal(m, s, n))]
             for m, s, n in ((2, 1, 700), (5, 2, 300), (0, 3, 50))]
    tm = tobs.merge_histograms([fill_pair(p, pend=i % 2 == 1)[0]
                                for i, p in enumerate(parts)])
    jm = jobs.merge_histograms([fill_pair(p, pend=i % 2 == 1)[1]
                                for i, p in enumerate(parts)])
    assert tm.snapshot() == jm.snapshot()
    assert tm.percentiles() == jm.percentiles()
    combined, _ = fill_pair([v for p in parts for v in p], pend=False)
    assert tm.snapshot() == combined.snapshot()


def fill_registry(pkg, seed: int):
    """The same counters, gauges and histograms in a registry of
    ``pkg`` (``repro.obs`` or ``repro_torch.obs``)."""
    rng = np.random.default_rng(seed)
    reg = pkg.MetricsRegistry()
    reg.counter("lsm.puts", shard="0", help="total puts").inc(42)
    reg.counter("lsm.puts", shard="1").inc(7)
    reg.counter("lsm.compact_host_seconds").add(0.125)
    reg.gauge("lsm.compaction.debt").set(1.5)
    reg.gauge("compact.queue.depth", help="shards with pending work").set(3)
    for op in ("put", "get"):
        h = reg.histogram("lsm.op.latency_us", op=op,
                          help="op latency (us)")
        for v in np.exp(rng.normal(3, 1.2, 400)):
            h.pend(float(v))
    return reg


@pytest.mark.parametrize("seed", [3, 4])
def test_prometheus_text_equals_jax(seed):
    t = tobs.prometheus_text(fill_registry(tobs, seed))
    j = jobs.prometheus_text(fill_registry(jobs, seed))
    assert t == j
    assert tobs.validate_prometheus_text(t) == \
        jobs.validate_prometheus_text(j) > 0
    assert "# HELP lsm_puts_total total puts" in t
    with pytest.raises(ValueError):
        tobs.validate_prometheus_text(t + "bad line !!\n")
    broken = t.replace('lsm_op_latency_us_count{op="get"} 400',
                       'lsm_op_latency_us_count{op="get"} 399')
    assert broken != t
    with pytest.raises(ValueError):
        tobs.validate_prometheus_text(broken)


def test_metrics_json_equals_jax(tmp_path):
    t = fill_registry(tobs, 5)
    j = fill_registry(jobs, 5)
    assert tobs.metrics_json(t) == jobs.metrics_json(j)
    tobs.write_metrics(t, str(tmp_path / "t.json"))
    jobs.write_metrics(j, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    tobs.write_prometheus(t, str(tmp_path / "t.prom"))
    assert (tmp_path / "t.prom").read_text() == jobs.prometheus_text(j)


def test_registry_get_or_create_and_null():
    reg = tobs.MetricsRegistry()
    a = reg.counter("x", shard="0")
    assert reg.counter("x", shard="0") is a
    assert reg.counter("x", shard="1") is not a
    with pytest.raises(ValueError):
        reg.gauge("x", shard="0")
    assert reg.find("x", shard="0") is a and reg.find("x", shard="9") is None
    assert len(reg.find("x")) == 2
    c = reg.counter("t.puts", help="total puts")
    assert c.labels == {} and c.help == "total puts"
    null = tobs.NULL_REGISTRY
    for make in (null.counter, null.gauge, null.histogram):
        m = make("anything", op="put")
        m.inc()
        m.pend(3.0)
        assert m.value == 0 and m.percentile(99.0) == 0.0
    assert null.snapshot() == jobs.NULL_REGISTRY.snapshot()
    assert null.find("x") == [] and null.find("x", a="b") is None


def test_counter_increments_are_atomic():
    c = tobs.MetricsRegistry().counter("t.n")
    h = tobs.MetricsRegistry().histogram("t.h")

    def work():
        for _ in range(20_000):
            c.inc()
            h.pend(1.0)

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value == 8 * 20_000 and h.count == 8 * 20_000


def golden_tracer(pkg):
    """The JAX test's deterministic trace: a fake clock, explicit tids."""
    clock = iter(range(0, 100_000, 500)).__next__
    tr = pkg.Tracer(clock=clock)
    with tr.span("db.put", labels="shard=0"):
        with tr.span("memtable.rotate"):
            pass
    tr.complete("compact.execute", 5_000, 4_000,
                args={"jobs": 2, "bucket": 8}, tid=101)
    tr.complete("compact.merge_phase2", 5_000, 2_000,
                args={"modeled": True}, tid=101)
    tr.counter("lsm.imm_queue.depth[shard=0]", 1)
    tr.instant("bg_error", {"what": "none"})
    return tr


def test_perfetto_golden_roundtrip(tmp_path):
    tr = golden_tracer(tobs)
    doc = tr.to_chrome()
    with open(GOLDEN) as f:
        want = json.load(f)
    got_meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    want_meta = [e for e in want["traceEvents"] if e["ph"] == "M"]
    assert [m.get("tid") for m in got_meta] == \
        [m.get("tid") for m in want_meta]
    assert [e for e in doc["traceEvents"] if e["ph"] != "M"] == \
        [e for e in want["traceEvents"] if e["ph"] != "M"]
    path = str(tmp_path / "t.json")
    tr.export(path)
    with open(path) as f:
        assert json.load(f) == doc
    strip = [e for e in golden_tracer(jobs).to_chrome()["traceEvents"]
             if e["ph"] != "M"]
    assert strip == [e for e in doc["traceEvents"] if e["ph"] != "M"]


def test_tracer_ring_buffer_bounded():
    tr = tobs.Tracer(maxlen=10, clock=iter(range(10 ** 6)).__next__)
    for i in range(100):
        tr.complete(f"s{i}", i, 1)
    assert len(tr) == 10
    names = [e["name"] for e in tr.to_chrome()["traceEvents"]
             if e["ph"] == "X"]
    assert names == [f"s{i}" for i in range(90, 100)]
    tr.clear()
    assert len(tr) == 0 and tr.to_chrome()["traceEvents"] == []
    null = tobs.NULL_TRACER
    assert not null.enabled and len(null) == 0
    with null.span("x", a=1):
        null.complete("y", 0, 1)
        null.counter("z", 1)
    assert null.to_chrome() == {"traceEvents": [], "displayTimeUnit": "ms"}


def stall_events(pkg, seed: int):
    """Seeded background spans, write stalls and counter samples."""
    rng = np.random.default_rng(seed)
    tr = pkg.Tracer(clock=iter(range(0, 10 ** 9, 100)).__next__)
    t = 0
    for i in range(40):
        t += int(rng.integers(1_000, 20_000))
        name = ["compact.job", "flush.build", "compact.execute",
                "memtable.rotate", "db.put"][i % 5]
        tr.complete(name, t, int(rng.integers(500, 30_000)),
                    tid=int(rng.integers(1, 4)))
        if i % 3 == 0:
            tr.complete("write_stall", t + int(rng.integers(0, 5_000)),
                        int(rng.integers(100, 10_000)),
                        args={"cause": "imm_queue_full", "depth": 4},
                        tid=9)
        tr.counter("lsm.imm_queue.depth", int(rng.integers(0, 5)))
    tr.complete("write_stall", t + 10 ** 7, 1_000,
                args={"cause": "imm_queue_full"}, tid=9)
    return tr.to_chrome()["traceEvents"]


@pytest.mark.parametrize("seed", [6, 7])
def test_report_equals_jax(seed):
    te, je = stall_events(tobs, seed), stall_events(jobs, seed)
    assert te == je
    events = [e for e in te if e.get("ph") in ("X", "C", "i")]
    assert treport.aggregate(events) == jreport.aggregate(events)
    rows = treport.stall_breakdown(events)
    assert rows == jreport.stall_breakdown(events)
    assert any(r["culprit"] == "none-active" for r in rows)
    assert all(r["culprit"] != "db.put" for r in rows)
    assert treport.counter_summary(events) == \
        jreport.counter_summary(events)


def test_report_cli_on_an_exported_trace(tmp_path):
    tr = tobs.Tracer(clock=iter(range(0, 10 ** 7, 100)).__next__)
    tr.complete("compact.job", 1_000, 8_000, tid=7)
    tr.complete("write_stall", 2_000, 3_000,
                args={"cause": "imm_queue_full"}, tid=1)
    path = str(tmp_path / "trace.json")
    tr.export(path)
    assert treport.report(path) == jreport.report(path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", path,
                        "--json"], env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout)
    assert rep["stalls"][0]["culprit"] == "compact.job"
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", path,
                        "--top", "1"], env=env, capture_output=True,
                       text=True)
    assert r.returncode == 0 and "stall attribution (1 stalls" in r.stdout
