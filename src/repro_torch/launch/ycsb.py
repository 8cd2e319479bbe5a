"""The paper's evaluation: YCSB on the store, with the LUDA engine on the
card or the CPU compaction baseline (the JAX package's
``examples/ycsb_demo.py``, as a launcher).

    PYTHONPATH=src python -m repro_torch.launch.ycsb [--engine device|cpu]
        [--threads 1] [--value-size 256] [--records N] [--operations N]
        [--workload A] [--paper] [--async] [--device cpu]
        [--trace-out PATH] [--metrics-out PATH] [--prom-out PATH]

``--paper`` runs at the paper's geometry and scheduler
(``configs.luda_paper.PAPER``: 4 KB blocks, 4 MB SSTs and memtables);
without it, at ``bench_geometry`` (64 KB SSTs and memtables), whose
compaction jobs stay proportional to a scaled-down record count.  With no
``--device`` it runs on ``cuda`` and fails where CUDA is absent.  A
store on the CPU engine keeps its device for the batched read path
(``multi_get``, which YCSB does not call); ``--device cpu`` keeps a
baseline run off the card entirely.

``--async`` runs the same op streams twice, on a synchronous store and on
an async one (``DBConfig.async_compaction``: two flush workers and a
compaction worker; the JAX package's ``benchmarks/ycsb_bench.py
--async``), and
prints a row a mode -- put p50 / p99 / p99.9, ops/s, flushes,
compactions, write stalls; each run also reads back every acknowledged
key by ``get`` after the drain.

``--trace-out`` writes the run's Chrome/Perfetto trace (the store's and
its engine's spans; ``python -m repro_torch.obs.report`` reads it),
``--metrics-out`` the registry's JSON snapshot and ``--prom-out`` its
Prometheus text, as the JAX package's ``benchmarks/ycsb_bench.py`` takes
them.  The registry then also holds the launcher's own measured latencies
as ``ycsb.op.latency_us{op=put|get}``, and each run's put histogram's
p99 is checked against the exact p99 of the same puts (within 2**0.5:
half a bucket of quantization and one of rank); the exit code is 1 when
it disagrees.  With ``--async`` both runs share the registry and the
trace, and every series of a run carries its label ``mode=sync`` or
``mode=async``, so neither run's counters hold the other's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
import time

import numpy as np

from repro_torch.configs.luda_paper import BENCH_SCALE, PAPER, bench_geometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.ycsb import WorkloadSpec, YCSBWorkload
from repro_torch.device import resolve_device
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.obs import (MetricsRegistry, Tracer, merge_histograms,
                             write_metrics, write_prometheus)


# an async store's flush workers, as the JAX bench's ``measure_latency``
# runs them
FLUSH_WORKERS = 2


def store_config(value_size: int, *, engine: str = "device",
                 threads: int = 1, paper: bool = False,
                 async_mode: bool = False) -> DBConfig:
    """The store for ``value_size``-byte values: the paper's geometry and
    scheduler, or the scaled bench geometry (as the JAX demo's).
    ``async_mode``: background flushes (``FLUSH_WORKERS`` of them) and
    compaction."""
    mode = dict(async_compaction=async_mode, flush_workers=FLUSH_WORKERS)
    if paper:
        return DBConfig(geom=PAPER.geometry(value_size),
                        scheduler=PAPER.scheduler(), engine=engine,
                        threads=threads, **mode)
    return DBConfig(geom=bench_geometry(value_size), engine=engine,
                    threads=threads, memtable_bytes=64 * 1024,
                    scheduler=SchedulerConfig(l0_trigger=4,
                                              base_bytes=512 * 1024),
                    **mode)


def percentiles_us(lat_ns: list[int]) -> list[float] | None:
    """p50, p99 and p99.9 of host-clock latencies, in microseconds."""
    if not lat_ns:
        return None
    return [float(np.percentile(lat_ns, q)) / 1e3 for q in (50, 99, 99.9)]


def run(spec: WorkloadSpec, cfg: DBConfig, *, device=None,
        path: str | None = None, check_gets: bool = False, metrics=None,
        tracer=None, metric_labels: dict | None = None) -> dict:
    """Load ``spec.records`` through ``put``, then run ``spec.operations``
    of the YCSB mix, on a new store at ``path`` (default: a temporary
    directory, removed after).  The op streams are built before the clock
    starts.  Every read is checked against a dict of the acknowledged
    writes; after the run (and, on an async store, ``wait_idle()``, the
    drain) a full ``scan`` must equal it, and with ``check_gets`` so must
    a ``get`` of every acknowledged key; a disagreement raises
    ``AssertionError``.

    Returns the mode (sync or async); load and run wall seconds and
    ops/s; the drain's seconds; read, update and insert latencies, and
    those of every put of the load and the run (p50, p99, p99.9 in us,
    host clock; None for a kind the mix lacks), and the longest put;
    write stalls; the store's ``DBStats`` as a dict (``db_stats``); with
    ``check_gets``, the keys read back by ``get``
    after the drain (else 0); flushes, compactions
    (and the L0->L1 jobs among them, with the fewest input files of one)
    and compaction bytes; each job's
    ``(level, input files, bytes in, host s, device s)``; the wall seconds
    around the engine's compaction calls; and, for the device engine on
    the card, ``compact_span_s``, the sum of the jobs' CUDA-event spans,
    and, on a sync store, the same sum as ``compact_device_s`` (None
    otherwise): on an async store the events also bracket the readers'
    and flushes' work queued on the card between them, and the worker's
    waits for the interpreter, so the span is not the jobs' device time.

    ``metrics`` / ``tracer`` / ``metric_labels`` go to the store
    (``LsmDB(metrics=, tracer=, metric_labels=)``); with ``metrics`` the
    run also records each put's and read's measured latency in
    ``ycsb.op.latency_us{op=put|get}``, under ``metric_labels`` too."""
    dev = resolve_device(device)
    wl = YCSBWorkload(spec)
    load_ops = list(wl.load_ops())
    run_ops = list(wl.run_ops())
    tmp = path is None
    if tmp:
        path = tempfile.mkdtemp(prefix=f"ycsb-{cfg.engine}-")
    model: dict[bytes, bytes] = {}
    lat: dict[str, list[int]] = {"read": [], "update": [], "insert": [],
                                 "put": []}
    clock = time.perf_counter_ns
    pend_put = pend_get = lambda us: None
    labels = dict(metric_labels or {})
    if metrics is not None:
        pend_put = metrics.histogram(
            "ycsb.op.latency_us", op="put",
            help="launcher-measured op latency (us)", **labels).pend
        pend_get = metrics.histogram("ycsb.op.latency_us", op="get",
                                     **labels).pend
    db = LsmDB(path, cfg, device=dev, metrics=metrics, tracer=tracer,
               metric_labels=labels)
    try:
        t0 = time.perf_counter()
        for _, key, val in load_ops:
            c0 = clock()
            db.put(key, val)
            dt = clock() - c0
            lat["put"].append(dt)
            pend_put(dt / 1e3)
            model[key] = val
        load_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for op, key, val in run_ops:
            c0 = clock()
            if op == "read":
                got = db.get(key)
                dt = clock() - c0
                lat["read"].append(dt)
                pend_get(dt / 1e3)
                if got != model.get(key):
                    raise AssertionError(f"read of {key!r} disagrees with "
                                         "the acknowledged writes")
            else:
                db.put(key, val)
                dt = clock() - c0
                lat[op].append(dt)
                lat["put"].append(dt)
                pend_put(dt / 1e3)
                model[key] = val
        run_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        db.wait_idle()   # the background flushes and compactions
        drain_s = time.perf_counter() - t0
        rows = db.scan(b"", b"\xff" * (cfg.geom.key_bytes + 1))
        if rows != sorted(model.items()):
            raise AssertionError("a full scan disagrees with the "
                                 "acknowledged writes")
        for key in sorted(model) if check_gets else ():
            if db.get(key) != model[key]:
                raise AssertionError(f"get of {key!r} after the drain "
                                     "disagrees with the acknowledged "
                                     "writes")
        st = db.stats
        levels = db.level_sizes()
        jobs = [(r.level, r.inputs, r.stats.bytes_in, r.stats.host_seconds,
                 r.stats.device_seconds) for r in db.compactions]
    finally:
        db.close()
        if tmp:
            shutil.rmtree(path, ignore_errors=True)
    on_card = cfg.engine == "device" and dev.type == "cuda"
    return dict(
        engine=cfg.engine, threads=cfg.threads, device=str(dev),
        mode="async" if cfg.async_compaction else "sync",
        workload=spec.name, distribution=spec.distribution,
        value_size=spec.value_size, records=spec.records,
        operations=spec.operations,
        load_s=load_s, load_ops_s=spec.records / load_s,
        run_s=run_s, run_ops_s=spec.operations / run_s, drain_s=drain_s,
        latency_us={op: percentiles_us(v) for op, v in lat.items()},
        reads_checked=len(lat["read"]), scan_rows=len(rows),
        put_max_us=max(lat["put"], default=0) / 1e3,
        gets_after_drain=len(model) if check_gets else 0,
        write_stalls=st.write_stalls,
        flushes=st.flushes, compactions=st.compactions,
        trivial_moves=st.trivial_moves, levels=levels,
        l0_jobs=sum(j[0] == 0 for j in jobs),
        l0_min_inputs=min((j[1] for j in jobs if j[0] == 0), default=0),
        jobs=jobs,
        db_stats=dataclasses.asdict(st),
        compact_bytes_in=st.compact_bytes_in,
        compact_bytes_out=st.compact_bytes_out,
        compact_wall_s=st.compact_wall_seconds,
        compact_span_s=st.compact_device_seconds if on_card else None,
        compact_device_s=(st.compact_device_seconds
                          if on_card and not cfg.async_compaction
                          else None))


def mode_line(r: dict) -> str:
    """One row of the sync / async comparison: put p50 / p99 / p99.9 (us,
    host clock), ops/s of the load and the run, flushes, compactions and
    write stalls."""
    p50, p99, p999 = r["latency_us"]["put"]
    return (f"[{r['engine']} {r['mode']:<5}] put p50 {p50:.1f} us, p99 "
            f"{p99:.1f} us, p99.9 {p999:.1f} us, max {r['put_max_us']:.1f} "
            f"us | load "
            f"{r['load_ops_s']:,.0f} ops/s, run {r['run_ops_s']:,.0f} "
            f"ops/s | {r['flushes']} flushes, {r['compactions']} "
            f"compactions, {r['write_stalls']} write stalls, drain "
            f"{r['drain_s']:.2f} s")


def check_histogram_p99(metrics, exact_p99_us: float, op: str | None,
                        **labels) -> tuple[float, float, bool]:
    """The registry's ``ycsb.op.latency_us`` p99 estimate (``op=None``:
    every op's series merged; ``labels``: the series of one run) against
    the exact p99 of the same samples: ``(estimate, exact, ok)``.  A bucket is 2**0.25 wide and the estimate
    its geometric midpoint, so a right estimate lies within half a bucket
    of quantization and one bucket of rank error: a factor of 2**0.5 (the
    JAX bench's ``check_histogram_p99``)."""
    if op is None:
        h = merge_histograms([
            m for m in metrics.find("ycsb.op.latency_us")
            if all(m.labels.get(k) == v for k, v in labels.items())])
    else:
        h = metrics.find("ycsb.op.latency_us", op=op, **labels)
    if h is None or h.snapshot()[1] == 0:
        return 0.0, exact_p99_us, False
    est = h.percentile(99.0)
    tol = 2.0 ** 0.5
    ok = (exact_p99_us / tol <= est <= exact_p99_us * tol
          if exact_p99_us > 0 else True)
    return est, exact_p99_us, ok


def export_obs(args, metrics, tracer, results: list[dict]) -> bool:
    """Write the artifacts ``args`` asks for; cross-check each run's put
    histogram p99 against the exact p99 of its puts (a run of
    ``results``, its series labelled by its ``labels``).  Returns whether
    every one agreed."""
    if args.trace_out:
        tracer.export(args.trace_out)
        print(f"trace written to {args.trace_out} ({len(tracer)} events)")
    if args.metrics_out:
        write_metrics(metrics, args.metrics_out)
        print(f"metrics JSON written to {args.metrics_out}")
    if args.prom_out:
        write_prometheus(metrics, args.prom_out)
        print(f"Prometheus text written to {args.prom_out}")
    agreed = True
    for r in results:
        est, exact, ok = check_histogram_p99(
            metrics, r["latency_us"]["put"][1], "put", **r["labels"])
        print(f"histogram p99 cross-check (put{r['labels'] or ''}): "
              f"estimate {est:.1f} us vs exact {exact:.1f} us, within "
              f"2**0.5: {ok}")
        agreed &= ok
    return agreed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("device", "cpu"), default="device")
    ap.add_argument("--threads", type=int, default=1,
                    help="modelled CPU compaction threads (cpu engine)")
    ap.add_argument("--value-size", type=int, default=256)
    ap.add_argument("--records", type=int, default=BENCH_SCALE.records)
    ap.add_argument("--operations", type=int, default=None,
                    help="default: as many as --records")
    ap.add_argument("--workload", default="A", help="YCSB A, B, C or D")
    ap.add_argument("--paper", action="store_true",
                    help="the paper's geometry and scheduler")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="run the same op streams on a sync and an async "
                         "store and compare them")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "run (chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry snapshot as JSON")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write the metrics registry in Prometheus text "
                         "exposition format")
    args = ap.parse_args(argv)
    obs = bool(args.trace_out or args.metrics_out or args.prom_out)
    metrics, tracer = (MetricsRegistry(), Tracer()) if obs else (None, None)

    spec = WorkloadSpec.named(
        args.workload, records=args.records,
        operations=args.operations or args.records,
        value_size=args.value_size, seed=args.seed)
    modes = (False, True) if args.async_mode else (False,)
    results = []
    for async_mode in modes:
        cfg = store_config(args.value_size, engine=args.engine,
                           threads=args.threads, paper=args.paper,
                           async_mode=async_mode)
        # two runs share the registry: each labels its own series
        labels = ({"mode": "async" if async_mode else "sync"}
                  if args.async_mode else {})
        results.append(run(spec, cfg, device=args.device,
                           check_gets=args.async_mode, metrics=metrics,
                           tracer=tracer, metric_labels=labels))
        results[-1]["labels"] = labels
    if not args.async_mode:
        r = results[0]
        print(f"[{r['engine']} on {r['device']}] load {r['records']} ops in "
              f"{r['load_s']:.2f} s ({r['load_ops_s']:,.0f} ops/s) | run "
              f"{r['operations']} ops in {r['run_s']:.2f} s "
              f"({r['run_ops_s']:,.0f} ops/s), host clock")
        print(f"[{r['engine']}] {r['flushes']} flushes, {r['compactions']} "
              f"compactions, {r['compact_bytes_in']:,} B in, compaction "
              f"wall {r['compact_wall_s']:.3f} s, device "
              + ("not measured" if r["compact_device_s"] is None
                 else f"{r['compact_device_s']:.4f} s (CUDA events)"))
        ok = not obs or export_obs(args, metrics, tracer, results)
        print(json.dumps(r))
        return 0 if ok else 1
    sync, asyn = results
    for r in results:
        print(mode_line(r))
    print(f"async / sync p99 put "
          f"{asyn['latency_us']['put'][1] / sync['latency_us']['put'][1]:.3f}"
          f"; both runs read back every acknowledged write "
          f"({sync['gets_after_drain']} keys by get after the drain)")
    ok = True
    if obs:
        print("the exports hold both modes, one registry and one trace, "
              "each run's series labelled mode=sync or mode=async")
        ok = export_obs(args, metrics, tracer, results)
    print(json.dumps({"sync": sync, "async": asyn}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
