#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port of the LUDA store on one GPU.

    python3 chip_smoke.py        (from the repository root)

Phases, any fault exits non-zero:

1. identify the card and build the CUDA kernels from ``src/repro_torch``;
2. hold each kernel against its plain PyTorch version at the shapes of the
   store's main path, bit for bit, and time both (CUDA events);
3. drive the store (``repro_torch.lsm.db.LsmDB``) at the paper's geometry:
   a seeded bulk load, a YCSB-A mix, deletes, compactions, reads checked
   against a dict of acknowledged writes, close, reopen, and the reads
   again; every kernel must have launched during this phase;
4. run one real compaction job of phase 3 through the engine on ``cuda``
   and on ``cpu``: the output images must be byte-identical.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import binascii
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import formats  # noqa: E402
from repro_torch.core.formats import SSTGeometry  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.lsm import sstable  # noqa: E402
from repro_torch.lsm.db import DBConfig, LsmDB  # noqa: E402
from repro_torch.lsm.engine import TorchCompactionEngine  # noqa: E402

# LUDA §IV-A (src/repro/configs/luda_paper.py): 16 B keys, 256 B values
# (+16 B slot header room), 4 KB blocks, 4 MB SSTs, 10 bloom bits per key
PAPER_GEOM = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096,
                         sst_bytes=4 * 1024 * 1024, bloom_bits_per_key=10)
PAPER_SCHED = SchedulerConfig(l0_trigger=4, base_bytes=32 * 1024 * 1024)

# NVIDIA H100 SXM data sheet: HBM3 rate, and the scalar (non-tensor-core)
# 32-bit rate, used for integer work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

KERNELS = {
    # name: (C entry point, phase-2 case, source, the TPU kernel replaced)
    "crc32_sections": ("crc32_sections", "crc32_sections",
                       "src/repro_torch/kernels/csrc/crc32.cu",
                       "src/repro/kernels/crc32.py:26"),
    "merge_runs": ("merge_pair", "merge_runs/65536",
                   "src/repro_torch/kernels/csrc/merge_path.cu",
                   "src/repro/kernels/merge_path.py:87"),
    "prefix_encode": ("prefix_encode", "prefix_encode",
                      "src/repro_torch/kernels/csrc/prefix.cu",
                      "src/repro/kernels/prefix.py:24"),
    "bloom_build": ("bloom_build", "bloom_build",
                    "src/repro_torch/kernels/csrc/bloom.cu",
                    "src/repro/kernels/bloom.py:25"),
}


def log(*a):
    print(*a, flush=True)


def as_i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        a.astype(np.uint32)).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def call_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one call of ``fn`` in ms, after two
    warm-up calls.  For a small kernel this is mostly the host's launch
    path (the stream waits for the host between the two events)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` in ms: the summed durations of the
    kernels (and copies) it runs, from the profiler's CUPTI trace, so the
    host's launch path is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / reps / 1e3


def sorted_keys(rng, n: int, lanes: int) -> np.ndarray:
    """Sorted big-endian key lanes sharing a "user" prefix, as the store's
    YCSB keys do."""
    k = rng.integers(0, 2**32, (n, lanes), dtype=np.uint32)
    k[:, 0] = 0x75736572
    k[:, 1] %= 1 << 12
    return k[np.lexsort(tuple(k[:, i] for i in reversed(range(lanes))))]


def tuple_runs(rng, run_rows: list[int], pad_rows: int,
               lanes: int) -> np.ndarray:
    """Phase-2 tuples ``<key, ~meta, index>``: sorted runs of real rows,
    then one run of all-ones padding rows."""
    parts = []
    for n in run_rows:
        keys = sorted_keys(rng, n, lanes)
        meta = ~((rng.integers(1, 2**30, n, dtype=np.uint32) << 1) | 1)
        parts.append(np.concatenate([keys, meta[:, None]], axis=1))
    parts.append(np.full((pad_rows, lanes + 1), 0xFFFFFFFF, np.uint32))
    rows = np.concatenate(parts)
    idx = np.arange(rows.shape[0], dtype=np.uint32)[:, None]
    return np.concatenate([rows, idx], axis=1)


def set_bits(words: np.ndarray) -> int:
    return int(np.unpackbits(np.ascontiguousarray(words).view(
        np.uint8)).sum())


def kernel_cases(rng, dev):
    """(name, kernel call, plain call, bytes, operations) at the main
    path's shapes: a 4-SST L0 job of the paper geometry (4096 blocks,
    65,536 rows) and a 16-SST merge (262,144 rows).  Bytes count each
    input read once and each output written once; operations count what
    these inputs need (the CRC loop runs once per set bit, the prefix loop
    stops at the first differing lane, the bloom skips invalid slots)."""
    g = PAPER_GEOM
    B, K, L, Vw = 4096, g.block_kvs, g.key_lanes, g.value_words
    widths = (1, K * L, K, K * Vw, K)
    host = [rng.integers(0, 2**32, (B, w), dtype=np.uint32) for w in widths]
    sections = [as_i32(h, dev) for h in host]
    W = sum(widths)
    crc_bytes = 4 * B * W + 4 * W * 32 + 4 * B
    # per set bit: load, xor, clear lowest; per word: load, test
    crc_ops = 3 * sum(set_bits(h) for h in host) + 2 * B * W
    cases = [("crc32_sections", lambda: ops.crc32_sections(sections),
              lambda: ref.crc32_words_sections(sections),
              crc_bytes, crc_ops)]

    for n_runs, run_rows, pad in ((4, 15_360, 4096), (16, 16_384, 0)):
        rows = as_i32(tuple_runs(rng, [run_rows] * n_runs, pad, L), dev)
        lens = [run_rows] * n_runs + [pad]
        n = rows.shape[0]
        levels = max(1, (len([x for x in lens if x]) - 1).bit_length())
        # per row and level: a binary search of up to log2(n) steps, each
        # comparing up to L + 2 lanes (two operations a lane)
        cases.append((f"merge_runs/{n}",
                      lambda r=rows, ln=lens: ops.merge_runs(r, ln),
                      lambda r=rows, ln=lens: ref.merge_runs(r, ln),
                      2 * n * (L + 2) * 4,
                      n * levels * n.bit_length() * 2 * (L + 2)))

    n = 65_536
    keys_np = sorted_keys(rng, n, L)
    keys = as_i32(keys_np, dev)
    shared = ref.prefix_encode(keys, restart_interval=16).cpu().numpy()
    lanes_compared = np.minimum(shared // 4 + 1, L).sum()
    cases.append(("prefix_encode",
                  lambda: ops.prefix_encode(keys, restart_interval=16),
                  lambda: ref.prefix_encode(keys, restart_interval=16),
                  n * L * 4 + n * 4, int(4 * lanes_compared)))

    bkeys = as_i32(rng.integers(0, 2**32, (B, K, L), dtype=np.uint32), dev)
    valid_np = rng.random((B, K)) < 0.94
    valid = torch.from_numpy(valid_np).to(dev)
    nw, probes = g.bloom_words(K), g.bloom_probes
    # per valid key: 2 FNV rounds a lane, two fmix32, and per probe a
    # multiply-add, a modulo, a shift and an atomic OR
    cases.append(("bloom_build",
                  lambda: ops.bloom_build(bkeys, valid, n_words=nw,
                                          n_probes=probes),
                  lambda: ref.bloom_build(bkeys, n_words=nw,
                                          n_probes=probes, valid=valid),
                  B * K * (L * 4 + 1) + B * nw * 4,
                  int(valid_np.sum()) * (L * 6 + 12 + probes * 5)))
    return cases, sections


def check_kernels(dev, card: str) -> dict:
    """Phase 2.  Returns per-kernel results keyed by kernel name; ``card``
    (name, power limit) goes beside every time."""
    rng = np.random.default_rng(2020)
    cases, sections = kernel_cases(rng, dev)
    results = {}
    for name, kern, plain, nbytes, nops in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((ref.u32(got) - ref.u32(want)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / SCALAR_OPS_PER_S * 1e3
        res = dict(max_abs_err=err, ms=device_ms(kern, 50),
                   plain_ms=device_ms(plain, 5),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   library_ms=None, call_ms=call_ms(kern, 50),
                   plain_call_ms=call_ms(plain, 5))
        log(f"  {name:22s} shape {tuple(got.shape)}: bit-identical; device "
            f"time kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} "
            f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); one "
            f"call {res['call_ms']:.4f} ms, plain {res['plain_call_ms']:.4f}"
            f" ms [{card}]")
        results[name] = res
    # the CRC chain anchored to binascii on sampled rows
    crc = ops.crc32_sections(sections).cpu().numpy().view(np.uint32)
    host = [s.cpu().numpy().view(np.uint32) for s in sections]
    for r in rng.choice(len(crc), 64, replace=False):
        row = np.concatenate([h[r] for h in host]).astype("<u4").tobytes()
        if binascii.crc32(row) & 0xFFFFFFFF != int(crc[r]):
            raise AssertionError(f"crc32: row {r} differs from binascii")
    log("  crc32_sections: 64 sampled rows equal binascii.crc32")
    return results


# ---------------------------------------------------------------------------
# phase 3: the store at the paper geometry
# ---------------------------------------------------------------------------


def zipf_ranks(rng, n: int, size: int, theta: float = 0.99) -> np.ndarray:
    """YCSB's zipfian (constant 0.99) over ``n`` ranks, scrambled so hot
    keys spread over the key space."""
    p = 1.0 / np.arange(1, n + 1) ** theta
    ranks = rng.choice(n, size=size, p=p / p.sum())
    return rng.permutation(n)[ranks]


def run_store(path: str, *, device, geom: SSTGeometry,
              sched: SchedulerConfig, records: int, operations: int,
              deletes: int, value_size: int, batch: int, sample: int,
              scan_keys: int, keep_dir: str, seed: int = 7) -> dict:
    """Phase 3: load, YCSB-A, deletes, compaction, checked reads, close,
    reopen, checked reads.  The first L0->L1 job's input files are copied
    to ``keep_dir`` for phase 4.  Returns the counts it saw."""
    rng = np.random.default_rng(seed)
    cfg = DBConfig(geom=geom, scheduler=sched)
    keys = [b"user%012d" % i for i in range(records)]
    vals = rng.integers(0, 256, (records + operations, value_size),
                        dtype=np.uint8)
    model: dict[bytes, bytes] = {}
    db = LsmDB(path, cfg, device=device)

    kept: dict = {}
    compact_paths = db.engine.compact_paths

    def keep_first_l0_job(paths, *, bottom_level=False):
        if not kept and len(paths) >= 4:
            os.makedirs(keep_dir, exist_ok=True)
            kept["paths"] = [shutil.copy(p, keep_dir) for p in paths]
            kept["bottom_level"] = bottom_level
        return compact_paths(paths, bottom_level=bottom_level)

    db.engine.compact_paths = keep_first_l0_job

    lat = {"write_batch": [], "get": [], "put": []}   # host clock, us
    clock = time.perf_counter_ns
    t0 = time.perf_counter()
    order = rng.permutation(records)
    for s in range(0, records, batch):
        ops_ = []
        for i in order[s:s + batch]:
            v = vals[i].tobytes()
            ops_.append(("put", keys[i], v))
            model[keys[i]] = v
        c0 = clock()
        db.write_batch(ops_)
        lat["write_batch"].append((clock() - c0) / 1e3)
    t_load = time.perf_counter() - t0

    t0 = time.perf_counter()
    targets = zipf_ranks(rng, records, operations)
    is_read = rng.random(operations) < 0.5
    for j, (i, read) in enumerate(zip(targets, is_read)):
        k = keys[i]
        c0 = clock()
        if read:
            got = db.get(k)
            lat["get"].append((clock() - c0) / 1e3)
            if got != model.get(k):
                raise AssertionError(f"ycsb read of {k!r} disagrees")
        else:
            v = vals[records + j].tobytes()
            db.put(k, v)
            lat["put"].append((clock() - c0) / 1e3)
            model[k] = v
    deleted = [keys[i] for i in rng.choice(records, deletes, replace=False)]
    for k in deleted:
        db.delete(k)
        model.pop(k, None)
    db.maybe_compact()
    t_ops = time.perf_counter() - t0

    probe = [keys[i] for i in rng.choice(records, sample, replace=False)]
    lo = int(rng.integers(0, records - scan_keys))
    start, end = keys[lo], keys[lo + scan_keys]
    want_scan = sorted((k, v) for k, v in model.items() if start <= k < end)

    def check_reads(store, when):
        for k in probe + deleted:
            if store.get(k) != model.get(k):
                raise AssertionError(f"{when}: get({k!r}) disagrees")
        if store.scan(start, end) != want_scan:
            raise AssertionError(f"{when}: scan disagrees")

    check_reads(db, "before reopen")
    counts = ops.launch_counts()
    stats = db.stats
    jobs = list(db.compactions)
    levels = db.level_sizes()
    db.close()
    db = LsmDB(path, cfg, device=device)
    check_reads(db, "after reopen")
    db.close()

    l0 = [r for r in jobs if r.level == 0]
    l1 = [r for r in jobs if r.level == 1]
    return dict(
        launches=counts, levels=levels, flushes=stats.flushes,
        compactions=stats.compactions, trivial_moves=stats.trivial_moves,
        l0_jobs=len(l0), l0_min_inputs=min((r.inputs for r in l0),
                                           default=0),
        l1_jobs=len(l1), bytes_in=stats.compact_bytes_in,
        bytes_out=stats.compact_bytes_out,
        device_s=stats.compact_device_seconds,
        sort_s=stats.compact_sort_seconds,
        host_s=stats.compact_host_seconds, load_s=t_load, ops_s=t_ops,
        checked=len(probe) + len(deleted) + 1, scan_rows=len(want_scan),
        dropped=stats.compact_entries_dropped,
        latency_us={op: [float(np.percentile(v, q)) for q in (50, 99, 99.9)]
                    for op, v in lat.items()},
        kept=kept)


# ---------------------------------------------------------------------------
# phase 4: one real job, device against CPU
# ---------------------------------------------------------------------------


def compare_job(kept: dict, geom: SSTGeometry, device) -> int:
    """Run the kept job through the engine on ``device`` and on the CPU;
    raise unless the images are byte-identical.  Returns live rows."""
    images = [sstable.read_sst(p) for p in kept["paths"]]
    outs = []
    for dev in (device, "cpu"):
        eng = TorchCompactionEngine(geom, device=dev)
        out, es = eng.compact(images, bottom_level=kept["bottom_level"])
        if not es.crc_ok:
            raise AssertionError(f"{dev}: kept job failed CRC")
        outs.append((out, es))
    (a, sa), (b, sb) = outs
    for name, x, y in zip(formats.SSTImage._fields, a, b):
        if x.dtype != y.dtype or x.shape != y.shape or \
                x.tobytes() != y.tobytes():
            raise AssertionError(f"job output {name} differs: "
                                 f"{device} vs cpu")
    if (sa.n_input, sa.n_live) != (sb.n_input, sb.n_live):
        raise AssertionError("job stats differ between devices")
    return sa.n_live


# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device: {kind}")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    _build.library()
    log(f"[1] kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds} s)")
    for line in _build.build_log().splitlines():
        if line.startswith("==") or "registers" in line or "stack" in line:
            log(f"    {line.strip()}")

    log("[2] kernels against their plain versions (65,536-row job shapes)")
    checks = check_kernels(dev, card)

    log("[3] store at the paper geometry")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    try:
        ops.reset_launch_counts()
        st = run_store(os.path.join(work, "db"), device=dev, geom=PAPER_GEOM,
                       sched=PAPER_SCHED, records=330_000,
                       operations=20_000, deletes=2_000, value_size=256,
                       batch=1_000, sample=20_000, scan_keys=5_000,
                       keep_dir=os.path.join(work, "job"))
        log(f"[3] load {st['load_s']:.1f} s, ycsb+deletes+compact "
            f"{st['ops_s']:.1f} s; {st['flushes']} flushes, "
            f"{st['compactions']} compactions ({st['l0_jobs']} L0->L1, each "
            f">= {st['l0_min_inputs']} inputs; {st['l1_jobs']} L1->L2), "
            f"{st['trivial_moves']} trivial moves; levels {st['levels']}")
        log(f"[3] compacted {st['bytes_in']} B in -> {st['bytes_out']} B "
            f"out ({st['dropped']} entries dropped); device "
            f"{st['device_s']:.4f} s (phase 2 {st['sort_s']:.4f} s), host "
            f"{st['host_s']:.2f} s")
        for op, (p50, p99, p999) in st["latency_us"].items():
            log(f"[3] {op} latency p50 {p50:.1f} us, p99 {p99:.1f} us, "
                f"p99.9 {p999:.1f} us (host clock)")
        log(f"[3] {st['checked']} reads and a {st['scan_rows']}-row scan "
            f"agree before and after reopen; launches {st['launches']}")
        if st["l0_jobs"] < 4 or st["l0_min_inputs"] < 4:
            raise AssertionError("expected >= 4 L0->L1 compactions of >= 4 "
                                 "inputs each")
        if st["l1_jobs"] < 1:
            raise AssertionError("expected >= 1 L1->L2 compaction")
        idle = [k for k, n in st["launches"].items() if n == 0]
        if idle:
            raise AssertionError(f"kernels not launched on the main path: "
                                 f"{idle}")

        log("[4] one real L0->L1 job on cuda and on cpu")
        live = compare_job(st["kept"], PAPER_GEOM, dev)
        log(f"[4] {len(st['kept']['paths'])} input SSTs -> {live} live "
            "entries: output images byte-identical")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for name, (entry, case, source, replaces) in KERNELS.items():
        r = checks[case]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=st["launches"][entry], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            call_ms=r["call_ms"], plain_call_ms=r["plain_call_ms"]))
    big = checks["merge_runs/262144"]
    log(f"merge_runs at 262,144 rows: device time kernel {big['ms']:.4f} "
        f"ms, plain {big['plain_ms']:.4f} ms, bound {big['bound_ms']:.4f} ms;"
        f" one call {big['call_ms']:.4f} ms")
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
