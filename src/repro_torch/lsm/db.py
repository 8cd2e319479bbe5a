"""The LSM key-value store over the port's compaction engine (the port of
``repro.lsm.db``).

    put() -> WAL append -> active memtable
                |  (memtable full)
                v
        sync mode:  the engine builds the L0 image on the device, then
                    the compaction cascade runs inline (``maybe_compact``)
        async mode: rotate the active table onto the immutable queue and
                    return; ``flush_workers`` threads build the L0 images
                    and install them in rotation order, and one
                    compaction worker drains the scheduler through the
                    engine (``DBConfig.async_compaction``)

Every flush and compaction goes through the engine that ``DBConfig.engine``
names (``make_engine``): ``"device"``, the default, is
``TorchCompactionEngine`` on the store's device, ``cuda`` unless the
caller passes ``device="cpu"``; ``"cpu"`` is the paper's baseline, the
numpy ``CpuCompactionEngine`` on the host.  The
store writes the same SST files, WAL and manifest as ``repro.lsm.db.LsmDB``
for the same operations, so a directory written by either opens in the
other.  Reads: ``get``, ``scan`` and the batched ``multi_get``
(``lsm.read``), each through an optional pinned ``snapshot()``.

A store can also take a shared engine and hand its compactions to a
``compaction_sink`` instead of running them (``engine=``,
``compaction_sink=``): ``lsm.sharded.ShardedDB`` gives every shard one
engine and one ``core.background.GlobalCompactionQueue``, whose worker
thread drives ``pick_compaction`` / ``apply_trivial_move`` /
``apply_compaction`` while the caller writes.

**Async mode.**  A full memtable is rotated in O(1): its WAL segment is
closed and renamed (``wal-NNNNNN.log``) and the table joins the immutable
queue, still readable, while a flush worker builds its L0 image on the
device outside the store's lock.  Installs take tickets in rotation order
(``core.background.InstallSequencer``), so a newer memtable never lands
below an older one and the file numbers are the ones a synchronous store
allocates; WAL segments are unlinked inside the sequenced region.  A
writer stalls only while ``max_pending_memtables`` tables are queued
(``DBStats.write_stalls``), and a write with ``WriteOptions(wait_stall=
False)`` raises ``IOError`` there instead.  A transient failure of a
background build or compaction job is retried ``bg_max_retries`` times
with backoff (``faults.with_retries``, ``DBStats.bg_retries``); a failure
that outlasts them, or a hard one, halts the pipeline: it is parked on the
store as a classified ``faults.BackgroundError``, raised at the next
rotation, ``flush``, ``wait_idle`` or ``close``; no younger memtable
installs below the failed one, and ``resume()`` re-queues the parked
tables (``DBStats.bg_resumes``).  Nothing is re-run on another engine.
``wait_idle()`` is the barrier.

**Durability and repair.**  ``DBConfig.sync_writes`` fsyncs every WAL
append and the directory entries of created and renamed files, so an
acknowledged write survives a kill; ``WriteOptions.sync`` overrides it a
call.  ``LsmDB.open(path, cfg, repair=True)`` runs ``lsm.repair`` first.
The failpoints of ``lsm.faults`` fire at ``db.write_batch`` (between the
WAL record and the memtable apply), ``flush.build`` and
``compact.install``; ``DBConfig.failpoints`` arms them at open.

One ``RLock`` guards the memtables, the version set and manifest, the
scheduler's pointers, the file numbers and the installs; SST files are
written outside it.  Reads take the memtables and ``versions.current``
once under it and search outside it.  Every thread launches on the
device's default stream, which they share: a reader's kernels and a
worker's are ordered on it, so a tensor one thread frees is never handed
out again while another thread's queued kernel still reads it.

**Metrics and tracing** (as JAX's store records them).  Every ``DBStats``
field is a registry counter ``lsm.<field>`` (``DBConfig.metrics`` or
``metrics=``; a private ``obs.MetricsRegistry`` by default,
``obs.NULL_REGISTRY`` to opt out), bumped atomically from any thread;
``stats`` reads them into a point-in-time ``DBStats``.  Beside them: the
histograms ``lsm.op.latency_us{op=put|get|multi_get|write_batch}`` and the
gauges ``lsm.imm_queue.depth``, ``lsm.compaction.debt`` and
``lsm.bg_error`` (0 healthy, 1 transient, 2 hard), the first two also
sampled onto the tracer's counter tracks.  A tracer (``DBConfig.tracer``
or ``tracer=``; ``obs.NULL_TRACER`` by default) records the spans
``db.put``, ``db.write_batch``, ``db.multi_get``, ``write_stall`` (args
``cause``, ``depth``), ``memtable.rotate``, ``db.resume``,
``flush.build``, ``flush.install_l0``, ``flush.sync``, ``compact.pick``,
``compact.trivial_move``, ``compact.install`` and ``compact.job``; the
store's own engine records its launch spans into the same tracer.
``metric_labels`` (``ShardedDB``: ``shard=i``) label every series and go
into the spans' args.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import threading
import time
from typing import NamedTuple

import numpy as np

from repro_torch.core import formats
from repro_torch.core.background import (BackgroundExecutor,
                                         InstallSequencer, remaining)
from repro_torch.core.formats import SSTGeometry, SSTImage
from repro_torch.core.scheduler import (CompactionJob, CompactionScheduler,
                                        SchedulerConfig)
from repro_torch.lsm import (DEFAULT_READ_OPTIONS, DEFAULT_WRITE_OPTIONS,
                             ReadOptions, WriteOptions, faults, memtable,
                             sstable, wal)
from repro_torch.lsm import read as lsm_read
from repro_torch.device import resolve_device
from repro_torch.lsm.cpu_engine import CpuCompactionEngine
from repro_torch.lsm.engine import EngineStats, TorchCompactionEngine
from repro_torch.lsm.faults import BackgroundError
from repro_torch.lsm.fs import fsync_dir
from repro_torch.lsm.memtable import ImmutableMemTable
from repro_torch.lsm.sstable import BlockCache, FileMeta, TableCache
from repro_torch.lsm.version import VersionEdit, VersionSet
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class DBConfig:
    geom: SSTGeometry = dataclasses.field(default_factory=SSTGeometry)
    engine: str = "device"          # "device" (the torch engine) | "cpu"
    #   (the numpy baseline)
    sort_mode: str = "merge"        # device engine phase-2 mode: "merge"
    #   | "device" (the bitonic kernel) | "xla" | "cooperative" (the
    #   paper's host sort)
    threads: int = 1                # modelled CPU compaction threads
    memtable_bytes: int | None = None   # None: one SST's worth
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    table_cache: int = 64
    block_cache_blocks: int = 4096  # host LRU of decoded blocks (0 = off)
    sync_wal: bool = False          # fsync every WAL append
    sync_writes: bool = False       # full durability for acknowledged
    #   writes: fsync every WAL append AND the directory entries of created
    #   and renamed files (the crash matrix runs with it)
    auto_compact: bool = True
    async_compaction: bool = False  # non-blocking writes: background
    #   flushes and one compaction worker
    flush_workers: int = 1          # image builds overlap; installs ordered
    max_pending_memtables: int = 4  # immutable-queue depth before stalling
    metrics: object | None = None   # obs.MetricsRegistry (None: a private
    #   registry; obs.NULL_REGISTRY opts out of the counters)
    tracer: object | None = None    # obs.Tracer (None: NULL_TRACER)
    failpoints: object | None = None    # a fault-injection spec (str or
    #   dict), installed into ``faults.FAILPOINTS`` at open
    bg_max_retries: int = 3         # retries of a transient background failure
    bg_retry_base_s: float = 0.005  # their backoff base (doubles, with jitter)


@dataclasses.dataclass
class DBStats:
    """Point-in-time statistics (``LsmDB.stats``).  The live counters are
    the registry's ``lsm.<field>`` counters, labelled by shard in a
    ``ShardedDB``; every field of JAX's ``DBStats`` is here, and four the
    port adds: ``multi_get_waves``, ``multi_get_staged_bytes``,
    ``multi_get_stage_seconds`` and ``compact_wall_seconds``."""

    puts: int = 0
    write_batches: int = 0
    batch_ops: int = 0
    gets: int = 0
    multi_gets: int = 0
    multi_get_keys: int = 0
    multi_get_waves: int = 0               # stacked prune -> gather passes
    multi_get_staged_bytes: int = 0        # copied to the device stages
    multi_get_stage_seconds: float = 0.0   # device stages, host clock
    deletes: int = 0
    flushes: int = 0
    compactions: int = 0
    trivial_moves: int = 0
    batched_compactions: int = 0   # jobs installed from a stacked launch
    compact_bytes_in: int = 0
    compact_bytes_out: int = 0
    compact_entries_in: int = 0
    compact_entries_dropped: int = 0
    compact_host_seconds: float = 0.0
    compact_wall_seconds: float = 0.0     # around the store's own engine
    #   calls (a compaction queue's jobs are not timed here)
    compact_device_seconds: float = 0.0   # CUDA-event spans (0.0 on the
    #   CPU); on an async store they hold other threads' work too
    compact_sort_seconds: float = 0.0     # phase-2 share of the above
    flush_host_seconds: float = 0.0
    bloom_negative_skips: int = 0
    block_cache_hits: int = 0
    block_cache_misses: int = 0
    write_stalls: int = 0          # rotations that waited for a full queue
    bg_retries: int = 0            # retries of transient background failures
    bg_resumes: int = 0            # resume() calls that cleared a bg_error
    orphans_removed: int = 0
    engine_fallbacks: int = 0      # always 0: JAX's count of jobs its CPU
    #   engine finished after a failed launch; the port has no fallback

    def add(self, other: "DBStats") -> "DBStats":
        """Field-wise sum (aggregation across shards)."""
        return DBStats(**{f.name: getattr(self, f.name) +
                          getattr(other, f.name)
                          for f in dataclasses.fields(DBStats)})


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Pinned read view from ``LsmDB.snapshot()``: the SST version and the
    memtable set as of capture.  The memtables are held by reference: the
    active one stays live (it takes later writes until it rotates), the
    immutable ones are frozen.  Files compacted away while the snapshot is
    held raise ``FileNotFoundError`` on access."""

    mems: tuple          # newest first: (active, imm newest, ..., oldest)
    version: object      # pinned lsm.version.Version


class CompactionRecord(NamedTuple):
    """One compaction the store ran: its input level, input file count
    and the engine's accounting."""
    level: int
    inputs: int
    stats: EngineStats


def make_engine(cfg: DBConfig, device=None):
    """Build the compaction engine a ``DBConfig`` names: ``"device"`` is
    the torch engine on ``device`` (None: ``cuda``), ``"cpu"`` the numpy
    baseline, which touches no device.  The engine takes ``cfg.tracer``,
    so its launch spans land in the store's trace."""
    if cfg.engine == "device":
        return TorchCompactionEngine(cfg.geom, device=device,
                                     sort_mode=cfg.sort_mode,
                                     tracer=cfg.tracer)
    if cfg.engine == "cpu":
        return CpuCompactionEngine(cfg.geom, threads=cfg.threads,
                                   tracer=cfg.tracer)
    raise ValueError(f"unknown engine {cfg.engine!r}")


class LsmDB:
    def __init__(self, path: str, cfg: DBConfig | None = None, *,
                 device=None, engine=None, compaction_sink=None,
                 metrics=None, tracer=None, metric_labels=None):
        """Open (or create) the store at ``path``.  ``device``: where the
        device engine's flushes and compactions and the read path's
        batched stages run; None means ``cuda``, which must be present
        (pass ``device="cpu"`` to run on the CPU).

        ``engine``: a (possibly shared) compaction engine to use instead
        of building one from ``cfg``; a shared engine is not closed with
        the store.  ``compaction_sink``: when set, the store never runs
        compactions itself; it calls ``compaction_sink(self)`` whenever it
        has compaction work, and the sink's owner drives
        ``pick_compaction`` / ``apply_trivial_move`` /
        ``apply_compaction`` (``core.background.GlobalCompactionQueue``).
        In async mode such a store starts flush workers and no compaction
        worker.

        ``metrics`` / ``tracer`` / ``metric_labels``: the registry, the
        tracer and the labels of every series (``ShardedDB`` shares one
        registry and one tracer across its shards, labelled ``shard=i``);
        they win over ``cfg.metrics`` and ``cfg.tracer``.  An engine the
        store builds takes its tracer.
        """
        self.path = path
        self.cfg = cfg or DBConfig()
        self.geom = self.cfg.geom
        self._device = resolve_device(device)
        if self.cfg.failpoints is not None:
            faults.FAILPOINTS.install(self.cfg.failpoints)
        self._init_obs(metrics, tracer, metric_labels)
        self._owns_engine = engine is None
        self._compaction_sink = compaction_sink
        if engine is None:
            engine = make_engine(self.cfg, self._device)
            # a tracer given here, not in cfg, reaches the store's engine
            engine.tracer = self.tracer
        self.engine = engine
        os.makedirs(path, exist_ok=True)
        self._lock = threading.RLock()
        self._imm_cv = threading.Condition(self._lock)
        self.compactions: list[CompactionRecord] = []  # guarded-by: _lock
        self.versions = VersionSet(path)                # guarded-by: _lock
        self.versions.open()
        self.scheduler = CompactionScheduler(           # guarded-by: _lock
            self.cfg.scheduler)
        self.scheduler.compact_pointer = dict(self.versions.compact_pointer)
        # the cache counts its hits and misses straight into the registry
        self.block_cache = BlockCache(
            self.cfg.block_cache_blocks,
            on_hit=self._c["block_cache_hits"].inc,
            on_miss=self._c["block_cache_misses"].inc)
        self.cache = TableCache(self.cfg.table_cache, geom=self.geom,
                                block_cache=self.block_cache,
                                device=self._device)
        self.mem = memtable.MemTable()                  # guarded-by: _lock
        # rotated tables waiting for their flush, oldest first
        self.imm: list[ImmutableMemTable] = []          # guarded-by: _lock
        self._memtable_limit = self.cfg.memtable_bytes or self.geom.sst_bytes
        self._wal_path = os.path.join(path, "wal.log")
        self._wal_seg_no = 0                            # guarded-by: _lock
        self._extra_wals: list[str] = []                # guarded-by: _lock
        self._wal_sync = self.cfg.sync_wal or self.cfg.sync_writes
        self._replay_wal_locked()
        self._gc_orphans_locked()
        self._wal = wal.WALWriter(                      # guarded-by: _lock
            self._wal_path, sync=self._wal_sync)
        self._closed = False                            # guarded-by: _lock
        self._async = bool(self.cfg.async_compaction)
        self._install_seq = InstallSequencer()
        self._compact_scheduled = False                 # guarded-by: _lock
        # a BackgroundError, or the SimulatedCrash of a dead worker
        self._bg_error: BaseException | None = None     # guarded-by: _lock
        if self._async:
            self._flush_exec = BackgroundExecutor(
                workers=max(1, self.cfg.flush_workers), name="flush")
            # with a compaction sink its owner runs the compactions
            self._compact_exec = None if compaction_sink is not None else \
                BackgroundExecutor(workers=1, name="compact")
        else:
            self._flush_exec = self._compact_exec = None

    @classmethod
    def open(cls, path: str, cfg: DBConfig | None = None, *,
             repair: bool = False, **kw) -> "LsmDB":
        """Open a store, with crash repair first when ``repair`` is set:
        ``lsm.repair.repair`` quarantines corrupt SSTs to ``lost/``,
        truncates torn WAL tails and rebuilds the MANIFEST from the
        surviving files (offline: ``python -m repro_torch.lsm.repair
        <dir>``).  ``kw`` goes to the constructor (``device``, ...)."""
        resolve_device(kw.get("device"))   # no card: raise before repair
        if repair and os.path.isdir(path):
            from repro_torch.lsm import repair as repair_mod
            repair_mod.repair(path)
        return cls(path, cfg, **kw)

    @property
    def device(self):
        return self._device

    def _init_obs(self, metrics, tracer, metric_labels):
        """The registry's counters (one a ``DBStats`` field), histograms
        and gauges, and the tracer, as JAX's store makes them."""
        if metrics is None:
            metrics = self.cfg.metrics
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        t = tracer if tracer is not None else self.cfg.tracer
        self.tracer = t if t is not None else NULL_TRACER
        labels = dict(metric_labels or {})
        self._span_args = labels or None
        # a counter track a shard, so that Perfetto draws them apart
        self._track = "".join(f"[{k}={v}]" for k, v in sorted(labels.items()))
        self._c = {f.name: self.metrics.counter(f"lsm.{f.name}", **labels)
                   for f in dataclasses.fields(DBStats)}
        self._h_put = self.metrics.histogram("lsm.op.latency_us",
                                             op="put", **labels)
        self._h_get = self.metrics.histogram("lsm.op.latency_us",
                                             op="get", **labels)
        self._h_multi_get = self.metrics.histogram("lsm.op.latency_us",
                                                   op="multi_get", **labels)
        self._h_write_batch = self.metrics.histogram(
            "lsm.op.latency_us", op="write_batch", **labels)
        self._g_imm = self.metrics.gauge("lsm.imm_queue.depth", **labels)
        self._g_debt = self.metrics.gauge("lsm.compaction.debt", **labels)
        # 0: healthy, 1: a transient bg_error (resume() recovers), 2: a
        # hard one (repair first)
        self._g_bg_error = self.metrics.gauge("lsm.bg_error", **labels)

    @property
    def stats(self) -> DBStats:
        """Point-in-time ``DBStats`` of the registry's counters, as
        ``repro.lsm.db.LsmDB.stats``: two reads give two objects, so their
        difference is what happened in between."""
        return DBStats(**{
            f.name: (float(v) if isinstance(f.default, float) else int(v))
            for f in dataclasses.fields(DBStats)
            for v in (self._c[f.name].value,)})

    def _sample_pressure_locked(self):
        """Set the write-pressure gauges (immutable-queue depth and
        compaction debt) and, when tracing, sample them onto counter
        tracks.  Called on state transitions."""
        depth = len(self.imm)
        debt = self.scheduler.debt(self.versions.current)
        self._g_imm.set(depth)
        self._g_debt.set(debt)
        tr = self.tracer
        if tr.enabled:
            tr.counter("lsm.imm_queue.depth" + self._track, depth)
            tr.counter("lsm.compaction.debt" + self._track, round(debt, 3))

    def _replay_wal_locked(self):
        """Replay rotated WAL segments (an async-mode store leaves them),
        oldest first, then the active WAL.  They stay on disk until the
        recovered memtable flushes."""
        segs = sorted(glob.glob(os.path.join(self.path, "wal-*.log")))
        if segs:
            self._wal_seg_no = max(int(os.path.basename(p)[4:-4])
                                   for p in segs)
        self._extra_wals = list(segs)
        for p in segs + [self._wal_path]:
            for kind, seq, key, value in wal.replay(p):
                if kind == wal.PUT:
                    self.mem.put(key, seq, value)
                else:
                    self.mem.delete(key, seq)
                self.versions.last_seq = max(self.versions.last_seq, seq)

    def _gc_orphans_locked(self):
        """Delete crash leftovers: stale ``*.tmp`` files and SSTs that no
        version references (their data is in the WAL just replayed, or in
        installed compaction outputs)."""
        live = {fm.file_no for _, fm in self.versions.current.all_files()}
        for name in os.listdir(self.path):
            p = os.path.join(self.path, name)
            if not os.path.isfile(p):
                continue
            stale = name.endswith(".tmp")
            if name.endswith(".sst"):
                try:
                    stale = int(name[:-4]) not in live
                except ValueError:
                    continue
            if stale:
                os.remove(p)
                self._c["orphans_removed"].inc()

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------

    def _check_key(self, key: bytes):
        if len(key) > self.geom.key_bytes:
            raise ValueError(f"key too long ({len(key)} > "
                             f"{self.geom.key_bytes} bytes)")
        if key.endswith(b"\x00") or not key:
            raise ValueError("keys must be non-empty and not end with NUL "
                             "(fixed-width key format)")

    def _check_value(self, value: bytes):
        if len(value) > self.geom.value_bytes - 4:
            raise ValueError(f"value too long ({len(value)} > "
                             f"{self.geom.value_bytes - 4} bytes)")

    def _check_open_locked(self):
        if self._closed:
            raise IOError("database is closed")

    def _next_seq_locked(self) -> int:
        self.versions.last_seq += 1
        return self.versions.last_seq

    def put(self, key: bytes, value: bytes,
            opts: WriteOptions | None = None):
        opts = opts or DEFAULT_WRITE_OPTIONS
        self._check_key(key)
        self._check_value(value)
        t0 = time.perf_counter_ns()
        with self._lock:
            self._check_open_locked()
            seq = self._next_seq_locked()
            self._wal.append(wal.PUT, seq, key, value, sync=opts.sync)
            self.mem.put(key, seq, value)
            self._maybe_flush_locked(wait_stall=opts.wait_stall)
        # the hot path: an atomic counter and a lock-free histogram append
        dt = time.perf_counter_ns() - t0
        self._c["puts"].inc()
        self._h_put.pend(dt / 1000.0)
        tr = self.tracer
        if tr.enabled:
            tr.complete("db.put", t0, dt)

    def delete(self, key: bytes, opts: WriteOptions | None = None):
        opts = opts or DEFAULT_WRITE_OPTIONS
        self._check_key(key)
        with self._lock:
            self._check_open_locked()
            seq = self._next_seq_locked()
            self._wal.append(wal.DELETE, seq, key, sync=opts.sync)
            self.mem.delete(key, seq)
            self._maybe_flush_locked(wait_stall=opts.wait_stall)
        self._c["deletes"].inc()

    def write_batch(self, ops, opts: WriteOptions | None = None) -> int:
        """Apply ``("put", key, value)`` / ``("delete", key)`` ops in order
        as ONE CRC-framed WAL record: replay after a crash recovers every
        op or none.  Returns the number of ops applied."""
        opts = opts or DEFAULT_WRITE_OPTIONS
        rows = []
        for op in ops:
            if op[0] == "put":
                _, key, value = op
                self._check_key(key)
                self._check_value(value)
                rows.append((wal.PUT, key, value))
            elif op[0] == "delete":
                self._check_key(op[1])
                rows.append((wal.DELETE, op[1], b""))
            else:
                raise ValueError(f"unknown batch op {op[0]!r} "
                                 "(want 'put' or 'delete')")
        if not rows:
            return 0
        t0 = time.perf_counter_ns()
        with self._lock:
            self._check_open_locked()
            first_seq = self.versions.last_seq + 1
            self.versions.last_seq += len(rows)
            self._wal.append_batch(rows, first_seq, sync=opts.sync)
            # the crash window: the WAL record is written, the memtable
            # not yet; replay applies the whole batch (or, torn, none)
            faults.fire("db.write_batch")
            for i, (kind, key, value) in enumerate(rows):
                if kind == wal.PUT:
                    self.mem.put(key, first_seq + i, value)
                else:
                    self.mem.delete(key, first_seq + i)
            self._maybe_flush_locked(wait_stall=opts.wait_stall)
        dt = time.perf_counter_ns() - t0
        self._c["write_batches"].inc()
        self._c["batch_ops"].inc(len(rows))
        self._h_write_batch.pend(dt / 1000.0)
        tr = self.tracer
        if tr.enabled:
            tr.complete("db.write_batch", t0, dt,
                        args={"n_ops": len(rows), **(self._span_args or {})})
        return len(rows)

    def _maybe_flush_locked(self, wait_stall: bool = True):
        if self.mem.approx_bytes < self._memtable_limit:
            return
        if self._async:
            self._rotate_locked(wait_stall=wait_stall)
            return
        self.flush()
        if self.cfg.auto_compact:
            self.maybe_compact()

    def _raise_if_halted_locked(self):
        """Raise the parked background error, if any: the pipeline is
        halted until ``resume()``.  A parked ``SimulatedCrash`` is raised
        as it is: the store is dead."""
        err = self._bg_error
        if isinstance(err, faults.SimulatedCrash):
            raise err
        if err is not None:
            raise BackgroundError(err.op, err.cause) from err

    def _rotate_locked(self, wait_stall: bool = True):
        """Move the active memtable onto the immutable queue (O(1): close
        and rename its WAL segment) and hand it to a flush worker.  The
        writer stalls while ``max_pending_memtables`` tables are queued,
        or, without ``wait_stall``, raises ``IOError`` (the write that
        triggered the rotation is already in the WAL and the active
        memtable: only the rotation is refused)."""
        # surface an earlier background failure BEFORE touching rotation
        # state: a raise after issuing the ticket would orphan it and
        # wedge every later install
        self._flush_exec.check()
        self._raise_if_halted_locked()
        tr = self.tracer
        while len(self.imm) >= self.cfg.max_pending_memtables:
            if not wait_stall:
                raise IOError(
                    "write stall: immutable-memtable queue is full and "
                    "WriteOptions.wait_stall is False")
            self._c["write_stalls"].inc()
            self._sample_pressure_locked()
            t_stall = time.perf_counter_ns()
            ok = self._imm_cv.wait(timeout=60.0)
            if tr.enabled:
                tr.complete("write_stall", t_stall,
                            time.perf_counter_ns() - t_stall,
                            args={"cause": "imm_queue_full",
                                  "depth": len(self.imm),
                                  **(self._span_args or {})})
            if not ok:
                raise IOError("write stalled > 60 s: the immutable queue "
                              "is not draining")
            self._raise_if_halted_locked()
        t_rot = time.perf_counter_ns()
        self._wal.close()
        self._wal_seg_no += 1
        seg = os.path.join(self.path, f"wal-{self._wal_seg_no:06d}.log")
        os.rename(self._wal_path, seg)
        if self._wal_sync:
            fsync_dir(self.path)   # the rename survives a crash
        entry = ImmutableMemTable(table=self.mem,
                                  wal_paths=self._extra_wals + [seg],
                                  ticket=self._install_seq.issue())
        self._extra_wals = []
        # publish order: the table joins the queue before the active one
        # is replaced, and both happen under the lock readers take
        self.imm.append(entry)
        self.mem = memtable.MemTable()
        self._wal = wal.WALWriter(self._wal_path, sync=self._wal_sync)
        self._sample_pressure_locked()
        if tr.enabled:
            tr.complete("memtable.rotate", t_rot,
                        time.perf_counter_ns() - t_rot, args=self._span_args)
        self._flush_exec.submit(self._background_flush, entry)

    def _set_bg_error(self, err: BaseException,
                      op: str = "flush") -> BaseException:
        """Park the first background error (classified) and wake stalled
        writers, whose queue will not drain now.  Returns the error the
        worker raises: the classified wrapper, except a ``SimulatedCrash``,
        which stays what it is (a simulated death is not a failure the
        store may handle).  A parked crash halts the store as a process
        death would: no younger memtable installs over the dead worker's
        table, whose WAL segment replays over it on reopen.  (JAX parks
        none: its crash matrix loses acknowledged writes once a build
        outlasts a memtable's filling.)"""
        if not isinstance(err, (BackgroundError, faults.SimulatedCrash)):
            err = BackgroundError(op, err)
        with self._lock:
            if self._bg_error is None:
                self._bg_error = err
                if isinstance(err, BackgroundError):
                    self._g_bg_error.set(
                        1 if err.severity == "transient" else 2)
            self._imm_cv.notify_all()
        return err

    def resume(self) -> bool:
        """Clear a background error and restart the halted pipeline: issue
        new install tickets to every memtable still on the immutable
        queue (in rotation order), resubmit their flushes, and reschedule
        compaction.  Returns True when an error was cleared.  After a
        hard error (corruption) the damage is still on disk.  A parked
        ``SimulatedCrash`` is raised again: a dead store stays dead."""
        t0 = time.perf_counter_ns()
        if self._async:
            # let in-flight work end first: it is failing or skipping
            # against the standing error, which is what this clears
            try:
                self._flush_exec.wait_idle()
            except BackgroundError:
                pass
        with self._lock:
            if self._bg_error is None:
                return False
            if isinstance(self._bg_error, faults.SimulatedCrash):
                raise self._bg_error
            err = self._bg_error
            self._bg_error = None
            self._g_bg_error.set(0)
            resub = [dataclasses.replace(e, ticket=self._install_seq.issue())
                     for e in self.imm]
            self.imm = resub
            self._imm_cv.notify_all()
        self._c["bg_resumes"].inc()
        for e in resub:
            self._flush_exec.submit(self._background_flush, e)
        if self.cfg.auto_compact and \
                (self._async or self._compaction_sink is not None):
            self._schedule_compaction()
        tr = self.tracer
        if tr.enabled:
            tr.complete("db.resume", t0, time.perf_counter_ns() - t0,
                        args={"cleared": repr(err), "requeued": len(resub),
                              **(self._span_args or {})})
        return True

    def _background_flush(self, entry: ImmutableMemTable):
        """A flush worker's task: build ``entry``'s L0 image on the
        device (outside the store's lock, beside other builds), then
        install it in ticket order and unlink its WAL segments."""
        t0 = time.perf_counter()

        def build():
            with self.tracer.span("flush.build", **(self._span_args or {})):
                entries = entry.table.sorted_entries()
                faults.fire("flush.build")
                if not entries:
                    return None
                return self.engine.build_image(*self._pack_entries(entries))

        try:
            # a transient failure (an I/O hiccup, an injected soft fault)
            # is retried with backoff before it halts the pipeline
            img = faults.with_retries(
                build, retries=self.cfg.bg_max_retries,
                base_s=self.cfg.bg_retry_base_s,
                on_retry=self._c["bg_retries"].inc)
        except BaseException as e:
            # halt the pipeline: a younger memtable must not install below
            # this still-queued older one, or this table's data would
            # shadow newer L0 data.  Consume the ticket so the younger
            # workers are not wedged; the table stays queued and readable.
            err = self._set_bg_error(e)
            self._install_seq.wait_turn(entry.ticket)
            self._install_seq.done(entry.ticket)
            raise err
        # installs land in rotation order: L0 reads resolve overwrites by
        # file number, so a newer memtable must not install below an older
        self._install_seq.wait_turn(entry.ticket)
        try:
            with self._lock:
                # an older memtable failed before our turn came: skip the
                # install (the data stays readable on the queue and its
                # WAL segments stay on disk, replayed in rotation order)
                self._raise_if_halted_locked()
            t_inst = time.perf_counter_ns()
            edit = VersionEdit()
            if img is not None:
                self._install_ssts(img, level=0, edit=edit)  # files on disk
            with self._lock:
                if img is not None:
                    self._log_edit_locked(edit)
                self.imm.remove(entry)
                self._imm_cv.notify_all()
                self._sample_pressure_locked()
            self._c["flushes"].inc()
            self._c["flush_host_seconds"].add(time.perf_counter() - t0)
            if self.tracer.enabled:
                self.tracer.complete(
                    "flush.install_l0", t_inst,
                    time.perf_counter_ns() - t_inst, args=self._span_args)
            # WAL segments die inside the sequenced region: an older
            # memtable's segments are unlinked before a newer one's, so a
            # crash never leaves old WAL data to replay over newer L0 data
            for p in entry.wal_paths:
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
        except BaseException as e:
            raise self._set_bg_error(e)
        finally:
            self._install_seq.done(entry.ticket)
        if self.cfg.auto_compact:
            self._schedule_compaction()

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def _mems_locked(self) -> tuple:
        """The memtables newest first: the active one, then the immutable
        queue from newest to oldest."""
        return (self.mem,) + tuple(e.table for e in reversed(self.imm))

    def snapshot(self) -> Snapshot:
        """Capture a pinned read view (pass as ``ReadOptions.snapshot``)."""
        with self._lock:
            return Snapshot(mems=self._mems_locked(),
                            version=self.versions.current)

    def _read(self, opts: ReadOptions, read):
        """``read(mems, version)`` on the snapshot's view or the latest one
        (taken once, under the lock; the search runs outside it).  A file
        compacted away under the latest view (a background worker installs
        while the caller reads) is retried on a fresh one; under a pinned
        snapshot it is gone for good and re-raises."""
        err = None
        for _ in range(8):
            if opts.snapshot is not None:
                mems, version = opts.snapshot.mems, opts.snapshot.version
            else:
                with self._lock:
                    mems, version = self._mems_locked(), \
                        self.versions.current
            try:
                return read(mems, version)
            except FileNotFoundError as e:
                if opts.snapshot is not None:
                    raise
                err = e
        raise err

    def get(self, key: bytes, opts: ReadOptions | None = None
            ) -> bytes | None:
        """The value, or None if absent or deleted."""
        t0 = time.perf_counter_ns()
        opts = opts or DEFAULT_READ_OPTIONS

        def read(mems, version):
            for m in mems:
                found, value = m.get(key)
                if found:
                    return value
            return self._search_version(version, key, opts)

        try:
            return self._read(opts, read)
        finally:
            # reads take no store lock: the registry counter is atomic
            self._c["gets"].inc()
            self._h_get.pend((time.perf_counter_ns() - t0) / 1000.0)

    def multi_get(self, keys, opts: ReadOptions | None = None
                  ) -> list[bytes | None]:
        """Batched ``get``: the keys not in a memtable resolve in
        rank-ordered waves of one stacked bloom prune and one stacked
        search and gather each (``lsm.read``).  Returns the values in
        order, equal to ``[self.get(k, opts) for k in keys]``."""
        keys = list(keys)
        opts = opts or DEFAULT_READ_OPTIONS
        t0 = time.perf_counter_ns()
        try:
            return self._read(opts, lambda mems, version:
                              self._multi_get_inner(keys, opts, mems,
                                                    version))
        finally:
            self._c["multi_gets"].inc()
            self._c["multi_get_keys"].inc(len(keys))
            dt = time.perf_counter_ns() - t0
            self._h_multi_get.pend(dt / 1000.0)
            tr = self.tracer
            if tr.enabled:
                tr.complete("db.multi_get", t0, dt,
                            args={"n_keys": len(keys),
                                  **(self._span_args or {})})

    def _multi_get_inner(self, keys: list, opts: ReadOptions, mems,
                         version) -> list[bytes | None]:
        out: list[bytes | None] = [None] * len(keys)
        unresolved: list[tuple[int, bytes]] = []
        for i, key in enumerate(keys):
            for m in mems:
                found, value = m.get(key)
                if found:
                    out[i] = value
                    break
            else:
                unresolved.append((i, key))
        cands = lsm_read.version_candidates(version, unresolved, self.cache)
        resolved = lsm_read.resolve_candidates(
            cands, self.geom, opts, self.device, counters=self._c,
            tracer=self.tracer, span_args=self._span_args)
        for slot, (_, value) in resolved.items():
            out[slot] = value
        return out

    def _search_version(self, version, key: bytes, opts: ReadOptions):
        # L0: overlapping files, newest first
        for fm in sorted(version.levels[0], key=lambda f: -f.file_no):
            if fm.smallest <= key <= fm.largest:
                found, value = self._table_get(fm, key, opts)
                if found:
                    return value
        # deeper levels: disjoint ranges
        for level in range(1, len(version.levels)):
            for fm in version.levels[level]:
                if fm.smallest <= key <= fm.largest:
                    found, value = self._table_get(fm, key, opts)
                    if found:
                        return value
                    break
        return None

    def _table_get(self, fm: FileMeta, key: bytes, opts: ReadOptions):
        found, value, pruned = self.cache.reader(fm).probe(key, opts)
        if pruned:
            self._c["bloom_negative_skips"].inc()
        return found, value

    def scan(self, start: bytes, end: bytes,
             opts: ReadOptions | None = None):
        """[(key, value)] for start <= key < end: newest versions, no
        tombstones."""
        opts = opts or DEFAULT_READ_OPTIONS

        def read(mems, version):
            with self._lock:
                # the active table takes puts meanwhile: copy it under
                # the lock (the immutable ones are frozen)
                active = mems[0].sorted_entries()
            best: dict[bytes, tuple[int, bytes | None]] = {}
            # oldest first: newer seqs win
            for entries in [m.sorted_entries() for m in reversed(mems[1:])
                            ] + [active]:
                for k, seq, v in entries:
                    if start <= k < end and (k not in best or
                                             best[k][0] < seq):
                        best[k] = (seq, v)
            for _, fm in version.all_files():
                if fm.largest < start or fm.smallest >= end:
                    continue
                for k, seq, v in self.cache.reader(fm).scan(start, end,
                                                            opts):
                    if k not in best or best[k][0] < seq:
                        best[k] = (seq, v)
            return [(k, v) for k, (_, v) in sorted(best.items())
                    if v is not None]

        return self._read(opts, read)

    # ------------------------------------------------------------------
    # flush + compaction
    # ------------------------------------------------------------------

    def _pack_entries(self, entries):
        keys = np.stack([formats.pack_key_bytes(k, self.geom.key_bytes)
                         for k, _, _ in entries])
        meta = np.array([formats.make_meta(s, v is not None)
                         for _, s, v in entries], np.uint32)
        vals = np.stack([formats.pack_value_bytes(v or b"",
                                                  self.geom.value_bytes)
                         for _, _, v in entries])
        return keys, meta, vals

    def flush(self):
        """Persist the memtable as L0 SST(s) and start a fresh WAL.  In
        async mode: rotate it and wait until the flush queue drains."""
        if self._async:
            with self._lock:
                self._check_open_locked()
                if len(self.mem):
                    self._rotate_locked()
            self._flush_exec.wait_idle()
            return
        with self._lock:
            self._check_open_locked()
            if len(self.mem) == 0:
                return
            t0 = time.perf_counter()
            with self.tracer.span("flush.sync", **(self._span_args or {})):
                faults.fire("flush.build")
                keys, meta, vals = self._pack_entries(
                    self.mem.sorted_entries())
                img = self.engine.build_image(keys, meta, vals)
                self._install_ssts(img, level=0)
                self.mem = memtable.MemTable()
                self._wal.close()
                for p in self._extra_wals + [self._wal_path]:
                    try:
                        os.remove(p)
                    except FileNotFoundError:
                        pass
                self._extra_wals = []
                self._wal = wal.WALWriter(self._wal_path,
                                          sync=self._wal_sync)
            self._c["flushes"].inc()
            self._c["flush_host_seconds"].add(time.perf_counter() - t0)
            self._sample_pressure_locked()

    def _install_ssts(self, img: SSTImage, level: int,
                      edit: VersionEdit | None = None) -> list[FileMeta]:
        """Split a (possibly multi-SST) image into files of at most
        ``blocks_per_sst`` live blocks and install them; when ``edit`` is
        given the caller logs it.  The file writes run outside the
        store's lock (only the file numbers and the edit's log take it),
        so a background install does not hold up puts and gets."""
        img = sstable.trim_image(img)
        live_blocks = max(1, int((img.nvalid > 0).sum()))
        bps = self.geom.blocks_per_sst
        own_edit = edit is None
        edit = edit or VersionEdit()
        metas = []
        per_block_bloom = img.bloom.shape[0] == img.keys.shape[0]
        for start in range(0, live_blocks, bps):
            stop = min(start + bps, live_blocks)
            sub = SSTImage(
                keys=img.keys[start:stop], meta=img.meta[start:stop],
                vals=img.vals[start:stop], shared=img.shared[start:stop],
                nvalid=img.nvalid[start:stop], crc=img.crc[start:stop],
                bloom=img.bloom[start:stop] if per_block_bloom
                else img.bloom)
            with self._lock:
                no = self.versions.new_file_no()
            fm = sstable.write_sst(os.path.join(self.path, f"{no:06d}.sst"),
                                   sub, no)
            edit.added.append((level, fm))
            metas.append(fm)
        if own_edit:
            with self._lock:
                self._log_edit_locked(edit)
        return metas

    def _log_edit_locked(self, edit: VersionEdit):
        """Stamp the counters and make the edit durable (the files it
        names are already on disk)."""
        edit.last_seq = self.versions.last_seq
        edit.next_file_no = self.versions.next_file_no
        self.versions.log_and_apply(edit)

    def _schedule_compaction(self):
        """Hand compaction work to the sink, or start the background drain
        (at most one in flight)."""
        if self._compaction_sink is not None:
            self._compaction_sink(self)
            return
        with self._lock:
            if self._compact_scheduled or self._closed:
                return
            self._compact_scheduled = True
        try:
            self._compact_exec.submit(self._background_compact)
        except BaseException:
            with self._lock:
                self._compact_scheduled = False
            raise

    def _background_compact(self):
        """The compaction worker's drain: run jobs until none is due (one
        a wake-up in ``paper_faithful`` mode).  A transient failure of a
        job is retried with backoff; one that outlasts the retries, or a
        hard one, halts the pipeline, as a flush's does."""
        try:
            while True:
                with self._lock:
                    job = self.scheduler.pick(self.versions.current)
                    if job is None:
                        self._compact_scheduled = False
                        return
                faults.with_retries(
                    lambda: self.compact_job(job),
                    retries=self.cfg.bg_max_retries,
                    base_s=self.cfg.bg_retry_base_s,
                    on_retry=self._c["bg_retries"].inc)
                if self.cfg.scheduler.paper_faithful:
                    # the paper's artifact (§IV-C): at most one job a
                    # flush -- do not drain the scheduler
                    with self._lock:
                        self._compact_scheduled = False
                    return
        except BaseException as e:
            with self._lock:
                self._compact_scheduled = False
            raise self._set_bg_error(e, op="compact")

    def maybe_compact(self):
        """Run compactions until no level is over its trigger (at most 16
        jobs; one in ``paper_faithful`` mode).  With a compaction sink,
        hand the store to the sink instead (its owner runs them); in async
        mode, wake the compaction worker (``wait_idle`` waits for it)."""
        if self._compaction_sink is not None or self._async:
            # a foreground compaction would race the sink's owner or the
            # worker on the same job: go through the one drain
            self._schedule_compaction()
            return
        if self.cfg.scheduler.paper_faithful:
            self.compact_once()
            return
        for _ in range(16):
            if not self.compact_once():
                return

    def compact_once(self) -> bool:
        """Run the next compaction job, if one is due.  With a compaction
        sink or in async mode, hand the work on when one is due (without
        picking it: a pick moves the round-robin pointer) and return
        whether one is."""
        hand_on = self._compaction_sink is not None or self._async
        with self._lock:
            self._check_open_locked()
            v = self.versions.current
            if hand_on:
                pending = any(self.scheduler.score(v, lvl) >= 1.0
                              for lvl in range(len(v.levels) - 1))
            else:
                job = self.scheduler.pick(v)
        if hand_on:
            if pending:
                self._schedule_compaction()
            return pending
        if job is None:
            return False
        self.compact_job(job)
        return True

    def pick_compaction(self) -> CompactionJob | None:
        """Pick the next compaction job (advances the round-robin pointer).
        A compaction sink's owner pairs this with ``apply_trivial_move`` /
        ``apply_compaction``."""
        with self._lock, \
                self.tracer.span("compact.pick", **(self._span_args or {})):
            return self.scheduler.pick(self.versions.current)

    def _pointer_edit_locked(self, level: int):
        ptr = self.scheduler.compact_pointer.get(level)
        return (level, ptr.hex()) if ptr is not None else None

    @staticmethod
    def is_trivial_move(job: CompactionJob) -> bool:
        # single input, nothing overlapping below
        return len(job.inputs_lo) == 1 and not job.inputs_hi and job.level > 0

    def apply_trivial_move(self, job: CompactionJob):
        """Move a trivial job's one file down a level (metadata only)."""
        fm = job.inputs_lo[0]
        with self._lock, \
                self.tracer.span("compact.trivial_move", level=job.level,
                                 **(self._span_args or {})):
            self.versions.log_and_apply(VersionEdit(
                added=[(job.level + 1, fm)],
                deleted=[(job.level, fm.file_no)],
                compact_pointer=self._pointer_edit_locked(job.level)))
            self._sample_pressure_locked()
        self._c["trivial_moves"].inc()

    def compact_job(self, job: CompactionJob):
        if self.is_trivial_move(job):
            self.apply_trivial_move(job)
            return
        paths = [f.path for f in job.all_inputs]
        with self.tracer.span("compact.job", level=job.level,
                              inputs=len(paths), **(self._span_args or {})):
            t0 = time.perf_counter()
            out, es = self.engine.compact_paths(
                paths, bottom_level=job.bottom_level)
            self._c["compact_wall_seconds"].add(time.perf_counter() - t0)
            self.apply_compaction(job, out, es)

    def apply_compaction(self, job: CompactionJob, out: SSTImage,
                         es: EngineStats):
        """Install a compaction result: verify the CRC verdict, write the
        outputs at ``level+1`` (outside the lock), log one edit bundling
        them with the input deletions, then drop the inputs."""
        if not es.crc_ok:
            # a corrupt input must leave the store exactly as it was
            raise IOError("compaction input failed CRC verification; "
                          "inputs retained")
        faults.fire("compact.install")
        edit = VersionEdit(
            deleted=[(job.level, f.file_no) for f in job.inputs_lo] +
                    [(job.level + 1, f.file_no) for f in job.inputs_hi])
        with self.tracer.span("compact.install", level=job.level,
                              **(self._span_args or {})):
            self._install_ssts(out, level=job.level + 1, edit=edit)
            with self._lock:
                # the job's picker is the only thread that moves this
                # pointer
                edit.compact_pointer = self._pointer_edit_locked(job.level)
                self._log_edit_locked(edit)
                for f in job.all_inputs:
                    self.cache.drop(f.file_no)
                self.compactions.append(CompactionRecord(
                    level=job.level, inputs=len(job.all_inputs), stats=es))
                self._sample_pressure_locked()
        c = self._c
        c["compactions"].inc()
        c["compact_bytes_in"].inc(es.bytes_in)
        c["compact_bytes_out"].inc(es.bytes_out)
        c["compact_entries_in"].inc(es.n_input)
        c["compact_entries_dropped"].inc(es.n_dropped)
        c["compact_host_seconds"].add(es.host_seconds)
        c["compact_device_seconds"].add(es.device_seconds)
        c["compact_sort_seconds"].add(es.sort_seconds)
        if es.batched:
            c["batched_compactions"].inc()
        # engine_fallbacks stays 0: no engine of the port falls back
        for f in job.all_inputs:
            try:
                os.remove(f.path)
            except FileNotFoundError:
                pass

    # ------------------------------------------------------------------

    def wait_idle(self, timeout: float | None = None):
        """Barrier (async mode): block until every queued flush and
        compaction has completed.  Re-raises a background error; raises
        ``TimeoutError`` when ``timeout`` seconds pass first.  A sync
        store has nothing in the background and returns at once."""
        if not self._async:
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        execs = [e for e in (self._flush_exec, self._compact_exec)
                 if e is not None]
        while True:
            for ex in execs:
                if not ex.wait_idle(timeout=remaining(deadline)):
                    raise TimeoutError(f"background work still running "
                                       f"after {timeout} s")
            with self._lock:
                if not self.imm and not self._compact_scheduled:
                    return
                if self.imm and self._flush_exec.pending == 0:
                    # a flush failed earlier (its error was raised once):
                    # the queued tables will not drain until resume()
                    self._raise_if_halted_locked()
                    raise IOError(
                        "immutable memtables not draining; an earlier "
                        "background flush failed (the data stays readable "
                        "from the queued memtables; call resume() to "
                        "retry the flush)")

    def close(self):
        """Wait for the background work (async mode), then close the WAL
        and manifest (the memtables stay in the WAL and are replayed on
        reopen), and the engine unless it was given to the store.
        Re-raises a background error after closing.  A second close is a
        no-op."""
        # claim the close under the lock: a concurrent or second close is
        # a no-op, and every later put fails cleanly
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.wait_idle()
        finally:
            if self._async:
                self._flush_exec.shutdown(wait=False)
                if self._compact_exec is not None:
                    self._compact_exec.shutdown(wait=False)
            if self._owns_engine:
                self.engine.close()
            with self._lock:
                self._wal.flush()
                self._wal.close()
                self.versions.close()

    def level_sizes(self) -> list[int]:
        with self._lock:
            return [len(files) for files in self.versions.current.levels]
