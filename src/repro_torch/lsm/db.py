"""The LSM key-value store over the port's compaction engine (the port of
``repro.lsm.db``, synchronous mode).

    put() -> WAL append -> memtable
                |  (memtable full)
                v
        flush: the engine builds the L0 image on the device, then the
        compaction cascade runs inline (``maybe_compact``)

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
``apply_compaction`` while the caller writes.  One ``RLock`` guards the
memtable, the version set and manifest, the scheduler's pointers, the
file numbers and the installs; reads take the memtable and
``versions.current`` once under it and search outside it.  Not here yet:
async mode, failpoints, repair, metrics and tracing.
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
from repro_torch.core.formats import SSTGeometry, SSTImage
from repro_torch.core.scheduler import (CompactionJob, CompactionScheduler,
                                        SchedulerConfig)
from repro_torch.lsm import DEFAULT_READ_OPTIONS, ReadOptions, memtable, \
    sstable, wal
from repro_torch.lsm import read as lsm_read
from repro_torch.device import resolve_device
from repro_torch.lsm.cpu_engine import CpuCompactionEngine
from repro_torch.lsm.engine import EngineStats, TorchCompactionEngine
from repro_torch.lsm.sstable import BlockCache, FileMeta, TableCache
from repro_torch.lsm.version import VersionEdit, VersionSet


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
    auto_compact: bool = True


@dataclasses.dataclass
class DBStats:
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
    compact_device_seconds: float = 0.0   # CUDA events (0.0 on the CPU)
    compact_sort_seconds: float = 0.0     # phase-2 share of the above
    flush_host_seconds: float = 0.0
    bloom_negative_skips: int = 0
    orphans_removed: int = 0

    def add(self, other: "DBStats") -> "DBStats":
        """Field-wise sum (aggregation across shards)."""
        return DBStats(**{f.name: getattr(self, f.name) +
                          getattr(other, f.name)
                          for f in dataclasses.fields(DBStats)})


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Pinned read view from ``LsmDB.snapshot()``: the SST version and the
    memtable as of capture.  The memtable is held by reference, so it
    stays live until it is flushed; files compacted away while the
    snapshot is held raise ``FileNotFoundError`` on access."""

    mems: tuple          # newest first (this store has one memtable)
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
    baseline, which touches no device."""
    if cfg.engine == "device":
        return TorchCompactionEngine(cfg.geom, device=device,
                                     sort_mode=cfg.sort_mode)
    if cfg.engine == "cpu":
        return CpuCompactionEngine(cfg.geom, threads=cfg.threads)
    raise ValueError(f"unknown engine {cfg.engine!r}")


class LsmDB:
    def __init__(self, path: str, cfg: DBConfig | None = None, *,
                 device=None, engine=None, compaction_sink=None):
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
        """
        self.path = path
        self.cfg = cfg or DBConfig()
        self.geom = self.cfg.geom
        self._device = resolve_device(device)
        self._owns_engine = engine is None
        self._compaction_sink = compaction_sink
        self.engine = (engine if engine is not None
                       else make_engine(self.cfg, self._device))
        os.makedirs(path, exist_ok=True)
        self._lock = threading.RLock()
        self._stats = DBStats()
        self.compactions: list[CompactionRecord] = []  # guarded-by: _lock
        self.versions = VersionSet(path)                # guarded-by: _lock
        self.versions.open()
        self.scheduler = CompactionScheduler(           # guarded-by: _lock
            self.cfg.scheduler)
        self.scheduler.compact_pointer = dict(self.versions.compact_pointer)
        self.block_cache = BlockCache(self.cfg.block_cache_blocks)
        self.cache = TableCache(self.cfg.table_cache, geom=self.geom,
                                block_cache=self.block_cache,
                                device=self._device)
        self.mem = memtable.MemTable()                  # guarded-by: _lock
        self._memtable_limit = self.cfg.memtable_bytes or self.geom.sst_bytes
        self._wal_path = os.path.join(path, "wal.log")
        self._extra_wals: list[str] = []                # guarded-by: _lock
        self._replay_wal_locked()
        self._gc_orphans_locked()
        self._wal = wal.WALWriter(                      # guarded-by: _lock
            self._wal_path, sync=self.cfg.sync_wal)
        self._closed = False                            # guarded-by: _lock

    @property
    def device(self):
        return self._device

    @property
    def stats(self) -> DBStats:
        """Point-in-time copy of the store's counters, as
        ``repro.lsm.db.LsmDB.stats``: two reads give two objects, so their
        difference is what happened in between."""
        return dataclasses.replace(self._stats)

    def _replay_wal_locked(self):
        """Replay rotated WAL segments (an async-mode store leaves them),
        oldest first, then the active WAL.  They stay on disk until the
        recovered memtable flushes."""
        segs = sorted(glob.glob(os.path.join(self.path, "wal-*.log")))
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
                self._stats.orphans_removed += 1

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

    def put(self, key: bytes, value: bytes):
        self._check_key(key)
        self._check_value(value)
        with self._lock:
            self._check_open_locked()
            seq = self._next_seq_locked()
            self._wal.append(wal.PUT, seq, key, value)
            self.mem.put(key, seq, value)
            self._stats.puts += 1
            self._maybe_flush_locked()

    def delete(self, key: bytes):
        self._check_key(key)
        with self._lock:
            self._check_open_locked()
            seq = self._next_seq_locked()
            self._wal.append(wal.DELETE, seq, key)
            self.mem.delete(key, seq)
            self._stats.deletes += 1
            self._maybe_flush_locked()

    def write_batch(self, ops) -> int:
        """Apply ``("put", key, value)`` / ``("delete", key)`` ops in order
        as ONE CRC-framed WAL record: replay after a crash recovers every
        op or none.  Returns the number of ops applied."""
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
        with self._lock:
            self._check_open_locked()
            first_seq = self.versions.last_seq + 1
            self.versions.last_seq += len(rows)
            self._wal.append_batch(rows, first_seq)
            for i, (kind, key, value) in enumerate(rows):
                if kind == wal.PUT:
                    self.mem.put(key, first_seq + i, value)
                else:
                    self.mem.delete(key, first_seq + i)
            self._stats.write_batches += 1
            self._stats.batch_ops += len(rows)
            self._maybe_flush_locked()
        return len(rows)

    def _maybe_flush_locked(self):
        if self.mem.approx_bytes < self._memtable_limit:
            return
        self.flush()
        if self.cfg.auto_compact:
            self.maybe_compact()

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def snapshot(self) -> Snapshot:
        """Capture a pinned read view (pass as ``ReadOptions.snapshot``)."""
        with self._lock:
            return Snapshot(mems=(self.mem,), version=self.versions.current)

    def _read(self, opts: ReadOptions, read):
        """``read(mems, version)`` on the snapshot's view or the latest one
        (taken once, under the lock; the search runs outside it).  A file
        compacted away under the latest view (a compaction queue's worker
        installs while the caller reads) is retried on a fresh one; under
        a pinned snapshot it is gone for good and re-raises."""
        err = None
        for _ in range(8):
            if opts.snapshot is not None:
                mems, version = opts.snapshot.mems, opts.snapshot.version
            else:
                with self._lock:
                    mems, version = (self.mem,), self.versions.current
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
        self._stats.gets += 1
        opts = opts or DEFAULT_READ_OPTIONS

        def read(mems, version):
            for m in mems:
                found, value = m.get(key)
                if found:
                    return value
            return self._search_version(version, key, opts)

        return self._read(opts, read)

    def multi_get(self, keys, opts: ReadOptions | None = None
                  ) -> list[bytes | None]:
        """Batched ``get``: the keys not in the memtable resolve in
        rank-ordered waves of one stacked bloom prune and one stacked
        search and gather each (``lsm.read``).  Returns the values in
        order, equal to ``[self.get(k, opts) for k in keys]``."""
        keys = list(keys)
        opts = opts or DEFAULT_READ_OPTIONS
        self._stats.multi_gets += 1
        self._stats.multi_get_keys += len(keys)
        return self._read(opts, lambda mems, version: self._multi_get_inner(
            keys, opts, mems, version))

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
            cands, self.geom, opts, self.device, stats=self._stats)
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
            self._stats.bloom_negative_skips += 1
        return found, value

    def scan(self, start: bytes, end: bytes,
             opts: ReadOptions | None = None):
        """[(key, value)] for start <= key < end: newest versions, no
        tombstones."""
        opts = opts or DEFAULT_READ_OPTIONS

        def read(mems, version):
            best: dict[bytes, tuple[int, bytes | None]] = {}
            for m in reversed(mems):   # oldest first: newer seqs win
                for k, seq, v in m.sorted_entries():
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
        """Persist the memtable as L0 SST(s) and start a fresh WAL."""
        with self._lock:
            self._check_open_locked()
            if len(self.mem) == 0:
                return
            t0 = time.perf_counter()
            keys, meta, vals = self._pack_entries(self.mem.sorted_entries())
            img = self.engine.build_image(keys, meta, vals)
            self._install_ssts_locked(img, level=0)
            self.mem = memtable.MemTable()
            self._wal.close()
            for p in self._extra_wals + [self._wal_path]:
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
            self._extra_wals = []
            self._wal = wal.WALWriter(self._wal_path, sync=self.cfg.sync_wal)
            self._stats.flushes += 1
            self._stats.flush_host_seconds += time.perf_counter() - t0

    def _install_ssts_locked(self, img: SSTImage, level: int,
                             edit: VersionEdit | None = None
                             ) -> list[FileMeta]:
        """Split a (possibly multi-SST) image into files of at most
        ``blocks_per_sst`` live blocks and install them; when ``edit`` is
        given the caller logs it."""
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
            no = self.versions.new_file_no()
            fm = sstable.write_sst(os.path.join(self.path, f"{no:06d}.sst"),
                                   sub, no)
            edit.added.append((level, fm))
            metas.append(fm)
        if own_edit:
            self._log_edit_locked(edit)
        return metas

    def _log_edit_locked(self, edit: VersionEdit):
        """Stamp the counters and make the edit durable (the files it
        names are already on disk)."""
        edit.last_seq = self.versions.last_seq
        edit.next_file_no = self.versions.next_file_no
        self.versions.log_and_apply(edit)

    def maybe_compact(self):
        """Run compactions until no level is over its trigger (at most 16
        jobs; one in ``paper_faithful`` mode).  With a compaction sink,
        hand the store to the sink instead (its owner runs them)."""
        if self._compaction_sink is not None:
            self._compaction_sink(self)
            return
        if self.cfg.scheduler.paper_faithful:
            self.compact_once()
            return
        for _ in range(16):
            if not self.compact_once():
                return

    def compact_once(self) -> bool:
        """Run the next compaction job, if one is due.  With a compaction
        sink, tell the sink when one is due (without picking it: a pick
        moves the round-robin pointer) and return whether one is."""
        with self._lock:
            self._check_open_locked()
            v = self.versions.current
            if self._compaction_sink is not None:
                pending = any(self.scheduler.score(v, lvl) >= 1.0
                              for lvl in range(len(v.levels) - 1))
            else:
                job = self.scheduler.pick(v)
        if self._compaction_sink is not None:
            if pending:
                self._compaction_sink(self)
            return pending
        if job is None:
            return False
        self.compact_job(job)
        return True

    def pick_compaction(self) -> CompactionJob | None:
        """Pick the next compaction job (advances the round-robin pointer).
        A compaction sink's owner pairs this with ``apply_trivial_move`` /
        ``apply_compaction``."""
        with self._lock:
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
        with self._lock:
            self.versions.log_and_apply(VersionEdit(
                added=[(job.level + 1, fm)],
                deleted=[(job.level, fm.file_no)],
                compact_pointer=self._pointer_edit_locked(job.level)))
            self._stats.trivial_moves += 1

    def compact_job(self, job: CompactionJob):
        if self.is_trivial_move(job):
            self.apply_trivial_move(job)
            return
        t0 = time.perf_counter()
        out, es = self.engine.compact_paths(
            [f.path for f in job.all_inputs], bottom_level=job.bottom_level)
        self._stats.compact_wall_seconds += time.perf_counter() - t0
        self.apply_compaction(job, out, es)

    def apply_compaction(self, job: CompactionJob, out: SSTImage,
                         es: EngineStats):
        """Install a compaction result: verify the CRC verdict, install the
        outputs at ``level+1``, log one edit bundling them with the input
        deletions, then drop the inputs."""
        if not es.crc_ok:
            # a corrupt input must leave the store exactly as it was
            raise IOError("compaction input failed CRC verification; "
                          "inputs retained")
        with self._lock:
            edit = VersionEdit(
                deleted=[(job.level, f.file_no) for f in job.inputs_lo] +
                        [(job.level + 1, f.file_no) for f in job.inputs_hi],
                compact_pointer=self._pointer_edit_locked(job.level))
            self._install_ssts_locked(out, level=job.level + 1, edit=edit)
            self._log_edit_locked(edit)
            for f in job.all_inputs:
                self.cache.drop(f.file_no)
            s = self._stats
            s.compactions += 1
            s.batched_compactions += es.batched
            s.compact_bytes_in += es.bytes_in
            s.compact_bytes_out += es.bytes_out
            s.compact_entries_in += es.n_input
            s.compact_entries_dropped += es.n_dropped
            s.compact_host_seconds += es.host_seconds
            s.compact_device_seconds += es.device_seconds
            s.compact_sort_seconds += es.sort_seconds
            self.compactions.append(CompactionRecord(
                level=job.level, inputs=len(job.all_inputs), stats=es))
        for f in job.all_inputs:
            try:
                os.remove(f.path)
            except FileNotFoundError:
                pass

    # ------------------------------------------------------------------

    def close(self):
        """Close the WAL and manifest (the memtable stays in the WAL and
        is replayed on reopen), and the engine unless it was given to the
        store.  A second close is a no-op."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._owns_engine:
                self.engine.close()
            self._wal.flush()
            self._wal.close()
            self.versions.close()

    def level_sizes(self) -> list[int]:
        with self._lock:
            return [len(files) for files in self.versions.current.levels]
