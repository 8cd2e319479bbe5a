"""Range-sharded store: N independent ``LsmDB`` shards over one engine (the
port of ``repro.lsm.sharded``).

``ShardedDB`` partitions the keyspace with a static boundary table
(persisted in ``SHARDS.json``, JAX's bytes; each shard reopens its own WAL
and manifest, so one shard's crash state never touches a sibling).
``put`` / ``get`` / ``delete`` route to one shard by a binary search of the
boundaries; ``scan`` merges the per-shard results; ``multi_get`` issues one
``LsmDB.multi_get`` a shard hit.

Compaction is shared: every shard gets the one engine and
``compaction_sink=queue.notify`` of one ``GlobalCompactionQueue``.  Each
drain round picks at most one job a shard and hands the round to the
engine's ``compact_many``, which stacks the jobs of one shape signature
from different shards into one batched pipeline on the card (one launch a
merge level for all of them).  Per-job CRC verdicts and per-shard installs
keep each shard's version history what sequential compaction would have
produced.

In async mode (``DBConfig.async_compaction``) every shard rotates its own
memtables onto its own flush workers, and a shard's flush worker hands
the compaction work it leaves to the shared queue through the sink, so
the queue compacts on its worker while the caller writes;
``maybe_compact`` then only publishes work, ``wait_idle`` waits for every
shard's flushes and then the queue, and ``resume`` restarts each halted
shard.

Boundary tables are uniform over the first key byte, or learned from a key
sample (``boundaries_from_sample``: YCSB's ``user%012d`` keys occupy a thin
slice of byte space).  ``put``, ``delete`` and ``write_batch`` take
``WriteOptions``; ``DBConfig.failpoints`` is armed before the boundary
table is written (its failpoint is ``shards.write``, a torn
``SHARDS.json.tmp``), and ``ShardedDB.open(path, cfg, repair=True)`` runs
``lsm.repair.repair_sharded`` first.

One registry (``cfg.metrics``, else a new ``obs.MetricsRegistry``) and
one tracer (``cfg.tracer``, else ``obs.NULL_TRACER``) serve every shard,
the queue and the engine: each shard's series carry ``shard=i``, so they
stay apart while their histograms merge bucket for bucket
(``obs.merge_histograms``); ``stats`` sums the shards' ``DBStats``.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import json
import os
import time

from repro_torch.core.background import GlobalCompactionQueue, remaining
from repro_torch.device import resolve_device
from repro_torch.lsm import ReadOptions, WriteOptions, faults
from repro_torch.lsm.db import DBConfig, DBStats, LsmDB, make_engine
from repro_torch.lsm.fs import fsync_dir
from repro_torch.lsm.engine import TorchCompactionEngine
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER

SHARDS_FILE = "SHARDS.json"


@dataclasses.dataclass(frozen=True)
class ShardedSnapshot:
    """Pinned read view over every shard (``ShardedDB.snapshot()``): one
    per-shard ``Snapshot`` each, captured back to back -- consistent per
    shard, near-simultaneous across shards."""

    shards: tuple   # one lsm.db.Snapshot per shard, in shard order


def boundaries_from_sample(sample_keys, n_shards: int) -> list[bytes]:
    """Learned boundary table: ``n_shards - 1`` split keys at the
    quantiles of a key sample, so each shard receives about the same
    share of a workload distributed like the sample.

    Raises ``ValueError`` when the sample is too small or too
    duplicate-heavy to give distinct split points."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if n_shards == 1:
        return []
    uniq = sorted(set(bytes(k) for k in sample_keys))
    if len(uniq) < n_shards:
        raise ValueError(
            f"sample has {len(uniq)} distinct keys; need >= {n_shards} "
            f"to split into {n_shards} ranges")
    cuts = [uniq[(i * len(uniq)) // n_shards] for i in range(1, n_shards)]
    if len(set(cuts)) != len(cuts):
        raise ValueError("sample quantiles collide; provide a larger or "
                         "less skewed sample")
    return cuts


def uniform_boundaries(n_shards: int) -> list[bytes]:
    """Even split of the single-byte prefix space (for keys uniform in
    byte space, e.g. hashes)."""
    if n_shards > 256:
        raise ValueError("uniform_boundaries supports at most 256 shards")
    return [bytes([(i * 256) // n_shards]) for i in range(1, n_shards)]


class ShardedDB:
    """Range-partitioned store over independent ``LsmDB`` shards with a
    shared, batching compaction backend.

    ``boundaries`` (``n-1`` sorted split keys; shard ``i`` owns
    ``[boundaries[i-1], boundaries[i])``) wins over ``sample_keys`` wins
    over the uniform byte-space split (``shards``, default 4).  On reopen
    the table in ``SHARDS.json`` is authoritative; a *conflicting*
    explicit table raises (re-splitting a live store needs a migration:
    see ``plan_rebalance``).  ``device``: where the shared engine and the
    shards' read stages run; None means ``cuda``, which must be present
    (pass ``device="cpu"`` to run on the CPU)."""

    def __init__(self, path: str, cfg: DBConfig | None = None, *,
                 shards: int | None = None,
                 boundaries: list[bytes] | None = None,
                 sample_keys=None, device=None):
        self.path = path
        self.cfg = cfg or DBConfig()
        self.device = resolve_device(device)
        # armed before the boundary table is written, so that
        # shards.write can fire at creation (the shards install it again)
        if self.cfg.failpoints is not None:
            faults.FAILPOINTS.install(self.cfg.failpoints)
        os.makedirs(path, exist_ok=True)
        self.boundaries = self._load_or_init_boundaries(
            shards, boundaries, sample_keys)
        self.n_shards = len(self.boundaries) + 1
        # one registry and one tracer for the shards, the queue and the
        # engine: a shard's series stay apart by their shard label, and
        # their histograms merge bucket for bucket
        self.metrics = (self.cfg.metrics if self.cfg.metrics is not None
                        else MetricsRegistry())
        self.tracer = (self.cfg.tracer if self.cfg.tracer is not None
                       else NULL_TRACER)
        self.engine = make_engine(self.cfg, self.device)
        self.queue = GlobalCompactionQueue(self.engine, tracer=self.tracer,
                                           metrics=self.metrics)
        self.shards = []
        try:
            for i in range(self.n_shards):
                self.shards.append(LsmDB(
                    os.path.join(path, f"shard-{i:04d}"), self.cfg,
                    device=self.device, engine=self.engine,
                    compaction_sink=self.queue.notify, metrics=self.metrics,
                    tracer=self.tracer, metric_labels={"shard": str(i)}))
        except BaseException:
            # a later shard failed to open: stop what already started
            self.queue.close()
            for s in self.shards:
                try:
                    s.close()
                except Exception:   # noqa: BLE001 - best-effort cleanup
                    pass
            self.engine.close()
            raise
        self._closed = False

    @classmethod
    def open(cls, path: str, cfg: DBConfig | None = None, *,
             repair: bool = False, **kw) -> "ShardedDB":
        """Open a sharded store, with offline repair of every shard's
        directory first when ``repair`` is set (``lsm.repair``).  ``kw``
        goes to the constructor (``boundaries``, ``device``, ...)."""
        resolve_device(kw.get("device"))   # no card: raise before repair
        if repair and os.path.isdir(path):
            from repro_torch.lsm import repair as repair_mod
            repair_mod.repair_sharded(path)
        return cls(path, cfg, **kw)

    def _load_or_init_boundaries(self, shards, boundaries, sample_keys):
        meta_path = os.path.join(self.path, SHARDS_FILE)
        stale_tmp = meta_path + ".tmp"
        if os.path.exists(stale_tmp):
            # left by a crash mid-write; the rename never happened, so the
            # table (or its absence) on disk is authoritative
            os.remove(stale_tmp)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                stored = [bytes.fromhex(h)
                          for h in json.load(f)["boundaries"]]
            if boundaries is not None and list(boundaries) != stored:
                raise ValueError(
                    "explicit boundaries conflict with the persisted "
                    f"table in {meta_path}; rebalancing a live store "
                    "requires a migration (see plan_rebalance)")
            if shards is not None and shards != len(stored) + 1:
                raise ValueError(
                    f"requested shards={shards} but {meta_path} holds a "
                    f"{len(stored) + 1}-shard table; reopen without "
                    "`shards` or migrate (see plan_rebalance)")
            if sample_keys is not None:
                raise ValueError(
                    "sample_keys only applies at store creation; "
                    f"{meta_path} already holds the boundary table "
                    "(re-splitting needs a migration; see plan_rebalance)")
            return stored
        if shards is None:
            shards = 4
        if boundaries is not None:
            cuts = [bytes(b) for b in boundaries]
            if cuts != sorted(set(cuts)):
                raise ValueError("boundaries must be sorted and distinct")
        elif sample_keys is not None:
            cuts = boundaries_from_sample(sample_keys, shards)
        else:
            cuts = uniform_boundaries(shards)
        tmp = meta_path + ".tmp"
        payload = json.dumps({"boundaries": [b.hex() for b in cuts]})
        with open(tmp, "w") as f:
            if faults.fire("shards.write") is faults.TORN:
                # only the .tmp is torn: a reopen derives the table anew
                f.write(payload[: max(1, len(payload) // 2)])
                f.flush()
                raise faults.SimulatedCrash("shards.write")
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, meta_path)   # atomic: a crash leaves old or new
        fsync_dir(self.path)
        return cuts

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def shard_of(self, key: bytes) -> int:
        """Index of the shard owning ``key``."""
        return bisect.bisect_right(self.boundaries, key)

    def _shard_opts(self, opts: ReadOptions | None, i: int
                    ) -> ReadOptions | None:
        """A store-level ``ReadOptions`` narrowed to shard ``i`` (a
        ``ShardedSnapshot`` gives the shard's own pinned view)."""
        if opts is None or not isinstance(opts.snapshot, ShardedSnapshot):
            return opts
        return dataclasses.replace(opts, snapshot=opts.snapshot.shards[i])

    def snapshot(self) -> ShardedSnapshot:
        """A pinned read view across every shard (pass as
        ``ReadOptions.snapshot`` to ``get`` / ``multi_get`` / ``scan``)."""
        return ShardedSnapshot(shards=tuple(s.snapshot()
                                            for s in self.shards))

    def put(self, key: bytes, value: bytes,
            opts: WriteOptions | None = None):
        self.shards[self.shard_of(key)].put(key, value, opts)

    def delete(self, key: bytes, opts: WriteOptions | None = None):
        self.shards[self.shard_of(key)].delete(key, opts)

    def write_batch(self, ops, opts: WriteOptions | None = None) -> int:
        """Apply a group of writes, routed by key: one sub-batch a shard
        (in order within it), each committed atomically by that shard's
        ``LsmDB.write_batch``.  Atomicity is per shard: a crash between two
        shards' commits can land one sub-batch without the other."""
        by_shard: dict[int, list] = {}
        for op in ops:
            if op[0] not in ("put", "delete"):
                raise ValueError(f"unknown batch op {op[0]!r} "
                                 "(want 'put' or 'delete')")
            by_shard.setdefault(self.shard_of(op[1]), []).append(op)
        return sum(self.shards[i].write_batch(sub, opts)
                   for i, sub in sorted(by_shard.items()))

    def get(self, key: bytes, opts: ReadOptions | None = None):
        i = self.shard_of(key)
        return self.shards[i].get(key, self._shard_opts(opts, i))

    def multi_get(self, keys, opts: ReadOptions | None = None
                  ) -> list[bytes | None]:
        """Batched ``get`` across shards: one ``LsmDB.multi_get`` a shard
        hit, results back in input order; equal to ``[self.get(k, opts)
        for k in keys]``."""
        keys = list(keys)
        by_shard: dict[int, list[tuple[int, bytes]]] = {}
        for slot, key in enumerate(keys):
            by_shard.setdefault(self.shard_of(key), []).append((slot, key))
        out: list[bytes | None] = [None] * len(keys)
        for i, slot_keys in sorted(by_shard.items()):
            values = self.shards[i].multi_get(
                [k for _, k in slot_keys], self._shard_opts(opts, i))
            for (slot, _), value in zip(slot_keys, values):
                out[slot] = value
        return out

    def scan(self, start: bytes, end: bytes,
             opts: ReadOptions | None = None):
        """[(key, value)] for start <= key < end across shards, merged
        from the per-shard scans."""
        lo = self.shard_of(start)
        hi = min(self.shard_of(end), self.n_shards - 1)
        parts = [self.shards[i].scan(start, end, self._shard_opts(opts, i))
                 for i in range(lo, hi + 1)]
        return list(heapq.merge(*parts))

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------

    def flush(self):
        for s in self.shards:
            s.flush()

    def maybe_compact(self):
        """Publish every shard with pending work to the shared queue; in
        sync mode also wait until the queue has drained (returns with the
        compactions installed), as ``LsmDB.maybe_compact`` does."""
        for s in self.shards:
            s.compact_once()
        if not self.cfg.async_compaction:
            self.queue.wait_idle()

    def wait_idle(self, timeout: float | None = None):
        """Barrier: every queued flush (async shards), then every
        published compaction, has completed.  Re-raises a background
        error; raises ``TimeoutError`` when ``timeout`` seconds pass
        first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for s in self.shards:
            s.wait_idle(timeout=remaining(deadline))
        self.queue.wait_idle(timeout=remaining(deadline))

    def resume(self) -> bool:
        """Clear the background errors of every shard and re-queue their
        parked work (``LsmDB.resume`` a shard).  One shard's failure does
        not halt its siblings; it stays halted until this is called.
        Returns True if any shard had an error to clear."""
        return any([s.resume() for s in self.shards])

    def close(self):
        if self._closed:
            return
        try:
            self.wait_idle()
        finally:
            self._closed = True
            self.queue.close()
            for s in self.shards:
                try:
                    s.close()
                except Exception:   # noqa: BLE001 - close every shard
                    pass
            self.engine.close()

    # ------------------------------------------------------------------
    # introspection + rebalance
    # ------------------------------------------------------------------

    @property
    def stats(self) -> DBStats:
        """``DBStats`` summed over the shards."""
        agg = DBStats()
        for s in self.shards:
            agg = agg.add(s.stats)
        return agg

    def shard_stats(self) -> list[DBStats]:
        return [s.stats for s in self.shards]

    def level_sizes(self) -> list[list[int]]:
        return [s.level_sizes() for s in self.shards]

    def plan_rebalance(self, sample_keys, n_shards: int | None = None
                       ) -> list[bytes]:
        """The boundary table that would balance a workload distributed
        like ``sample_keys``.  Applying it means a new ``ShardedDB`` with
        these boundaries and a migration (scan old, put new): the static
        table never moves under live traffic."""
        return boundaries_from_sample(sample_keys,
                                      n_shards or self.n_shards)
