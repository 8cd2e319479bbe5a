"""The LSM store over the port's compaction engine (the port of
``repro.lsm``): memtable + WAL + leveled SST files + manifest, with every
flush and compaction running through ``engine.TorchCompactionEngine``, or
through the numpy baseline ``cpu_engine.CpuCompactionEngine`` where the
store's config names it.

The read surface mirrors ``repro.lsm``: ``LsmDB``, ``ShardedDB`` and
``TableReader`` expose ``get(key, opts=None)``, ``multi_get(keys,
opts=None)`` and ``scan(start, end, opts=None)`` taking the same frozen
``ReadOptions``.  The write surface mirrors it: ``put(key, value,
opts=None)``, ``delete(key, opts=None)`` and the atomic ``write_batch(ops,
opts=None)`` take the same frozen ``WriteOptions`` on both stores.  The
stores, caches, fault types and repair report are importable from here, as
in ``repro.lsm``.
"""

from __future__ import annotations

import dataclasses

#: ``ReadOptions.backend`` values: the batched stages on the store's
#: device (kernels on ``cuda``, their plain versions on ``cpu``), or numpy.
BACKENDS = ("device", "host")


@dataclasses.dataclass(frozen=True)
class ReadOptions:
    """* ``snapshot`` -- a read view from ``LsmDB.snapshot()``: pins the
      SST version and the memtables (the active one and, in async mode,
      the immutable queue) as of capture.  The active memtable captured
      stays live until it rotates; files compacted away while the
      snapshot is held raise ``FileNotFoundError``.  ``None`` reads the
      latest state.
    * ``fill_cache`` -- insert blocks decoded for this read into the
      host block cache (results are identical either way).
    * ``verify_crc`` -- re-verify the per-block CRC when a block is
      decoded (the whole-file checksum is always verified at load).
    * ``backend`` -- where ``multi_get`` runs its batched bloom prune and
      block gather: ``"device"`` on the store's device (the CUDA kernels
      on ``cuda``, their plain PyTorch versions on ``cpu``), or
      ``"host"``, numpy on the host.  Both give the same answers."""

    snapshot: object | None = None
    fill_cache: bool = True
    verify_crc: bool = False
    backend: str = "device"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown read backend {self.backend!r} "
                             f"(want one of {BACKENDS})")


#: Default options singleton (avoids per-get allocation on the hot path).
DEFAULT_READ_OPTIONS = ReadOptions()


@dataclasses.dataclass(frozen=True)
class WriteOptions:
    """Options of every write entry point (``put`` / ``delete`` /
    ``write_batch`` on ``LsmDB`` and ``ShardedDB``).

    * ``sync`` -- a per-call durability override: ``True`` fsyncs this
      record before the write returns even on a store opened with
      ``sync_writes=False``; ``False`` skips the fsync on a synced store;
      ``None`` (the default) follows the store's config.
    * ``wait_stall`` -- when the immutable-memtable queue is full, an
      async-mode write blocks until the flushes drain it.
      ``wait_stall=False`` raises ``IOError`` at once instead (the write
      itself is already in the WAL and the active memtable; only the
      rotation is refused), so a caller can shed load."""

    sync: bool | None = None
    wait_stall: bool = True


#: Default options singleton (avoids per-put allocation on the hot path).
DEFAULT_WRITE_OPTIONS = WriteOptions()


def __getattr__(name):  # lazy: avoids core.scheduler <-> lsm.db cycle
    if name in ("LsmDB", "DBConfig", "DBStats", "Snapshot"):
        from repro_torch.lsm import db
        return getattr(db, name)
    if name in ("ShardedDB", "ShardedSnapshot"):
        from repro_torch.lsm import sharded
        return getattr(sharded, name)
    if name in ("TableReader", "TableCache", "BlockCache"):
        from repro_torch.lsm import sstable
        return getattr(sstable, name)
    if name in ("FaultInjected", "SimulatedCrash", "BackgroundError",
                "FailpointRegistry", "FAILPOINTS"):
        from repro_torch.lsm import faults
        return getattr(faults, name)
    if name in ("repair_sharded", "RepairReport"):
        # the function ``repair`` is not re-exported: the bare name would
        # shadow the submodule
        from repro_torch.lsm import repair as repair_mod
        return getattr(repair_mod, name)
    raise AttributeError(name)
