"""The LSM store over the port's compaction engine (the port of
``repro.lsm``): memtable + WAL + leveled SST files + manifest, with every
flush and compaction running through ``engine.TorchCompactionEngine``.

Read options mirror ``repro.lsm.ReadOptions`` for the parts this store
has (no snapshots and no kernel backend choice yet).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ReadOptions:
    """* ``fill_cache`` -- insert blocks decoded for this read into the
      host block cache (results are identical either way).
    * ``verify_crc`` -- re-verify the per-block CRC when a block is
      decoded (the whole-file checksum is always verified at load)."""

    fill_cache: bool = True
    verify_crc: bool = False


#: Default options singleton (avoids per-get allocation on the hot path).
DEFAULT_READ_OPTIONS = ReadOptions()
