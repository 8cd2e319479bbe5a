"""Write-ahead log: per-record CRC-32, replayable after crash.

Scalar record layout (little-endian):
  u32 crc   -- crc32 of everything after this field
  u8  kind  -- 1 put, 0 delete
  u32 seq
  u16 klen | key bytes
  u32 vlen | value bytes (empty for delete)

Batch record (``kind == BATCH``): ONE CRC-framed record carrying a whole
``write_batch`` -- the atomicity unit of the store's group-write path.
A torn or corrupt batch record is discarded wholesale by replay, so a
crash mid-batch is all-or-nothing (see docs/serving.md):

  u32 crc
  u8  kind  -- 2 batch
  u32 seq   -- sequence number of the FIRST op; op i gets seq + i
  u8  version  -- batch body format version (currently 1)
  u32 count    -- number of ops
  count x ( u8 op_kind | u16 klen | key | u32 vlen | value )

The version byte makes the framing forward-evolvable: replay of an
unknown version raises instead of silently mis-parsing (an old binary
must not "recover" garbage from a newer store's log).

With ``sync=True`` every append is flushed + fsynced before the put is
acknowledged, and the log's *name* is made durable by fsyncing the
parent directory at creation -- the discipline the crash-consistency
matrix relies on.  A per-append ``sync=`` argument overrides the writer
default in either direction (``WriteOptions.sync`` comes through here).
Failpoints: ``wal.append`` (a torn record), ``wal.fsync`` (death before
the fsync).  (The port of ``repro.lsm.wal``; same bytes on disk.)
"""

from __future__ import annotations

import binascii
import os
import struct
from typing import Iterator

from repro_torch.lsm import faults
from repro_torch.lsm.fs import fsync_dir

PUT, DELETE, BATCH = 1, 0, 2

#: Current batch-record body version (bump when the per-op framing changes).
BATCH_VERSION = 1


def _pack_op(kind: int, key: bytes, value: bytes) -> bytes:
    return (struct.pack("<B", kind) +
            struct.pack("<H", len(key)) + key +
            struct.pack("<I", len(value)) + value)


class WALWriter:
    def __init__(self, path: str, sync: bool = False):
        self.path = path
        self._f = open(path, "ab")
        self._sync = sync
        if sync:
            # the created file's directory entry must survive a crash too
            fsync_dir(os.path.dirname(path) or ".")

    def append(self, kind: int, seq: int, key: bytes, value: bytes = b"",
               *, sync: bool | None = None):
        body = struct.pack("<BI", kind, seq)
        body += struct.pack("<H", len(key)) + key
        body += struct.pack("<I", len(value)) + value
        self._emit(body, sync)

    def append_batch(self, ops, first_seq: int, *,
                     sync: bool | None = None) -> int:
        """Append a whole batch as ONE CRC-framed record.

        ``ops``: sequence of ``(op_kind, key, value)`` with ``op_kind``
        ``PUT`` or ``DELETE`` (value must be ``b""`` for deletes).  Op
        ``i`` replays with sequence ``first_seq + i``.  Returns the
        number of ops framed."""
        ops = list(ops)
        # the parts are joined once: growing one bytes object op by op
        # copies the whole body at every op (quadratic in the batch)
        parts = [struct.pack("<BI", BATCH, first_seq),
                 struct.pack("<BI", BATCH_VERSION, len(ops))]
        parts += [_pack_op(kind, key, value) for kind, key, value in ops]
        self._emit(b"".join(parts), sync)
        return len(ops)

    def _emit(self, body: bytes, sync: bool | None):
        rec = struct.pack("<I", binascii.crc32(body) & 0xFFFFFFFF) + body
        framed = struct.pack("<I", len(rec)) + rec
        if faults.fire("wal.append") is faults.TORN:
            self._f.write(framed[: max(1, len(framed) // 2)])
            self._f.flush()
            raise faults.SimulatedCrash("wal.append")
        self._f.write(framed)
        if self._sync if sync is None else sync:
            self._f.flush()
            faults.fire("wal.fsync")
            os.fsync(self._f.fileno())

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def valid_prefix(path: str) -> int:
    """Byte length of the longest valid record prefix of the log.

    Everything past this offset is a torn or corrupt tail; repair
    truncates the file here so later appends cannot resurrect garbage.
    """
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + 4 <= len(data):
        (rec_len,) = struct.unpack_from("<I", data, off)
        if off + 4 + rec_len > len(data):
            break  # torn tail
        rec = data[off + 4: off + 4 + rec_len]
        (crc,) = struct.unpack_from("<I", rec, 0)
        if binascii.crc32(rec[4:]) & 0xFFFFFFFF != crc:
            break  # corrupt tail
        off += 4 + rec_len
    return off


def _iter_batch(body: bytes, first_seq: int
                ) -> Iterator[tuple[int, int, bytes, bytes]]:
    """Expand a CRC-verified batch body into its per-op records."""
    version, count = struct.unpack_from("<BI", body, 5)
    if version != BATCH_VERSION:
        raise IOError(
            f"unsupported WAL batch record version {version} "
            f"(this build reads version {BATCH_VERSION}); refusing to "
            "guess at the framing")
    off = 10
    for i in range(count):
        (kind,) = struct.unpack_from("<B", body, off)
        (klen,) = struct.unpack_from("<H", body, off + 1)
        key = body[off + 3: off + 3 + klen]
        (vlen,) = struct.unpack_from("<I", body, off + 3 + klen)
        value = body[off + 7 + klen: off + 7 + klen + vlen]
        off += 7 + klen + vlen
        yield kind, first_seq + i, key, value


def replay(path: str) -> Iterator[tuple[int, int, bytes, bytes]]:
    """Yield (kind, seq, key, value); stops cleanly at a torn/corrupt tail
    (crash semantics: a partially-written last record is discarded).

    Batch records expand to their per-op entries -- the record-level CRC
    already guaranteed the whole batch is present, so expansion never
    yields a partial batch."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + 4 <= len(data):
        (rec_len,) = struct.unpack_from("<I", data, off)
        if off + 4 + rec_len > len(data):
            return  # torn tail
        rec = data[off + 4: off + 4 + rec_len]
        off += 4 + rec_len
        (crc,) = struct.unpack_from("<I", rec, 0)
        body = rec[4:]
        if binascii.crc32(body) & 0xFFFFFFFF != crc:
            return  # corrupt tail
        kind, seq = struct.unpack_from("<BI", body, 0)
        if kind == BATCH:
            yield from _iter_batch(body, seq)
            continue
        (klen,) = struct.unpack_from("<H", body, 5)
        key = body[7:7 + klen]
        (vlen,) = struct.unpack_from("<I", body, 7 + klen)
        value = body[11 + klen: 11 + klen + vlen]
        yield kind, seq, key, value
