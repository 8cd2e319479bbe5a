"""In-memory write buffer.  Newest write per key wins; tombstones are
explicit entries so they shadow older SST data until compacted away.
(A copy of ``repro.lsm.memtable``.)

The async write path splits the buffer into one *active* table (taking
writes) and a queue of *immutable* tables waiting for their background
flush; ``ImmutableMemTable`` ties a frozen table to the WAL segments that
made it durable (deleted only after its SST lands) and to its install
ticket (L0 installs happen in rotation order)."""

from __future__ import annotations

import dataclasses


class MemTable:
    def __init__(self):
        self._d: dict[bytes, tuple[int, bytes | None]] = {}
        self._bytes = 0

    def put(self, key: bytes, seq: int, value: bytes):
        self._account(key, value)
        self._d[key] = (seq, value)

    def delete(self, key: bytes, seq: int):
        self._account(key, b"")
        self._d[key] = (seq, None)

    def _account(self, key: bytes, value: bytes | None):
        old = self._d.get(key)
        if old is not None:
            self._bytes -= len(key) + len(old[1] or b"")
        self._bytes += len(key) + len(value or b"")

    def get(self, key: bytes):
        """Returns (found, value_or_None). found=True with value=None means
        a tombstone shadows the key."""
        hit = self._d.get(key)
        if hit is None:
            return False, None
        return True, hit[1]

    def __len__(self):
        return len(self._d)

    @property
    def approx_bytes(self) -> int:
        return self._bytes

    def sorted_entries(self):
        """[(key, seq, value|None)] in key order (unique keys)."""
        return [(k, s, v) for k, (s, v) in sorted(self._d.items())]



@dataclasses.dataclass
class ImmutableMemTable:
    """A rotated-out memtable queued for its background flush."""
    table: MemTable
    wal_paths: list[str]
    ticket: int
