"""Leveled version set + manifest log (crash-recoverable metadata).

The manifest is a JSON-lines log of version edits; recovery replays it.
Mirrors LevelDB's VersionSet at the fidelity this system needs: immutable
per-level file lists, atomic apply of {add, delete} edits, persistent
``last_seq`` / ``next_file_no`` counters, and compaction pointers for
round-robin file picking.  Failpoint: ``manifest.append`` (a torn
record).  ``write_manifest_snapshot`` is repair's atomic rewrite.  (The
port of ``repro.lsm.version``; same manifest format.)
"""

from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.lsm import faults
from repro_torch.lsm.fs import fsync_dir
from repro_torch.lsm.sstable import FileMeta

NUM_LEVELS = 7


@dataclasses.dataclass
class VersionEdit:
    added: list[tuple[int, FileMeta]] = dataclasses.field(default_factory=list)
    deleted: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    last_seq: int | None = None
    next_file_no: int | None = None
    compact_pointer: tuple[int, str] | None = None  # (level, key hex)


class Version:
    """Immutable snapshot of the level structure."""

    def __init__(self, levels: list[list[FileMeta]] | None = None):
        self.levels: list[list[FileMeta]] = levels or \
            [[] for _ in range(NUM_LEVELS)]

    def clone(self) -> "Version":
        return Version([list(files) for files in self.levels])

    def level_bytes(self, level: int) -> int:
        return sum(f.size_bytes for f in self.levels[level])

    def overlapping(self, level: int, smallest: bytes, largest: bytes
                    ) -> list[FileMeta]:
        out = []
        for f in self.levels[level]:
            if f.largest >= smallest and f.smallest <= largest:
                out.append(f)
        return out

    def all_files(self):
        for level, files in enumerate(self.levels):
            for f in files:
                yield level, f


class VersionSet:
    def __init__(self, db_dir: str):
        self.db_dir = db_dir
        self.manifest_path = os.path.join(db_dir, "MANIFEST")
        self.current = Version()
        self.last_seq = 0
        self.next_file_no = 1
        self.compact_pointer: dict[int, bytes] = {}
        self._manifest = None

    # -- persistence ------------------------------------------------------

    def open(self):
        existed = os.path.exists(self.manifest_path)
        if existed:
            self._recover()
        self._manifest = open(self.manifest_path, "a")
        if not existed:
            # a crash right after creation must not lose the manifest name
            fsync_dir(self.db_dir)

    def _recover(self):
        with open(self.manifest_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail
                self._apply_record(rec)
        # A torn tail can drop the trailing "meta" record of an edit whose
        # "add" records survived: never hand out a file number that an
        # already-recovered file is using.
        for _, fm in self.current.all_files():
            self.next_file_no = max(self.next_file_no, fm.file_no + 1)

    def _apply_record(self, rec, version: Version | None = None):
        v = version if version is not None else self.current
        kind = rec["op"]
        if kind == "add":
            v.levels[rec["level"]].append(
                FileMeta.from_json(rec["file"]))
            v.levels[rec["level"]].sort(
                key=lambda f: (f.smallest, f.file_no))
        elif kind == "del":
            lvl = v.levels[rec["level"]]
            v.levels[rec["level"]] = \
                [f for f in lvl if f.file_no != rec["file_no"]]
        elif kind == "meta":
            self.last_seq = max(self.last_seq, rec.get("last_seq", 0))
            self.next_file_no = max(self.next_file_no,
                                    rec.get("next_file_no", 1))
        elif kind == "ptr":
            self.compact_pointer[rec["level"]] = bytes.fromhex(rec["key"])

    def log_and_apply(self, edit: VersionEdit):
        """Write the edit to the manifest, then mutate the current version
        (write-ahead ordering: metadata survives a crash mid-apply)."""
        recs = []
        for level, fm in edit.added:
            recs.append(dict(op="add", level=level, file=fm.to_json()))
        for level, file_no in edit.deleted:
            recs.append(dict(op="del", level=level, file_no=file_no))
        if edit.last_seq is not None or edit.next_file_no is not None:
            recs.append(dict(op="meta", last_seq=edit.last_seq or
                             self.last_seq,
                             next_file_no=edit.next_file_no or
                             self.next_file_no))
        if edit.compact_pointer is not None:
            recs.append(dict(op="ptr", level=edit.compact_pointer[0],
                             key=edit.compact_pointer[1]))
        payload = "".join(json.dumps(rec) + "\n" for rec in recs)
        if faults.fire("manifest.append") is faults.TORN:
            # torn mid-record: recovery discards the tail
            self._manifest.write(payload[: max(1, len(payload) - 7)])
            self._manifest.flush()
            raise faults.SimulatedCrash("manifest.append")
        self._manifest.write(payload)
        self._manifest.flush()
        os.fsync(self._manifest.fileno())
        # copy-on-write: apply to a clone, then swap.  Readers holding the
        # old ``current`` (the async read path snapshots it outside the DB
        # lock) see a stable level structure.
        nxt = self.current.clone()
        for rec in recs:
            self._apply_record(rec, nxt)
        self.current = nxt

    def new_file_no(self) -> int:
        no = self.next_file_no
        self.next_file_no += 1
        return no

    def close(self):
        if self._manifest:
            self._manifest.close()


# -- repair (lsm.repair) ----------------------------------------------------

def write_manifest_snapshot(db_dir: str, version: Version, *,
                            last_seq: int, next_file_no: int,
                            compact_pointer: dict[int, bytes] | None = None):
    """Atomically replace MANIFEST with a snapshot of ``version``: one
    "add" a surviving file, then the counters and pointers, written to a
    ``.tmp``, renamed and the directory fsynced, so a crash during repair
    leaves the old manifest or the new one, never a mix."""
    path = os.path.join(db_dir, "MANIFEST")
    recs = []
    for level, fm in version.all_files():
        recs.append(dict(op="add", level=level, file=fm.to_json()))
    recs.append(dict(op="meta", last_seq=last_seq, next_file_no=next_file_no))
    for level, key in (compact_pointer or {}).items():
        recs.append(dict(op="ptr", level=level, key=key.hex()))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in recs))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(db_dir)
