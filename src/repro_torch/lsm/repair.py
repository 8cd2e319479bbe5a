"""Offline repair of a crashed or corrupted store directory (the port of
``repro.lsm.repair``: host code, the same decisions and the same bytes).

``repair(path)`` makes a damaged single-store directory safe to open
again, and prefers containing data loss to completeness:

* **Quarantine** -- every SST the MANIFEST references (or, with no
  MANIFEST, every SST on disk) is read with its whole-file CRC verified;
  a file that fails or cannot be read moves to ``lost/`` (never deleted:
  a person or a better tool may still salvage rows) and its reference is
  dropped.
* **WAL truncation** -- a torn or corrupt tail of the active WAL or of a
  rotated segment is cut at the last valid record boundary, so that no
  later append can bring garbage bytes back.
* **MANIFEST rebuild** -- a torn manifest tail or dropped references
  trigger an atomic rewrite (one "add" a surviving file and the counters,
  ``version.write_manifest_snapshot``).  A *missing* or empty manifest is
  rebuilt by adopting every healthy SST at L0, in file-number order, so
  that recovery resolves keys as before.
* **GC** -- stale ``*.tmp`` files and SSTs the (rebuilt) manifest does not
  reference are deleted, as ``LsmDB``'s open does.

Entry points: ``LsmDB.open(path, repair=True)``,
``ShardedDB.open(path, repair=True)``, and the CLI::

    python -m repro_torch.lsm.repair <dir> [--dry-run]

which detects a sharded store (``SHARDS.json`` or ``shard-*``
directories) and repairs every shard.  It needs no device: the checks are
the whole-file CRCs of ``read_sst``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np

from repro_torch.lsm import faults, version, wal
from repro_torch.lsm.sstable import FileMeta, image_bounds, read_sst


@dataclasses.dataclass
class RepairReport:
    """What ``repair`` did (or, under ``dry_run``, would do)."""

    path: str
    quarantined: list[str] = dataclasses.field(default_factory=list)
    wal_truncated: list[tuple[str, int]] = \
        dataclasses.field(default_factory=list)   # (path, bytes dropped)
    orphans_removed: list[str] = dataclasses.field(default_factory=list)
    manifest_rebuilt: bool = False
    adopted: list[str] = dataclasses.field(default_factory=list)
    dry_run: bool = False

    @property
    def changed(self) -> bool:
        return bool(self.quarantined or self.wal_truncated or
                    self.orphans_removed or self.manifest_rebuilt or
                    self.adopted)

    def summary(self) -> str:
        verb = "would " if self.dry_run else ""
        lines = [f"repair {self.path}:"]
        for p in self.quarantined:
            lines.append(f"  {verb}quarantine {p} -> lost/")
        for p, dropped in self.wal_truncated:
            lines.append(f"  {verb}truncate {p} (drop {dropped} torn bytes)")
        for p in self.adopted:
            lines.append(f"  {verb}adopt {p} at L0")
        if self.manifest_rebuilt:
            lines.append(f"  {verb}rewrite MANIFEST")
        for p in self.orphans_removed:
            lines.append(f"  {verb}remove orphan {p}")
        if not self.changed:
            lines.append("  clean (nothing to do)")
        return "\n".join(lines)


def _resolve_sst(db_dir: str, fm: FileMeta) -> str:
    """An SST's on-disk location: the file's basename inside ``db_dir``
    wins over the manifest-recorded path (a copied or moved store --
    e.g. a crash image restored elsewhere -- must read its OWN files,
    never the original directory the manifest still points at)."""
    local = os.path.join(db_dir, os.path.basename(fm.path))
    if os.path.exists(local):
        return local
    return fm.path


def _quarantine(db_dir: str, path: str, *, dry_run: bool) -> None:
    if dry_run or not os.path.exists(path):
        return
    lost = os.path.join(db_dir, "lost")
    os.makedirs(lost, exist_ok=True)
    dst = os.path.join(lost, os.path.basename(path))
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(lost, f"{os.path.basename(path)}.{n}")
    os.replace(path, dst)
    faults.fsync_dir(lost)
    faults.fsync_dir(db_dir)


def _image_last_seq(img) -> int:
    nvalid = np.asarray(img.nvalid)
    meta = np.asarray(img.meta, np.uint32)
    k = meta.shape[1]
    valid = np.arange(k)[None, :] < nvalid[:, None]
    if not valid.any():
        return 0
    return int((meta[valid] >> 1).max())


def _recover_manifest(db_dir: str):
    """(version_set, torn) -- replay the manifest's valid prefix into a
    throwaway ``VersionSet``; ``torn`` flags an unparseable tail."""
    vs = version.VersionSet(db_dir)
    torn = False
    with open(vs.manifest_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                vs._apply_record(rec)
            except (json.JSONDecodeError, KeyError, TypeError,
                    IndexError, ValueError):
                torn = True
                break
    for _, fm in vs.current.all_files():
        vs.next_file_no = max(vs.next_file_no, fm.file_no + 1)
    return vs, torn


def repair(path: str, *, dry_run: bool = False) -> RepairReport:
    """Repair one ``LsmDB`` directory in place.  Idempotent; a clean
    store is left untouched (``report.changed`` is False)."""
    report = RepairReport(path=path, dry_run=dry_run)
    if not os.path.isdir(path):
        return report

    manifest_path = os.path.join(path, "MANIFEST")
    if os.path.exists(manifest_path):
        vs, torn = _recover_manifest(path)
        rebuilt = torn
        live = version.Version()
        for level, fm in vs.current.all_files():
            sst = _resolve_sst(path, fm)
            try:
                read_sst(sst)   # whole-file CRC
            except Exception:   # noqa: BLE001 - missing or corrupt
                report.quarantined.append(sst)
                _quarantine(path, sst, dry_run=dry_run)
                rebuilt = True
                continue
            if sst != fm.path:
                fm = dataclasses.replace(fm, path=sst)
                rebuilt = True
            live.levels[level].append(fm)
        if rebuilt:
            report.manifest_rebuilt = True
            if not dry_run:
                version.write_manifest_snapshot(
                    path, live, last_seq=vs.last_seq,
                    next_file_no=vs.next_file_no,
                    compact_pointer=vs.compact_pointer)
        referenced = {os.path.basename(fm.path)
                      for _, fm in live.all_files()}
    else:
        # no manifest at all: adopt every healthy SST at L0 so the data
        # survives; quarantine the sick ones
        adopted: list[FileMeta] = []
        last_seq = 0
        for sst in sorted(glob.glob(os.path.join(path, "*.sst"))):
            name = os.path.basename(sst)
            try:
                file_no = int(name[:-4])
            except ValueError:
                continue
            try:
                img = read_sst(sst)
            except Exception:   # noqa: BLE001 - corrupt or truncated
                report.quarantined.append(sst)
                _quarantine(path, sst, dry_run=dry_run)
                continue
            smallest, largest, n_entries = image_bounds(img)
            adopted.append(FileMeta(
                file_no=file_no, path=sst, smallest=smallest,
                largest=largest, n_entries=n_entries,
                size_bytes=os.path.getsize(sst)))
            last_seq = max(last_seq, _image_last_seq(img))
        if adopted:
            # L0 ordering contract: newest (highest file_no) shadows
            # older entries, exactly as a crashed-open would have seen
            adopted.sort(key=lambda fm: fm.file_no)
            live = version.Version()
            live.levels[0] = adopted
            report.adopted = [fm.path for fm in adopted]
            report.manifest_rebuilt = True
            if not dry_run:
                version.write_manifest_snapshot(
                    path, live, last_seq=last_seq,
                    next_file_no=adopted[-1].file_no + 1)
        referenced = {os.path.basename(fm.path) for fm in adopted}

    # torn WAL tails (active log + rotated segments)
    for p in sorted(glob.glob(os.path.join(path, "wal*.log"))):
        size = os.path.getsize(p)
        keep = wal.valid_prefix(p)
        if keep < size:
            report.wal_truncated.append((p, size - keep))
            if not dry_run:
                with open(p, "r+b") as f:
                    f.truncate(keep)
                    f.flush()
                    os.fsync(f.fileno())

    # orphaned temp files and unreferenced SSTs
    for name in sorted(os.listdir(path)):
        p = os.path.join(path, name)
        if not os.path.isfile(p):
            continue
        orphan = name.endswith(".tmp")
        if name.endswith(".sst") and name not in referenced:
            try:
                int(name[:-4])
                orphan = True
            except ValueError:
                pass
        if orphan:
            report.orphans_removed.append(p)
            if not dry_run:
                os.remove(p)
    if report.orphans_removed and not dry_run:
        faults.fsync_dir(path)
    return report


def repair_sharded(path: str, *, dry_run: bool = False
                   ) -> list[RepairReport]:
    """Repair every ``shard-*`` subdirectory of a ``ShardedDB`` store and
    clean up a stale boundary-table temp file."""
    reports = []
    stale = os.path.join(path, "SHARDS.json.tmp")
    if os.path.exists(stale) and not dry_run:
        os.remove(stale)
    for shard_dir in sorted(glob.glob(os.path.join(path, "shard-*"))):
        if os.path.isdir(shard_dir):
            reports.append(repair(shard_dir, dry_run=dry_run))
    return reports


def _is_sharded(path: str) -> bool:
    return (os.path.exists(os.path.join(path, "SHARDS.json")) or
            bool(glob.glob(os.path.join(path, "shard-*"))))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lsm.repair",
        description="Repair a crashed/corrupted store directory "
                    "(quarantine bad SSTs, truncate torn WALs, rebuild "
                    "the MANIFEST, GC orphans).")
    ap.add_argument("path", help="store directory (LsmDB or ShardedDB)")
    ap.add_argument("--dry-run", action="store_true",
                    help="report what would change without touching disk")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.path):
        ap.error(f"not a directory: {args.path}")
    if _is_sharded(args.path):
        reports = repair_sharded(args.path, dry_run=args.dry_run)
    else:
        reports = [repair(args.path, dry_run=args.dry_run)]
    for r in reports:
        print(r.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
