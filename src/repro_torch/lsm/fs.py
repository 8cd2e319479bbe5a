"""Filesystem durability helper shared by the WAL, manifest and SST
writers."""

from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename or create inside it survives a crash.

    POSIX only makes renamed or created *names* durable once the parent
    directory's entry is flushed.  Some filesystems reject ``fsync`` on a
    directory (EINVAL); that is ignored, as LevelDB's env does."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
