"""Sort of tuple rows on the card (``csrc/bitonic.cu``): compaction phase 2
with ``sort_mode="device"``.

The port's counterpart of ``repro.kernels.bitonic_sort.bitonic_sort``; the
plain version is ``ref.sort_tuples`` over all lanes (the order is total
over all lanes, so every correct sort gives the same rows).  One launch
sorts every tile of :func:`tile_rows` rows, then the merge tree of
``merge_path.plan_levels`` over the sorted tiles takes one launch a level
(:func:`launches` counts them).
"""

from __future__ import annotations

import array
import ctypes
import functools

import torch

from repro_torch.kernels import _build, merge_path

#: Rows one block sorts for rows of up to ``MAX_LANES`` words
#: (``kRowsPerThread`` x the tile kernel's threads in ``csrc/bitonic.cu``).
TILE_ROWS = 2048
#: Lanes the register tile sort and its merge levels are built for.
MAX_LANES = merge_path.MAX_LANES
#: Shared memory of a wider tile (``kWideSmemBytes``), and its most rows.
WIDE_SMEM_BYTES = 96 * 1024
WIDE_MAX_TILE = 2048


def tile_rows(lanes: int) -> int:
    """Rows a block sorts: ``TILE_ROWS`` up to ``MAX_LANES`` lanes; for
    wider rows (sorted in shared memory, ``lanes`` at run time) the
    largest power of two up to ``WIDE_MAX_TILE`` whose rows fit
    ``WIDE_SMEM_BYTES``."""
    if lanes < 1:
        raise ValueError(f"bitonic_sort: {lanes} lanes")
    if lanes <= MAX_LANES:
        return TILE_ROWS
    tile = WIDE_MAX_TILE
    while tile > 2 and tile * lanes * 4 > WIDE_SMEM_BYTES:
        tile //= 2
    if tile * lanes * 4 > WIDE_SMEM_BYTES:
        raise ValueError(f"bitonic_sort: rows of {lanes} lanes do not fit "
                         f"a tile of two rows in {WIDE_SMEM_BYTES} bytes")
    return tile


def tile_lens(n: int, tile: int) -> tuple[int, ...]:
    """The sorted runs the tile launch leaves: ``tile`` rows each, the
    last one short."""
    return (tile,) * (n // tile) + ((n % tile,) if n % tile else ())


@functools.lru_cache(maxsize=256)
def plan(n: int, lanes: int
         ) -> tuple[int, array.array, array.array, int]:
    """``(tile, pairs a level launch (int32), the launches' pair tables
    (int64 [*, 6]), scratch buffers)`` for ``n >= 1`` rows: buffer 0
    takes the sorted tiles, 1 the result when a level merges, 2 a spare
    where the plan names one."""
    tile = tile_rows(lanes)
    tables, uses_spare = merge_path.launch_tables(tile_lens(n, tile))
    counts = array.array("i", [p for p, _ in tables])
    pairs = array.array("q")
    for _, table in tables:
        pairs.extend(table)
    return tile, counts, pairs, 1 + bool(tables) + uses_spare


def launches(n: int, lanes: int) -> int:
    """Kernels one call enqueues: the tile sort and one a merge level
    table (none for no rows)."""
    return 0 if n == 0 else 1 + len(plan(n, lanes)[1])


def bitonic_sort(rows: torch.Tensor) -> torch.Tensor:
    """Sort int32 ``[n, lanes]`` CUDA rows ascending lexicographically over
    all lanes (unsigned), any ``n`` and ``lanes``; ``rows`` is left as it
    was.  One call enqueues :func:`launches` kernels, each counted.

    ``rows`` of ``[J, n, lanes]`` is a batch of J jobs, each sorted on its
    own, in the same :func:`launches` (``launches(n, lanes)``): both
    kernels take the job as their grid's y dimension, and no tile
    straddles two jobs (a job's last tile is short when the tile does not
    divide ``n``)."""
    if rows.dim() not in (2, 3):
        raise ValueError(f"bitonic_sort: rows of shape {tuple(rows.shape)}")
    _build.check_cuda(rows, "bitonic_sort rows", torch.int32, rows.dim())
    jobs = rows.shape[0] if rows.dim() == 3 else 1
    n, lanes = rows.shape[-2:]
    if n == 0 or jobs == 0:
        return rows.clone()
    if jobs > merge_path.MAX_JOBS:
        raise ValueError(f"bitonic_sort: {jobs} jobs; a launch takes at "
                         f"most {merge_path.MAX_JOBS}")
    tile, counts, pairs, n_bufs = plan(n, lanes)
    bufs = [torch.empty_like(rows) for _ in range(n_bufs)]
    ptrs = [b.data_ptr() for b in bufs] + [0] * (3 - n_bufs)
    launched = ctypes.c_int(0)
    _build.launch("bitonic_sort", rows.data_ptr(), *ptrs, n, lanes, tile,
                  jobs, len(counts), counts.buffer_info()[0],
                  pairs.buffer_info()[0], ctypes.addressof(launched),
                  _build.stream_handle(rows), launched=launched)
    return bufs[1] if len(counts) else bufs[0]
