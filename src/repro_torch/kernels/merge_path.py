"""Run-aware merge of sorted tuple runs on the card
(``csrc/merge_path.cu``), its level plan, and the host checks of its
precondition.

The port's counterpart of ``repro.kernels.merge_path``; the plain version
is ``ref.merge_runs``.  The merge follows the JAX package's pairwise tree
(adjacent pairs at each level, an odd run carried up, ties to the left,
earlier run), one launch per level: :func:`plan_levels` lays the levels
out on the host, and the kernel merges every pair of a level at once.
"""

from __future__ import annotations

import array
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

#: Output rows one block merges (``kTile`` in ``csrc/merge_path.cu``).
TILE_ROWS = 512
#: Pairs one launch takes (``kMaxPairs``); a level with more is split.
MAX_PAIRS = 64
#: Lanes the kernel is built for (``kMaxLanes``): 1 to 8.
MAX_LANES = 8
#: Jobs one launch takes (the grid's y dimension).
MAX_JOBS = 65535


class Pair(NamedTuple):
    """One merge of a level: the run at rows ``[off, off + len_a)`` of
    buffer ``src_a`` with the run after it, rows ``[off + len_a, off +
    len_a + len_b)`` of buffer ``src_b``, into rows ``[off, off + len_a +
    len_b)`` of buffer ``dst``.  Buffer 0 is the input, 1 and 2 are
    scratch; ``dst`` is never a source of its own pair."""
    off: int
    len_a: int
    len_b: int
    src_a: int
    src_b: int
    dst: int


class Level(NamedTuple):
    """The pairs one level merges, and the runs it carries up as they
    are: ``(off, len, buffer)``, read in place by a later level."""
    pairs: tuple[Pair, ...]
    carried: tuple[tuple[int, int, int], ...]


@functools.lru_cache(maxsize=512)
def plan_levels(run_lens: tuple[int, ...]) -> tuple[Level, ...]:
    """The pairwise tree over the non-empty runs of ``run_lens``, one
    :class:`Level` a tree level: ``ceil(log2 k')`` levels for ``k'``
    non-empty runs, none for one.  A run keeps its rows at every level, so
    the buffers only have to be chosen so that no pair writes where it
    reads: the root goes to buffer 1, each merged operand to the other
    scratch buffer than its parent's, and the input runs stay in buffer 0.
    The last level writes the result to buffer 1."""
    # a node: [off, len, buffer]; input runs live in buffer 0
    items = [[o, n, 0] for o, n in zip(
        itertools.accumulate(run_lens, initial=0), run_lens) if n > 0]
    made = []   # per level: (node, left, right) merges, and the carried run
    while len(items) > 1:
        merges = []
        for a, b in zip(items[0::2], items[1::2]):
            merges.append(([a[0], a[1] + b[1], None], a, b))
        carried = items[-1] if len(items) % 2 else None
        made.append((merges, carried))
        items = [m[0] for m in merges] + ([carried] if carried else [])
    if made:
        items[0][2] = 1
    for merges, _ in reversed(made):
        for node, a, b in merges:
            for child in (a, b):
                if child[2] is None:
                    child[2] = 3 - node[2]
    return tuple(
        Level(tuple(Pair(a[0], a[1], b[1], a[2], b[2], node[2])
                    for node, a, b in merges),
              (tuple(carried),) if carried else ())
        for merges, carried in made)


@functools.lru_cache(maxsize=512)
def launch_tables(run_lens: tuple[int, ...]
                  ) -> tuple[tuple[tuple[int, array.array], ...], bool]:
    """The pair tables of :func:`plan_levels` as ``(pairs, int64 [pairs *
    6])``, at most ``MAX_PAIRS`` pairs a table (one table a launch), and
    whether any pair writes buffer 2."""
    tables = []
    for level in plan_levels(run_lens):
        for i in range(0, len(level.pairs), MAX_PAIRS):
            chunk = level.pairs[i:i + MAX_PAIRS]
            tables.append((len(chunk), array.array(
                "q", [x for pair in chunk for x in pair])))
    return tuple(tables), any(p.dst == 2 for level in plan_levels(run_lens)
                              for p in level.pairs)


def rows_sorted(rows: np.ndarray) -> bool:
    """Host check: rows ``[n, L]`` (uint32 words, any integer dtype of
    that width) lexicographically nondecreasing, unsigned."""
    r = np.ascontiguousarray(
        np.asarray(rows).astype(np.uint32).astype(">u4"))
    if r.shape[0] <= 1:
        return True
    packed = r.view(f"S{4 * r.shape[1]}").ravel()
    return bool((packed[:-1] <= packed[1:]).all())


def assert_runs_sorted(rows: np.ndarray, run_lens) -> None:
    """Raise unless every run of ``rows`` is sorted (the merge's
    precondition).  Raises explicitly so it survives ``python -O``."""
    rows = np.asarray(rows)
    off = 0
    for i, ln in enumerate(run_lens):
        if not rows_sorted(rows[off:off + ln]):
            raise AssertionError(
                f"run {i} (rows {off}:{off + ln}) is not sorted; the merge "
                "phase requires sorted input runs")
        off += ln


def merge_runs(rows: torch.Tensor, run_lens) -> torch.Tensor:
    """Merge the sorted runs stored back to back in ``rows`` (int32
    ``[n, lanes]`` on the card, ``lanes`` 1 to ``MAX_LANES``) by the
    pairwise tree, one launch a level (``ceil(log2 k')`` for ``k'``
    non-empty runs; a level of more than ``MAX_PAIRS`` pairs takes one
    launch for each ``MAX_PAIRS``).  Empty runs are skipped; one run
    passes through with no launch.

    ``rows`` of ``[J, n, lanes]`` is a batch of J jobs with the same
    ``run_lens``, each merged on its own: the launches are the one job's
    (the kernel's grid gains the job as its y dimension), not J times
    them."""
    if rows.dim() not in (2, 3):
        raise ValueError(f"merge_runs: rows of shape {tuple(rows.shape)}")
    _build.check_cuda(rows, "merge_runs rows", torch.int32, rows.dim())
    jobs = rows.shape[0] if rows.dim() == 3 else 1
    n, lanes = rows.shape[-2:]
    run_lens = tuple(int(r) for r in run_lens)
    if sum(run_lens) != n:
        raise ValueError(f"run_lens {run_lens} must cover {n} rows")
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"merge_runs: {lanes} lanes; the kernel takes 1 "
                         f"to {MAX_LANES}")
    if jobs > MAX_JOBS:
        raise ValueError(f"merge_runs: {jobs} jobs; a launch takes at most "
                         f"{MAX_JOBS}")
    tables, uses_spare = launch_tables(run_lens)
    if not tables or jobs == 0:
        return rows
    if rows.data_ptr() % 8:
        rows = rows.clone()   # the kernel moves rows as 8-byte words
    out = torch.empty_like(rows)
    spare = torch.empty_like(rows) if uses_spare else None
    ptrs = (rows.data_ptr(), out.data_ptr(),
            0 if spare is None else spare.data_ptr())
    stream = _build.stream_handle(rows)
    for n_pairs, table in tables:
        _build.launch("merge_runs", *ptrs, lanes, n_pairs,
                      table.buffer_info()[0], TILE_ROWS, jobs, n, stream)
    return out
