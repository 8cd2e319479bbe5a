"""Run-aware merge of sorted tuple runs on the card
(``csrc/merge_path.cu``), plus the host checks of its precondition.

The port's counterpart of ``repro.kernels.merge_path``; the plain version
is ``ref.merge_runs``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref


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


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two sorted contiguous int32 row runs in one launch."""
    _build.check_cuda(a, "merge a", torch.int32, 2)
    _build.check_cuda(b, "merge b", torch.int32, 2)
    if a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError("merge: runs differ in lanes or device")
    out = torch.empty((a.shape[0] + b.shape[0], a.shape[1]),
                      dtype=torch.int32, device=a.device)
    _build.launch("merge_pair", a.data_ptr(), a.shape[0], b.data_ptr(),
                  b.shape[0], out.data_ptr(), a.shape[1],
                  _build.stream_handle(out))
    return out


def merge_runs(rows: torch.Tensor, run_lens) -> torch.Tensor:
    """Merge the sorted runs stored back to back in ``rows`` (int32
    ``[n, lanes]`` on the card) by the pairwise tree: one launch per pair,
    ``ceil(log2 k)`` levels; empty runs are skipped, one run passes
    through."""
    _build.check_cuda(rows, "merge_runs rows", torch.int32, 2)
    runs = ref.split_runs(rows, run_lens)
    if not runs:
        return rows
    return ref.tree_merge(runs, merge_sorted)
