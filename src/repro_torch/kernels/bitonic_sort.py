"""Bitonic sort of tuple rows on the card (``csrc/bitonic.cu``): compaction
phase 2 with ``sort_mode="device"``.

The port's counterpart of ``repro.kernels.bitonic_sort.bitonic_sort``; the
plain version is ``ref.sort_tuples`` over all lanes (the order is total
over all lanes, so every correct sort gives the same rows).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def bitonic_sort(rows: torch.Tensor) -> torch.Tensor:
    """Sort int32 ``[n, lanes]`` CUDA rows ascending lexicographically over
    all lanes (unsigned).  The rows are copied into a buffer padded to a
    power of two with all-ones sentinel rows and sorted there by one call
    that enqueues every stage of the network (each kernel it enqueues
    counts as a launch); the first ``n`` rows come back.  ``rows`` is left
    as it was."""
    _build.check_cuda(rows, "bitonic_sort rows", torch.int32, 2)
    n, lanes = rows.shape
    if n == 0:
        return rows.clone()
    n_pad = 1 << max(1, (n - 1).bit_length())
    buf = torch.full((n_pad, lanes), -1, dtype=torch.int32,
                     device=rows.device)
    buf[:n] = rows
    launched = ctypes.c_int(0)
    _build.launch("bitonic_sort", buf.data_ptr(), n_pad, lanes,
                  ctypes.addressof(launched), _build.stream_handle(buf),
                  launched=launched)
    return buf[:n]
