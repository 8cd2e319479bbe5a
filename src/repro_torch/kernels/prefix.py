"""Shared-prefix lengths of sorted keys on the card (``csrc/prefix.cu``).

The port's counterpart of ``repro.kernels.prefix``; the plain versions are
``ref.prefix_encode``, ``ref.prefix_encode_wire`` and, for a batch of
jobs, ``ref.prefix_encode_wire_batched``.  Both routes are one
launch of one C entry point, counted as ``prefix_encode``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check(keys: torch.Tensor, restart_interval: int) -> None:
    _build.check_cuda(keys, "prefix_encode keys", torch.int32, keys.dim())
    if keys.dim() not in (2, 3):
        raise ValueError(f"prefix_encode: keys of shape {tuple(keys.shape)}")
    if keys.shape[-2] % restart_interval:
        raise ValueError("prefix_encode: rows must fill restart intervals")


def prefix_encode(keys: torch.Tensor, *,
                  restart_interval: int = 16) -> torch.Tensor:
    """``keys``: contiguous int32 ``[n, lanes]`` CUDA tensor of sorted
    big-endian key lanes.  Returns int32 ``[n]``."""
    _check(keys, restart_interval)
    if keys.dim() != 2:
        raise ValueError("prefix_encode: keys must be [n, lanes]")
    n, lanes = keys.shape
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    _build.launch("prefix_encode", keys.data_ptr(), n, lanes,
                  restart_interval, None, n, out.data_ptr(), None,
                  _build.stream_handle(out))
    return out


def prefix_encode_wire(keys: torch.Tensor, count: torch.Tensor, *,
                       restart_interval: int = 16
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack's prefix step in one launch: ``keys`` as for
    :func:`prefix_encode`, ``count`` the survivors (an int64 scalar on the
    same card, read there: no host sync).  Returns ``(shared, wire)``:
    int32 ``[n]`` shared lengths, 0 from row ``count`` on, and the keys
    with their first ``shared`` bytes zeroed.

    A batch: ``keys`` ``[J, n, lanes]`` and ``count`` int64 ``[J]``, one
    job's survivors each, give ``[J, n]`` and ``[J, n, lanes]`` in the
    same one launch, each job encoded on its own (``n`` a whole number of
    restart intervals, so a job starts at a restart point)."""
    _check(keys, restart_interval)
    batch = keys.dim() == 3
    _build.check_cuda(count, "prefix_encode count", torch.int64,
                      1 if batch else 0)
    if count.device != keys.device:
        raise ValueError("prefix_encode: count must be on the keys' device")
    if batch and count.shape[0] != keys.shape[0]:
        raise ValueError(f"prefix_encode: {count.shape[0]} counts for "
                         f"{keys.shape[0]} jobs")
    job_rows, lanes = keys.shape[-2:]
    n = keys.numel() // lanes
    shared = torch.empty(keys.shape[:-1], dtype=torch.int32,
                         device=keys.device)
    wire = torch.empty_like(keys)
    _build.launch("prefix_encode", keys.data_ptr(), n, lanes,
                  restart_interval, count.data_ptr(), job_rows,
                  shared.data_ptr(), wire.data_ptr(),
                  _build.stream_handle(shared))
    return shared, wire
